"""Query-context wire serde: the InstanceRequest payload.

Counterpart of ``pinot_tpu/query/serde.py`` (a copy): expressions, filter
trees and the whole ``QueryContext`` as JSON dicts, JAX's dict for the
same SQL, so a broker ships the compiled query (with filters the SQL never
held, such as a hybrid table's time boundary) to a remote server of
either package. The context's ``sql`` and ``explain`` do not travel, as in
JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    Expr,
    FilterNode,
    FilterOp,
    Function,
    Identifier,
    Literal,
    OrderByExpr,
    Predicate,
    PredicateType,
)


# -- expressions -----------------------------------------------------------

def expr_to_dict(e: Expr) -> Dict[str, Any]:
    if isinstance(e, Identifier):
        return {"t": "id", "name": e.name}
    if isinstance(e, Literal):
        return {"t": "lit", "value": e.value}
    if isinstance(e, Function):
        return {"t": "fn", "name": e.name,
                "args": [expr_to_dict(a) for a in e.args]}
    # CaseFilterExpr etc. are parser-internal and never reach the wire
    raise TypeError(f"cannot serialize expression {e!r}")


def expr_from_dict(d: Dict[str, Any]) -> Expr:
    t = d["t"]
    if t == "id":
        return Identifier(d["name"])
    if t == "lit":
        return Literal(d["value"])
    if t == "fn":
        return Function(d["name"], [expr_from_dict(a) for a in d["args"]])
    raise ValueError(f"unknown expression tag {t!r}")


# -- predicates / filters ---------------------------------------------------

def predicate_to_dict(p: Predicate) -> Dict[str, Any]:
    return {
        "type": p.type.value,
        "lhs": expr_to_dict(p.lhs),
        "values": list(p.values),
        "lower": p.lower,
        "upper": p.upper,
        "lowerInclusive": p.lower_inclusive,
        "upperInclusive": p.upper_inclusive,
    }


def predicate_from_dict(d: Dict[str, Any]) -> Predicate:
    return Predicate(
        type=PredicateType(d["type"]),
        lhs=expr_from_dict(d["lhs"]),
        values=tuple(d.get("values", [])),
        lower=d.get("lower"),
        upper=d.get("upper"),
        lower_inclusive=d.get("lowerInclusive", False),
        upper_inclusive=d.get("upperInclusive", False),
    )


def filter_to_dict(node: Optional[FilterNode]) -> Optional[Dict[str, Any]]:
    if node is None:
        return None
    d: Dict[str, Any] = {"op": node.op.value}
    if node.predicate is not None:
        d["predicate"] = predicate_to_dict(node.predicate)
    if node.children:
        d["children"] = [filter_to_dict(c) for c in node.children]
    return d


def filter_from_dict(d: Optional[Dict[str, Any]]) -> Optional[FilterNode]:
    if d is None:
        return None
    return FilterNode(
        FilterOp(d["op"]),
        children=tuple(filter_from_dict(c) for c in d.get("children", [])),
        predicate=(predicate_from_dict(d["predicate"])
                   if d.get("predicate") else None),
    )


# -- query context ----------------------------------------------------------

def context_to_dict(ctx: QueryContext) -> Dict[str, Any]:
    return {
        "tableName": ctx.table_name,
        "select": [expr_to_dict(e) for e in ctx.select_expressions],
        "aliases": list(ctx.aliases),
        "distinct": ctx.distinct,
        "filter": filter_to_dict(ctx.filter),
        "groupBy": [expr_to_dict(e) for e in ctx.group_by],
        "having": filter_to_dict(ctx.having),
        "orderBy": [{"expr": expr_to_dict(ob.expr), "asc": ob.ascending}
                    for ob in ctx.order_by],
        "limit": ctx.limit,
        "offset": ctx.offset,
        "options": dict(ctx.options),
        "aggregations": [expr_to_dict(f) for f in ctx.aggregations],
    }


def context_from_dict(d: Dict[str, Any]) -> QueryContext:
    return QueryContext(
        table_name=d["tableName"],
        select_expressions=[expr_from_dict(e) for e in d["select"]],
        aliases=list(d["aliases"]),
        distinct=d["distinct"],
        filter=filter_from_dict(d.get("filter")),
        group_by=[expr_from_dict(e) for e in d.get("groupBy", [])],
        having=filter_from_dict(d.get("having")),
        order_by=[OrderByExpr(expr_from_dict(ob["expr"]), ob["asc"])
                  for ob in d.get("orderBy", [])],
        limit=d["limit"],
        offset=d["offset"],
        options=d.get("options", {}),
        aggregations=[expr_from_dict(f) for f in d.get("aggregations", [])],
    )
