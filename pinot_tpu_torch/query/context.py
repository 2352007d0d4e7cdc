"""QueryContext: the compiled server-side query.

Counterpart of ``pinot_tpu/query/context.py`` (``compile_query``): parse,
optimise the WHERE and HAVING filters, resolve aliases and ordinals (HAVING
takes aliases only), and collect the aggregation functions the plan maker
and the reduce need, HAVING's among them. A query without aggregations is
a selection, or DISTINCT (``SELECT DISTINCT``, or a GROUP BY without
aggregations, which becomes DISTINCT over the group expressions as in the
JAX package).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from pinot_tpu_torch.query.expressions import (
    Expr,
    FilterNode,
    Function,
    Identifier,
    Literal,
    OrderByExpr,
    fold_constants,
)
from pinot_tpu_torch.query.optimizer import optimize_filter
from pinot_tpu_torch.query.parser import SqlParseError, parse_sql

# the aggregation function names (the JAX package's
# AggregationFunctionType); percentileNN names carry their percentile
AGGREGATION_FUNCTIONS = frozenset({
    "count", "sum", "min", "max", "avg", "minmaxrange", "sumprecision",
    "mode", "distinctcount", "distinctcountbitmap", "distinctcounthll",
    "distinctcountrawhll", "segmentpartitioneddistinctcount", "percentile",
    "percentileest", "percentiletdigest", "distinctcountthetasketch",
    "distinctcountrawthetasketch", "idset", "lastwithtime", "firstwithtime",
    "stunion", "st_union", "countmv", "summv", "minmv", "maxmv", "avgmv",
    "minmaxrangemv", "distinctcountmv", "distinctcounthllmv", "percentilemv",
    "percentileestmv", "percentiletdigestmv"})


def is_aggregation(name: str) -> bool:
    n = name.lower()
    if n in AGGREGATION_FUNCTIONS:
        return True
    return any(n.startswith(p) and n[len(p):].isdigit()
               for p in ("percentiletdigest", "percentileest", "percentile"))


@dataclass
class QueryContext:
    table_name: str
    select_expressions: List[Expr]
    aliases: List[Optional[str]]
    filter: Optional[FilterNode]
    group_by: List[Expr]
    order_by: List[OrderByExpr]
    limit: int
    offset: int = 0
    distinct: bool = False
    having: Optional[FilterNode] = None
    options: Dict[str, str] = field(default_factory=dict)
    aggregations: List[Function] = field(default_factory=list)
    sql: Optional[str] = None
    explain: bool = False   # EXPLAIN PLAN FOR

    @property
    def is_group_by(self) -> bool:
        return bool(self.group_by)

    @property
    def is_aggregation(self) -> bool:
        return bool(self.aggregations)

    @property
    def is_selection(self) -> bool:
        return not self.aggregations and not self.distinct

    def referenced_columns(self) -> List[str]:
        cols: List[str] = []
        for e in self.select_expressions:
            cols.extend(e.columns())
        if self.filter is not None:
            cols.extend(self.filter.columns())
        for e in self.group_by:
            cols.extend(e.columns())
        if self.having is not None:
            cols.extend(self.having.columns())
        for ob in self.order_by:
            cols.extend(ob.expr.columns())
        return [c for c in dict.fromkeys(cols) if c != "*"]


def _collect_aggregations(expr: Expr, out: List[Function]) -> None:
    if isinstance(expr, Function):
        if is_aggregation(expr.name):
            if expr not in out:
                out.append(expr)
            return
        for a in expr.args:
            _collect_aggregations(a, out)


def _resolve_alias(expr: Expr, alias_map: Dict[str, Expr],
                   select_exprs: List[Expr], top_level: bool = True) -> Expr:
    """Aliases anywhere; 1-based ordinals only as a whole top-level GROUP BY
    or ORDER BY item."""
    if isinstance(expr, Identifier) and expr.name in alias_map:
        return alias_map[expr.name]
    if top_level and isinstance(expr, Literal) and type(expr.value) is int:
        if 1 <= expr.value <= len(select_exprs):
            return select_exprs[expr.value - 1]
        raise SqlParseError(f"ordinal {expr.value} out of range")
    if isinstance(expr, Function):
        return Function(expr.name,
                        tuple(_resolve_alias(a, alias_map, select_exprs, False)
                              for a in expr.args))
    return expr


def _resolve_filter_aliases(node: FilterNode, alias_map: Dict[str, Expr],
                            select_exprs: List[Expr]) -> FilterNode:
    """HAVING: aliases only, ordinals mean nothing there."""
    if node.predicate is not None:
        p = node.predicate
        lhs = _resolve_alias(p.lhs, alias_map, select_exprs, top_level=False)
        return node if lhs is p.lhs else FilterNode.pred(replace(p, lhs=lhs))
    return FilterNode(node.op, children=tuple(
        _resolve_filter_aliases(c, alias_map, select_exprs)
        for c in node.children))


def compile_query(sql: str) -> QueryContext:
    """SQL -> optimised QueryContext."""
    parsed = parse_sql(sql)
    select_exprs = [fold_constants(e) for e, _ in parsed.select]
    aliases = [a for _, a in parsed.select]
    alias_map = {a: e for e, a in zip(select_exprs, aliases) if a is not None}
    group_by = [fold_constants(_resolve_alias(e, alias_map, select_exprs))
                for e in parsed.group_by]
    order_by = [OrderByExpr(fold_constants(
        _resolve_alias(ob.expr, alias_map, select_exprs)), ob.ascending)
        for ob in parsed.order_by]
    having = optimize_filter(parsed.having)
    if having is not None:
        having = _resolve_filter_aliases(having, alias_map, select_exprs)
    ctx = QueryContext(
        table_name=parsed.table, select_expressions=select_exprs,
        aliases=aliases, filter=optimize_filter(parsed.where),
        group_by=group_by, order_by=order_by, limit=parsed.limit,
        offset=parsed.offset, distinct=parsed.distinct, having=having,
        options=dict(parsed.options), sql=sql, explain=parsed.explain)
    for e in select_exprs:
        _collect_aggregations(e, ctx.aggregations)
    if having is not None:
        for p in having.predicates():
            _collect_aggregations(p.lhs, ctx.aggregations)
    for ob in order_by:
        _collect_aggregations(ob.expr, ctx.aggregations)
    if ctx.distinct and ctx.aggregations:
        raise SqlParseError("DISTINCT with aggregations is not supported")
    if not ctx.aggregations and not group_by:
        return ctx
    group_keys = {str(e) for e in group_by}
    for e in select_exprs:
        if not _has_aggregation(e) and str(e) not in group_keys:
            raise SqlParseError(f"non-aggregate select expression {e} must "
                                "appear in GROUP BY")
    if not ctx.aggregations:
        ctx.distinct = True
        ctx.group_by = []
    return ctx


def filter_fingerprint(ctx: QueryContext) -> str:
    """Digest of the filter tree, memoized on the context (JAX
    ``pinot_tpu/engine/executor.py:56``): a cache key must tell apart two contexts of one
    SQL whose filters differ (a broker rewrites ``ctx.filter`` under the
    same SQL: the hybrid time split, an IN_SUBQUERY id set)."""
    fp = getattr(ctx, "_filter_fp", None)
    if fp is None:
        fp = hashlib.blake2b(str(ctx.filter).encode("utf-8"),
                             digest_size=16).hexdigest()
        ctx._filter_fp = fp
    return fp


def _has_aggregation(e: Expr) -> bool:
    found: List[Function] = []
    _collect_aggregations(e, found)
    return bool(found)
