"""EXPLAIN PLAN: the logical operator tree of a compiled query.

Counterpart of ``pinot_tpu/query/explain.py`` (``explain_rows``,
``EXPLAIN_COLUMNS``): rows of (Operator, Operator_Id, Parent_Id), the
reference's response shape, built from the QueryContext alone; the rows
equal the JAX package's for the same SQL. The operator texts are the JAX
package's too (its combine is a psum over a device mesh); the port's
physical choice (fused scan, general rung, host engine, star-tree) is
made per segment at run time.
"""

from __future__ import annotations

from typing import List, Optional

from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import FilterNode, FilterOp


def explain_rows(ctx: QueryContext) -> List[List]:
    """[[operator, operator_id, parent_id], ...]."""
    rows: List[List] = []
    next_id = [0]

    def emit(text: str, parent: int) -> int:
        oid = next_id[0]
        next_id[0] += 1
        rows.append([text, oid, parent])
        return oid

    sel = ", ".join(str(e) for e in ctx.select_expressions)
    root = emit(
        f"BROKER_REDUCE(limit:{ctx.limit}"
        + (f",offset:{ctx.offset}" if ctx.offset else "")
        + (",sort:" + ", ".join(
            f"{ob.expr} {'ASC' if ob.ascending else 'DESC'}"
            for ob in ctx.order_by) if ctx.order_by else "")
        + (",having:true" if ctx.having is not None else "")
        + ")", -1)

    if ctx.is_group_by:
        combine = emit("COMBINE_GROUP_BY(sharded psum over device mesh)",
                       root)
        agg = emit(
            "GROUP_BY(groupKeys:"
            + ", ".join(str(e) for e in ctx.group_by)
            + ", aggregations:"
            + ", ".join(str(f) for f in ctx.aggregations) + ")", combine)
    elif ctx.is_aggregation:
        combine = emit("COMBINE_AGGREGATE(sharded psum over device mesh)",
                       root)
        agg = emit("AGGREGATE(aggregations:"
                   + ", ".join(str(f) for f in ctx.aggregations) + ")",
                   combine)
    elif ctx.distinct:
        combine = emit("COMBINE_DISTINCT", root)
        agg = emit(f"DISTINCT(keyColumns:{sel})", combine)
    else:
        combine = emit("COMBINE_SELECT", root)
        agg = emit(f"SELECT(selectList:{sel})", combine)

    project_cols = sorted(set(ctx.referenced_columns()))
    proj = emit("PROJECT(" + ", ".join(project_cols) + ")", agg)
    doc = emit("DOC_ID_SET", proj)
    _emit_filter(ctx.filter, doc, emit)
    return rows


def _emit_filter(node: Optional[FilterNode], parent: int, emit) -> None:
    if node is None:
        emit("FILTER_MATCH_ENTIRE_SEGMENT", parent)
        return
    if node.op is FilterOp.AND:
        fid = emit("FILTER_AND", parent)
        for c in node.children:
            _emit_filter(c, fid, emit)
        return
    if node.op is FilterOp.OR:
        fid = emit("FILTER_OR", parent)
        for c in node.children:
            _emit_filter(c, fid, emit)
        return
    if node.op is FilterOp.NOT:
        fid = emit("FILTER_NOT", parent)
        _emit_filter(node.children[0], fid, emit)
        return
    p = node.predicate
    emit(f"FILTER_{p.type.name}(predicate:{p})", parent)


EXPLAIN_COLUMNS = (["Operator", "Operator_Id", "Parent_Id"],
                   ["STRING", "INT", "INT"])
