"""Host (numpy) execution: selection, DISTINCT, and the aggregations the
device rungs do not serve.

Counterpart of ``pinot_tpu/engine/host_engine.py``. The executor reaches
it only where the JAX executor reaches its own, with the same decision
recorded: DISTINCT (``distinct_host_only``), selection (unordered, or
ordered where the device top-k declines), and an aggregation or group-by
segment whose plan the device planner refuses (``plan:device_kernel->
host_engine:<code>``). It is not a fallback for a failing device path.

Where the JAX engine loops over rows in Python, the port computes the same
answer with vectorised numpy: group keys of a dictionary column factorise
its dictIds (the dictionary is sorted, so the order of the keys is the
order of the values), DISTINCT finds each segment's first row of every
distinct tuple before it reads values, and MV aggregations read the dense
MV rows (``aggregates.MVValues``). Rows, their order and states are the
JAX engine's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.tracing import maybe_span
from pinot_tpu_torch.engine.aggregates import AggDef, agg_value_expr
from pinot_tpu_torch.engine.errors import QueryError, UnsupportedQueryError
from pinot_tpu_torch.engine.groupkeys import compose_group_keys, unique_inverse
from pinot_tpu_torch.engine.host_eval import (
    VIRTUAL_COLUMNS,
    _virtual_column_values,
    eval_expr_values,
    eval_filter,
    mv_values,
    read_values,
)
from pinot_tpu_torch.engine.results import (
    AggResult,
    DataSchema,
    GroupByResult,
    QueryStats,
    ResultTable,
    _eval_scalar_filter,
    _Reversible,
)
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import Expr, Function, Identifier, Literal
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.spi.data import Schema


# -- column helpers -------------------------------------------------------------

def _expand_select(ctx: QueryContext, schema: Schema) -> List[Expr]:
    out: List[Expr] = []
    for e in ctx.select_expressions:
        if isinstance(e, Identifier) and e.name == "*":
            out.extend(Identifier(c) for c in schema.column_names)
        else:
            out.append(e)
    return out


def _select_names(ctx: QueryContext, select: List[Expr]) -> List[str]:
    # once '*' is expanded the aliases no longer line up
    if len(select) == len(ctx.select_expressions):
        return [a if a else str(e) for e, a in zip(select, ctx.aliases)]
    return [str(e) for e in select]


def _column_type(segment: ImmutableSegment, e: Expr) -> str:
    if isinstance(e, Identifier) and e.name.startswith("$"):
        return VIRTUAL_COLUMNS.get(e.name, "STRING")
    if isinstance(e, Identifier) and e.name in segment.metadata.columns:
        cm = segment.metadata.column(e.name)
        label = cm.data_type.label
        return label if cm.single_value else label + "_ARRAY"
    if isinstance(e, Literal):
        return "STRING" if isinstance(e.value, str) else "DOUBLE"
    return "DOUBLE"


def _select_values(segment: ImmutableSegment, e: Expr,
                   doc_ids: np.ndarray) -> List[Any]:
    if isinstance(e, Identifier):
        return read_values(segment, e.name, doc_ids)
    vals = eval_expr_values(segment, e, doc_ids)
    return [v.item() if hasattr(v, "item") else v for v in vals]


def _track(stats: Optional[QueryStats], seg: ImmutableSegment,
           mask: np.ndarray) -> None:
    if stats is None:
        return
    matched = int(np.count_nonzero(mask))
    stats.num_segments_processed += 1
    stats.num_segments_matched += 1 if matched else 0
    stats.num_docs_scanned += matched
    stats.total_docs += seg.num_docs


def _stable_order(gid: np.ndarray, n_groups: int) -> np.ndarray:
    """``np.argsort(gid, kind="stable")``; a radix sort where the ids fit
    16 bits."""
    if n_groups <= 1 << 16:
        gid = gid.astype(np.uint16)
    return np.argsort(gid, kind="stable")


# -- selection -------------------------------------------------------------------

def execute_selection(ctx: QueryContext, segments: List[ImmutableSegment],
                      stats: Optional[QueryStats] = None) -> ResultTable:
    """Unordered: the first ``offset + limit`` matching docs in segment
    and doc order, stopping once they are found. Ordered: every matching
    doc's order keys, one stable lexsort, then the chosen rows."""
    if not segments:
        raise QueryError("no segments to query")
    schema = segments[0].metadata.schema
    select = _expand_select(ctx, schema)
    names = _select_names(ctx, select)
    types = [_column_type(segments[0], e) for e in select]
    need = ctx.offset + ctx.limit

    if not ctx.order_by:
        rows: List[List[Any]] = []
        for seg in segments:
            if len(rows) >= need:
                break
            mask = eval_filter(seg, ctx.filter)
            _track(stats, seg, mask)
            doc_ids = np.nonzero(mask)[0][: need - len(rows)]
            if doc_ids.size == 0:
                continue
            cols = [_select_values(seg, e, doc_ids) for e in select]
            rows.extend([list(r) for r in zip(*cols)])
        return ResultTable(DataSchema(names, types),
                           rows[ctx.offset: ctx.offset + ctx.limit])

    candidates: List[Tuple[int, np.ndarray, List[np.ndarray]]] = []
    for si, seg in enumerate(segments):
        mask = eval_filter(seg, ctx.filter)
        _track(stats, seg, mask)
        doc_ids = np.nonzero(mask)[0]
        if doc_ids.size == 0:
            continue
        keys = [_order_key_array(seg, ob.expr, doc_ids)
                for ob in ctx.order_by]
        candidates.append((si, doc_ids, keys))
    if not candidates:
        return ResultTable(DataSchema(names, types), [])

    seg_idx = np.concatenate([np.full(len(d), si)
                              for si, d, _ in candidates])
    docs = np.concatenate([d for _, d, _ in candidates])
    key_cols = [np.concatenate([k[ki] for _, _, k in candidates])
                for ki in range(len(ctx.order_by))]
    order = _lexsort(key_cols, [ob.ascending for ob in ctx.order_by])
    order = order[ctx.offset: ctx.offset + ctx.limit]
    return ResultTable(DataSchema(names, types),
                       _gather_rows(segments, select, seg_idx[order],
                                    docs[order]))


def _gather_rows(segments: List[ImmutableSegment], select: List[Expr],
                 seg_of: np.ndarray, doc_of: np.ndarray) -> List[List[Any]]:
    """Row ``i`` is segment ``seg_of[i]``'s doc ``doc_of[i]``; each
    segment's values are read once."""
    rows: List[Optional[List[Any]]] = [None] * len(doc_of)
    for si in np.unique(seg_of):
        pos = np.nonzero(seg_of == si)[0]
        cols = [_select_values(segments[int(si)], e, doc_of[pos])
                for e in select]
        for j, p in enumerate(pos):
            rows[int(p)] = [c[j] for c in cols]
    return rows


def _order_key_array(segment: ImmutableSegment, e: Expr,
                     doc_ids: np.ndarray) -> np.ndarray:
    return np.asarray(eval_expr_values(segment, e, doc_ids))


def _lexsort(key_cols: List[np.ndarray], ascending: List[bool]) -> np.ndarray:
    """Stable multi-key sort with a direction per key (strings rank-encode
    so DESC can negate)."""
    processed = []
    for arr, asc in zip(key_cols, ascending):
        if arr.dtype == object or arr.dtype.kind in ("U", "S"):
            _, arr = np.unique(arr, return_inverse=True)
        processed.append(arr if asc else _negate(arr))
    # np.lexsort sorts by its last key first
    return np.lexsort(list(reversed(processed)))


def _negate(arr: np.ndarray) -> np.ndarray:
    if np.issubdtype(arr.dtype, np.integer):
        return -arr.astype(np.int64)
    return -arr.astype(np.float64)


# -- distinct ---------------------------------------------------------------------

def execute_distinct(ctx: QueryContext, segments: List[ImmutableSegment],
                     stats: Optional[QueryStats] = None) -> ResultTable:
    """Distinct rows in the order they are first seen (segment, then doc
    order), then HAVING, ORDER BY, OFFSET and LIMIT; a ``HostDistinct``
    span on a traced query (JAX :184)."""
    with maybe_span(stats, "HostDistinct", segments=len(segments)):
        return _execute_distinct(ctx, segments, stats)


def _execute_distinct(ctx: QueryContext, segments: List[ImmutableSegment],
                      stats: Optional[QueryStats] = None) -> ResultTable:
    schema = segments[0].metadata.schema
    select = _expand_select(ctx, schema)
    names = _select_names(ctx, select)
    types = [_column_type(segments[0], e) for e in select]
    seen: Dict[Tuple, List[Any]] = {}
    for seg in segments:
        mask = eval_filter(seg, ctx.filter)
        _track(stats, seg, mask)
        doc_ids = np.nonzero(mask)[0]
        if doc_ids.size == 0:
            continue
        doc_ids = _first_of_each_tuple(seg, select, doc_ids)
        cols = [_select_values(seg, e, doc_ids) for e in select]
        for r in zip(*cols):
            key = tuple(tuple(v) if isinstance(v, list) else v for v in r)
            if key not in seen:
                seen[key] = list(r)
    rows = list(seen.values())
    if ctx.having is not None:
        # GROUP BY without aggregations is DISTINCT (query/context.py);
        # its HAVING filters on the group expressions, per row
        keys = [str(e) for e in select]
        rows = [r for r in rows
                if _eval_scalar_filter(ctx.having, dict(zip(keys, r)))]
    if ctx.order_by:
        idx_of = {str(e): i for i, e in enumerate(select)}

        def sort_key(row):
            parts = []
            for ob in ctx.order_by:
                i = idx_of.get(str(ob.expr))
                if i is None:
                    raise QueryError(f"ORDER BY {ob.expr} not in DISTINCT "
                                     "list")
                parts.append(_Reversible(row[i], ob.ascending))
            return tuple(parts)
        rows.sort(key=sort_key)
    return ResultTable(DataSchema(names, types),
                       rows[ctx.offset: ctx.offset + ctx.limit])


def _first_of_each_tuple(seg: ImmutableSegment, select: List[Expr],
                         doc_ids: np.ndarray) -> np.ndarray:
    """The docs of ``doc_ids`` that hold the first occurrence of their
    tuple of select values, in doc order: the rows the JAX engine's
    per-row loop keeps. An MV select column keeps every doc."""
    codes, cards = [], []
    for e in select:
        got = _codes(seg, e, doc_ids)
        if got is None:
            return doc_ids
        codes.append(got[1])
        cards.append(max(len(got[0]), 1))
    _, gid, _ = compose_group_keys(codes, cards)
    first = np.full(int(gid.max()) + 1, doc_ids.size, dtype=np.int64)
    np.minimum.at(first, gid, np.arange(doc_ids.size, dtype=np.int64))
    return doc_ids[np.sort(first)]


def _codes(seg: ImmutableSegment, e: Expr, doc_ids: np.ndarray
           ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(sorted distinct values, each doc's index into them): what
    ``np.unique(values, return_inverse=True)`` gives over the docs'
    values of ``e``; None for an MV column."""
    if isinstance(e, Identifier) and e.name in seg.metadata.columns:
        ds = seg.data_source(e.name)
        cm = ds.metadata
        if not cm.single_value:
            return None
        if cm.has_dictionary:
            ids = np.asarray(ds.forward_index)[doc_ids].astype(np.int64)
            uniq_ids, codes = unique_inverse(ids, cm.cardinality)
            return ds.dictionary.values[uniq_ids], codes
    if isinstance(e, Identifier) and e.name in ("$segmentName",
                                                "$hostName"):
        # one value in the whole segment
        return (_virtual_column_values(seg, e.name, 1),
                np.zeros(doc_ids.size, dtype=np.int64))
    uniq, codes = np.unique(eval_expr_values(seg, e, doc_ids),
                            return_inverse=True)
    return uniq, codes.ravel()


# -- aggregation and group-by ----------------------------------------------------

def _agg_input_values(segment: ImmutableSegment, agg: AggDef, fn: Function):
    vexpr = agg_value_expr(fn)
    if vexpr is None:
        return np.zeros(segment.num_docs)  # COUNT(*): values unused
    if agg.base in ("lastwithtime", "firstwithtime"):
        # (valueColumn, timeColumn, 'dataType'): both columns' values
        return (eval_expr_values(segment, vexpr),
                eval_expr_values(segment, fn.args[1]))
    if agg.mv:
        if not isinstance(vexpr, Identifier):
            raise UnsupportedQueryError("MV aggregation argument must be a "
                                        "column")
        return mv_values(segment, vexpr.name)
    return eval_expr_values(segment, vexpr)


def host_aggregate_segment(ctx: QueryContext, aggs: List[AggDef],
                           segment: ImmutableSegment,
                           stats: Optional[QueryStats] = None) -> AggResult:
    mask = eval_filter(segment, ctx.filter)
    _track(stats, segment, mask)
    return AggResult([agg.compute_host(_agg_input_values(segment, agg, fn),
                                       mask)
                      for agg, fn in zip(aggs, ctx.aggregations)])


def host_group_by_segment(ctx: QueryContext, aggs: List[AggDef],
                          segment: ImmutableSegment,
                          stats: Optional[QueryStats] = None
                          ) -> GroupByResult:
    mask = eval_filter(segment, ctx.filter)
    _track(stats, segment, mask)
    filtered = np.nonzero(mask)[0]
    result = GroupByResult()
    if filtered.size == 0:
        return result

    key_values: List[np.ndarray] = []
    codes_list: List[np.ndarray] = []
    for e in ctx.group_by:
        uniq, codes = _group_codes(segment, e, filtered)
        key_values.append(uniq)
        codes_list.append(codes)
    uniq_keys, gid, decode_codes = compose_group_keys(
        codes_list, [max(len(u), 1) for u in key_values])
    keys = [tuple(_py(u[c]) for u, c in zip(key_values,
                                             decode_codes(int(k))))
            for k in uniq_keys]

    order = _stable_order(gid, len(uniq_keys))
    boundaries = np.searchsorted(gid[order], np.arange(len(uniq_keys) + 1))

    for agg, fn in zip(aggs, ctx.aggregations):
        vals = _agg_input_values(segment, agg, fn)
        for g in range(len(uniq_keys)):
            idx = filtered[order[boundaries[g]:boundaries[g + 1]]]
            sub_mask = np.ones(len(idx), dtype=bool)
            if agg.mv:
                sub_vals = vals.take(idx)
            elif agg.base in ("lastwithtime", "firstwithtime"):
                v, t = vals
                sub_vals = (np.asarray(v)[idx], np.asarray(t)[idx])
            else:
                sub_vals = np.asarray(vals)[idx]
            result.groups.setdefault(keys[g], []).append(
                agg.compute_host(sub_vals, sub_mask))
    return result


def _group_codes(segment: ImmutableSegment, e: Expr,
                 filtered: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A group expression's sorted distinct values over the filtered docs
    and each doc's index into them. An MV column in key position is an
    error, as in the JAX engine."""
    if isinstance(e, Identifier) and e.name in segment.metadata.columns \
            and not segment.metadata.column(e.name).single_value:
        raise UnsupportedQueryError(
            f"multi-value column {e.name!r} in expression position")
    return _codes(segment, e, filtered)


def _py(v: Any) -> Any:
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.str_):
        return str(v)
    return v
