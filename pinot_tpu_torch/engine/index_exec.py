"""Index rung: selective conjunctive filters served by a docId gather.

Counterpart of ``pinot_tpu/engine/index_exec.py``:

1. The host resolves the matching docIds from the segment's indexes: the
   postings of an inverted column (EQ / IN / RANGE as dictIds, unioned
   within a multi-value row), binary search over a sorted column's
   forward index, or the sorted-order permutation of a range-indexed raw
   column. Of an AND, the most selective conjunct's docs are resolved and
   the others test those docs' values (the same docIds as the JAX rung's
   intersection of every list, without reading the broad ones).
2. The rung is chosen on exact match counts before any posting is read
   (the postings' offsets, binary-search bounds, a range's width): past
   ``SELECTIVITY_THRESHOLD`` of the segment's docs the scan rungs serve.
3. The docIds pad to a power-of-two capacity and go to the device once
   (``StagedSegment.index_slice``); ``index_gather`` gathers each staged
   column's per-doc arrays down to them with ``index_select`` (``dictvals``
   is dictId-shaped and is not gathered) and runs the general rung's body
   (``engine/kernels.py``) over the gathered block with the filter
   ``("true",)``. Rows, group keys and the packed output are the scan's;
   ``num_docs_scanned`` is the matched docs.

Every outcome on a filtered aggregation is recorded under the ``index``
decision point with the JAX package's reason codes; ``OPTION(
useIndexRung=false)`` opts out with no decision. One planned difference:
the JAX rung also declines on any other exception of its launch
(``index_exec_failed``), which would hide a failed launch on the card;
here only a ``PlanError`` declines.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from pinot_tpu_torch.engine import kernels
from pinot_tpu_torch.engine.aggregates import AggDef
from pinot_tpu_torch.engine.errors import PlanError
from pinot_tpu_torch.engine.fused_scan import KernelCounter
from pinot_tpu_torch.engine.host_eval import (
    _matching_dict_ids,
    search_sorted,
)
from pinot_tpu_torch.engine.plan import (
    SegmentPlan,
    _next_pow2,
    expected_param_count,
)
from pinot_tpu_torch.engine.results import QueryStats, record_decision
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    FilterNode,
    FilterOp,
    Identifier,
    Predicate,
    PredicateType,
)

# share of a segment's docs above which an estimated match count declines
# to the scan rungs: past it the gather reads most of the segment anyway
SELECTIVITY_THRESHOLD = 0.05

# cap on per-dictId postings reads (or interval slices); contiguous dictId
# runs resolve as one interval and never reach it
_MAX_ID_LISTS = 1024

_MIN_CAPACITY = 128

_EMPTY = np.empty(0, dtype=np.int64)

# gather calls of the index rung, on any device (PyTorch ops, as the
# general rung's RUNG_COUNTER)
INDEX_COUNTER = KernelCounter("index_gather")


def index_gather(spec, cols, idx: torch.Tensor, params, n: int
                 ) -> torch.Tensor:
    """The gathered block's packed f64 outputs (JAX ``build_gather_kernel``
    :70): each column's per-doc arrays (``fwd`` / ``mv`` / ``mvcount`` /
    ``null``) gathered at ``idx`` (the padded docIds), ``dictvals`` as is,
    then the body over the block's first ``n`` rows, on ``idx``'s
    device."""
    gathered = {name: {k: (v if k == "dictvals" else v.index_select(0, idx))
                       for k, v in tree.items()}
                for name, tree in cols.items()}
    device = kernels._check_device(gathered, params, idx.device)
    INDEX_COUNTER.add()
    body = kernels.build_kernel_body(spec, sparse_k=kernels.sparse_mode(spec))
    return kernels.pack_outputs(body(gathered, params, n, 0, device), spec)


def _decline(stats: Optional[QueryStats], reason: str) -> None:
    if stats is not None:
        record_decision(stats, "index", "scan", "index_gather", reason)


def _chose(stats: QueryStats, reason: str) -> None:
    record_decision(stats, "index", "index_gather", "scan", reason)


def _flatten_and(node: Optional[FilterNode]) -> Optional[List[Predicate]]:
    """Filter -> its AND-ed predicates ([] for no filter), or None for an
    OR / NOT shape (JAX ``startree_exec.py:37``)."""
    if node is None:
        return []
    if node.op is FilterOp.PREDICATE:
        return [node.predicate]
    if node.op is not FilterOp.AND:
        return None
    out: List[Predicate] = []
    for c in node.children:
        sub = _flatten_and(c)
        if sub is None:
            return None
        out.extend(sub)
    return out


class _Decline(Exception):
    """A predicate shape the rung does not route; carries the code."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _Route:
    """One predicate's index path: an exact match count, computed without
    reading postings, the resolver of its sorted unique int64 docIds, and
    ``keep(docs)``, which of some candidate docs it matches (read from the
    forward index: the docs its postings would list)."""

    __slots__ = ("estimate", "resolve", "keep")

    def __init__(self, estimate: int, resolve: Callable[[], np.ndarray],
                 keep: Callable[[np.ndarray], np.ndarray]):
        self.estimate = estimate
        self.resolve = resolve
        self.keep = keep


def _dict_keep(ds, cm, ids: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
    """``keep`` of a dictionary predicate: the docs with a dictId (any of
    a multi-value row's) among ``ids``."""
    def keep(docs: np.ndarray) -> np.ndarray:
        if cm.single_value:
            return np.isin(np.asarray(ds.forward_index)[docs], ids)
        dense, counts = ds.dense_mv()
        rows = np.asarray(dense)[docs]
        entry = (np.arange(rows.shape[1])[None, :]
                 < np.asarray(counts)[docs][:, None])
        return (np.isin(rows, ids) & entry).any(axis=1)
    return keep


def _postings_route(ds, cm, ids: np.ndarray) -> _Route:
    """EQ / IN / RANGE over an inverted dictionary column: the count from
    the postings' offsets, the docs from their union."""
    if ids.size > _MAX_ID_LISTS:
        raise _Decline("index_selectivity_over_threshold")
    offsets = np.asarray(ds.inverted_index[0])
    est = int((offsets[ids + 1] - offsets[ids]).sum()) if ids.size else 0
    multi_value = not cm.single_value

    def resolve() -> np.ndarray:
        if ids.size == 0:
            return _EMPTY
        parts = [ds.doc_ids_for_dict_id(int(i)) for i in ids]
        docs = parts[0] if len(parts) == 1 else np.concatenate(parts)
        docs = docs.astype(np.int64, copy=False)
        if multi_value:
            # a row may hold a value twice, and the postings of different
            # dictIds share rows: a union, not a concatenation
            return np.unique(docs)
        return docs if len(parts) == 1 else np.sort(docs)

    return _Route(est, resolve, _dict_keep(ds, cm, ids))


def _sorted_route(ds, cm, ids: np.ndarray, num_docs: int) -> _Route:
    """A sorted dictionary column: each dictId is a contiguous run of docs,
    found by binary search over the forward index."""
    keep = _dict_keep(ds, cm, ids)
    if ids.size == 0:
        return _Route(0, lambda: _EMPTY, keep)
    fwd = np.asarray(ds.forward_index[:num_docs])
    if int(ids[-1] - ids[0]) + 1 == ids.size:  # contiguous dictId interval
        lo = search_sorted(fwd, int(ids[0]), "left")
        hi = search_sorted(fwd, int(ids[-1]), "right")
        return _Route(hi - lo, lambda: np.arange(lo, hi, dtype=np.int64),
                      keep)
    if ids.size > _MAX_ID_LISTS:
        raise _Decline("index_selectivity_over_threshold")
    # dictIds fit the forward index's dtype: no promotion of the column
    los = np.searchsorted(fwd, ids.astype(fwd.dtype), side="left")
    his = np.searchsorted(fwd, ids.astype(fwd.dtype), side="right")
    est = int((his - los).sum())

    def resolve() -> np.ndarray:
        parts = [np.arange(lo, hi, dtype=np.int64)
                 for lo, hi in zip(los.tolist(), his.tolist()) if hi > lo]
        if not parts:
            return _EMPTY
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    return _Route(est, resolve, keep)


def _range_route(ds, cm, pred: Predicate, num_docs: int) -> _Route:
    """RANGE (or EQ, the range [v, v]) over a range-indexed raw column:
    binary search on the sorted values, a slice of the permutation."""
    sorted_vals = ds.range_sorted_values
    dt = cm.data_type
    lo_i, hi_i = 0, num_docs
    lo = hi = None
    if pred.type is PredicateType.EQ:
        lo = hi = dt.convert(pred.value)
        lo_incl = hi_incl = True
    else:
        if pred.lower is not None:
            lo, lo_incl = dt.convert(pred.lower), pred.lower_inclusive
        if pred.upper is not None:
            hi, hi_incl = dt.convert(pred.upper), pred.upper_inclusive
    if lo is not None:
        lo_i = search_sorted(sorted_vals, lo, "left" if lo_incl else "right")
    if hi is not None:
        hi_i = search_sorted(sorted_vals, hi, "right" if hi_incl else "left")
    est = max(0, hi_i - lo_i)
    order = ds.range_order

    def resolve() -> np.ndarray:
        if hi_i <= lo_i:
            return _EMPTY
        return np.sort(np.asarray(order[lo_i:hi_i]).astype(np.int64))

    def keep(docs: np.ndarray) -> np.ndarray:
        vals = np.asarray(ds.forward_index)[docs]
        m = np.ones(docs.shape[0], dtype=bool)
        if lo is not None:
            m &= (vals >= lo) if lo_incl else (vals > lo)
        if hi is not None:
            m &= (vals <= hi) if hi_incl else (vals < hi)
        return m

    return _Route(est, resolve, keep)


def _pred_route(segment, pred: Predicate, num_docs: int) -> _Route:
    """Predicate -> its index route, or raise _Decline with the code."""
    lhs = pred.lhs
    if not isinstance(lhs, Identifier) or lhs.name.startswith("$"):
        raise _Decline("index_filter_shape")
    if pred.type not in (PredicateType.EQ, PredicateType.IN,
                         PredicateType.RANGE):
        raise _Decline("index_pred_type_unsupported")
    ds = segment.data_source(lhs.name)
    cm = ds.metadata
    if cm.has_dictionary:
        ids = _matching_dict_ids(ds, pred)
        if cm.single_value and cm.is_sorted:
            return _sorted_route(ds, cm, ids, num_docs)
        if cm.has_inverted_index:
            return _postings_route(ds, cm, ids)
        raise _Decline("index_missing_index")
    if (cm.single_value
            and pred.type in (PredicateType.EQ, PredicateType.RANGE)
            and ds.range_order is not None):
        return _range_route(ds, cm, pred, num_docs)
    raise _Decline("index_missing_index")


def resolve_doc_ids(segment, preds: List[Predicate], num_docs: int,
                    threshold: int) -> Optional[np.ndarray]:
    """A conjunction -> its sorted unique int64 docIds, or None past the
    threshold (raises _Decline for a shape the rung does not route). The
    counts are checked before any posting is read; then only the most
    selective predicate's docs are resolved, and each other predicate
    keeps those of them it matches, read from the forward index: the
    docIds of the JAX rung's intersection of every list, without reading
    the broader lists."""
    routes = [_pred_route(segment, p, num_docs) for p in preds]
    if min(r.estimate for r in routes) > threshold:
        return None
    routes.sort(key=lambda r: r.estimate)
    idx = routes[0].resolve()
    for r in routes[1:]:
        if idx.size == 0:
            break
        idx = idx[r.keep(idx)]
    return idx


def gather_plan(full: SegmentPlan, n: int) -> SegmentPlan:
    """The gathered block's plan, from the scan plan: the filter becomes
    ``("true",)`` (every gathered row passed it on the host), the capacity
    the docIds' power-of-two pad, and the filter's params (the first ones:
    ``plan_segment`` packs filter, group, aggregation params in turn)
    drop. The group bases stay, narrowed by the filter or not: the
    gathered rows satisfy the conjuncts they came from."""
    spec = full.spec
    stripped = (("true",), spec[1], spec[2], spec[3],
                max(_MIN_CAPACITY, _next_pow2(max(1, n))))
    n_filter = expected_param_count(spec) \
        - expected_param_count((("true",),) + spec[1:])
    return SegmentPlan(
        spec=stripped,
        params=list(full.params[n_filter:]),
        columns=_spec_columns(stripped, full.columns),
        group_defs=full.group_defs,
        group_cards=full.group_cards,
        group_strides=full.group_strides,
        num_groups=full.num_groups,
        agg_defs=full.agg_defs,
        group_bases=full.group_bases)


def _spec_columns(spec, candidates: List[str]) -> List[str]:
    """The columns the stripped spec still reads (a column only the filter
    read is not staged)."""
    names = set()

    def walk(node):
        if isinstance(node, tuple):
            for x in node:
                walk(x)
        elif isinstance(node, str):
            names.add(node)

    walk((spec[1], spec[2]))
    return [c for c in candidates if c in names]


def gather_inputs(executor, ctx: QueryContext, segment, idx: np.ndarray,
                  stats: Optional[QueryStats] = None):
    """-> (gathered plan, staged columns, padded docIds on the device,
    params on the device): ``index_gather``'s inputs for the resolved
    docIds ``idx`` of one segment. The docIds go to the device once per
    filter (``StagedSegment.index_slice``), staged through ``stats``'s
    lease and accounted. Raises PlanError where the segment's plan does."""
    n = int(idx.size)
    full = executor._plan_for(ctx, segment)
    capacity = max(_MIN_CAPACITY, _next_pow2(max(1, n)))
    # one gathered plan per capacity, kept on the scan plan, so a repeated
    # query uploads its params once
    plan = full.gathered.get(capacity)
    if plan is None:
        plan = full.gathered[capacity] = gather_plan(full, n)
    staged = executor.stage(segment, stats)

    def build_idx() -> np.ndarray:
        padded = np.zeros(capacity, dtype=np.int32)
        padded[:n] = idx
        return padded

    idx_dev = staged.index_slice((str(ctx.filter), capacity), build_idx)
    cols = {name: staged.column(name).tree() for name in plan.columns}
    executor.residency.account(segment.segment_name,
                               stats.lease if stats is not None else None)
    return plan, cols, idx_dev, kernels.device_params(plan, executor.device)


def _opted_out(ctx: QueryContext) -> bool:
    return str(ctx.options.get("useIndexRung", "true")).lower() == "false"


def batch_index_eligible(ctx: QueryContext, segments) -> bool:
    """Should a multi-segment query leave the batch for the per-segment
    path, where the index rung serves it? True when the AND-ed filter
    routes through indexes and its count is under the threshold on every
    segment (counts only, no postings read; JAX :295)."""
    if _opted_out(ctx) or ctx.filter is None:
        return False
    preds = _flatten_and(ctx.filter)
    if not preds:
        return False
    for segment in segments:
        if segment.valid_doc_ids is not None:
            return False
        num_docs = segment.num_docs
        threshold = max(1, int(num_docs * SELECTIVITY_THRESHOLD))
        try:
            routes = [_pred_route(segment, p, num_docs) for p in preds]
        except _Decline:
            return False
        if min(r.estimate for r in routes) > threshold:
            return False
    return True


def try_index_rung(executor, ctx: QueryContext, aggs: List[AggDef],
                   segment, stats: QueryStats, grouped: bool
                   ) -> Optional[Any]:
    """An AggResult / GroupByResult served by the docId gather, or None
    (the scan rungs serve; every decline on a filtered query is recorded,
    JAX :328)."""
    from pinot_tpu_torch.engine.executor import (
        decode_grouped_result,
        decode_scalar_result,
    )

    if _opted_out(ctx) or ctx.filter is None:
        return None     # an operator's choice, or nothing to select
    preds = _flatten_and(ctx.filter)
    if not preds:
        if preds is None:   # OR / NOT: the indexes do not compose here
            _decline(stats, "index_filter_shape")
        return None
    if segment.valid_doc_ids is not None:
        # the valid-doc bitmap ANDs every filter and the postings do not
        # see it: the scan rungs' validdocs leaf serves
        _decline(stats, "index_upsert_valid_docs")
        return None

    num_docs = segment.num_docs
    threshold = max(1, int(num_docs * SELECTIVITY_THRESHOLD))
    try:
        idx = resolve_doc_ids(segment, preds, num_docs, threshold)
    except _Decline as d:
        _decline(stats, d.reason)
        return None
    if idx is None:
        _decline(stats, "index_selectivity_over_threshold")
        return None
    n = int(idx.size)
    try:
        plan, cols, idx_dev, params = gather_inputs(executor, ctx, segment,
                                                    idx, stats)
        packed = index_gather(plan.spec, cols, idx_dev, params, n)
        # one copy to the host; the decode may refuse the compact cap
        out = kernels.unpack_outputs(packed.cpu().numpy(), plan.spec)
    except PlanError:
        # the scan path plans again and records the plan's own code
        _decline(stats, "index_plan_error")
        return None

    stats.num_segments_processed += 1
    stats.total_docs += num_docs
    stats.num_docs_scanned += n
    if n:
        stats.num_segments_matched += 1
    _chose(stats, "index_served")
    if grouped:
        stats.record_rung("index")
        return decode_grouped_result(plan, segment, out)
    return decode_scalar_result(plan, segment, out)
