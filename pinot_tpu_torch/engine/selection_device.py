"""Ordered selection on the card: filter and top-k per segment.

Counterpart of ``pinot_tpu/engine/selection_device.py`` (``_order_columns``
:43, ``_build_kernel`` :78, ``device_selection`` :103). ``SELECT cols FROM
t WHERE ... ORDER BY keys LIMIT n`` runs its filter and its order on the
card: per segment, the filter's mask (``kernels._emit_filter``, the
general rung's filter), each order key as f64 (negated for DESC, ``+inf``
where the mask is false), and a lexicographic order with docId as the
final key give the segment's first ``offset + limit`` doc ids; one
device-to-host copy carries them and the matched count. The host merges
the segments' candidates with the host engine's stable lexsort and reads
only the chosen rows, as the JAX package does.

The JAX kernel is a ``jax.jit`` program over jnp (``lax.sort`` with docId
as the last key), not a Pallas kernel, so the port's is PyTorch ops:
stable ``torch.sort`` passes from the last key to the first, starting
from docId order, which keeps docId order among equal keys (``+ 0.0``
folds ``-0.0`` into ``0.0``, which the host's sort holds equal). A segment
holds one f64 key array and the docId permutation at a time.

Eligibility is the JAX package's, so a query takes the same path on both:
every ORDER BY expression a single-value column without nulls,
dictionary-encoded (sorted by dictId: the dictionary is sorted) or raw
numeric, not a raw i64 column (its values would round through f64) and,
for a raw float column, finite min/max stats; a filter the device planner
compiles; ``offset + limit`` at most ``MAX_DEVICE_SELECTION_K``; no
upsert-managed or consuming segment (JAX :123). Otherwise
:func:`device_selection` returns None and the executor serves the query
on the host engine.
"""

from __future__ import annotations

import math
import weakref
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.engine import host_engine
from pinot_tpu_torch.engine.errors import PlanError
from pinot_tpu_torch.engine.fused_scan import KernelCounter, _ParamCursor
from pinot_tpu_torch.engine.kernels import _Cols, _emit_filter
from pinot_tpu_torch.engine.plan import _compile_filter
from pinot_tpu_torch.engine.results import DataSchema, QueryStats, ResultTable
from pinot_tpu_torch.engine.staging import staged_int_dtype
from pinot_tpu_torch.query.context import QueryContext, filter_fingerprint
from pinot_tpu_torch.query.expressions import Identifier
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.segment.mutable import is_mutable

# top-k cap: past this the full sort and the copy stop beating the host
MAX_DEVICE_SELECTION_K = 8192
# compiled filters kept per executor (the JAX package's kernel cache bound)
_CACHE_CAP = 256

# segment calls of the top-k (PyTorch ops on the segment's device)
TOPK_COUNTER = KernelCounter("device_topk")


class SelectionCache:
    """(sql, filter fingerprint, segment name) -> the segment's compiled
    filter and its params on the device, least recently used evicted past
    ``_CACHE_CAP``; a reloaded segment (same name, new object) compiles
    again. An entry holds its segment by weak reference."""

    def __init__(self):
        self._entries: "OrderedDict[Tuple, Tuple]" = OrderedDict()

    def get(self, key: Tuple, seg: ImmutableSegment):
        hit = self._entries.get(key)
        if hit is None or hit[0]() is not seg:
            return None
        self._entries.move_to_end(key)
        return hit[1]

    def put(self, key: Tuple, seg: ImmutableSegment, value) -> None:
        self._entries[key] = (weakref.ref(seg), value)
        self._entries.move_to_end(key)
        while len(self._entries) > _CACHE_CAP:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)


def _order_columns(ctx: QueryContext,
                   segment: ImmutableSegment) -> Optional[List[str]]:
    cols = []
    for ob in ctx.order_by:
        e = ob.expr
        if not isinstance(e, Identifier) or e.name.startswith("$"):
            return None
        cm = segment.metadata.column(e.name)
        if not cm.single_value or cm.has_nulls:
            return None
        if not (cm.has_dictionary or cm.data_type.is_numeric):
            return None
        if not cm.has_dictionary:
            if (cm.data_type.is_integral
                    and staged_int_dtype(cm) != np.dtype(np.int32)):
                return None  # i64 keys would round through the f64 sort
            if not cm.data_type.is_integral:
                # filtered-out docs sort at +inf: the stats must prove
                # the values finite
                try:
                    if (cm.min_value is None or cm.max_value is None
                            or not math.isfinite(float(cm.min_value))
                            or not math.isfinite(float(cm.max_value))):
                        return None
                except (TypeError, ValueError):
                    return None
        cols.append(e.name)
    return cols


def topk_docs(filter_spec: Tuple, cols: _Cols, params: Tuple,
              num_docs: int, capacity: int, keys: List[torch.Tensor],
              ascending: Tuple[bool, ...], k: int,
              device: torch.device) -> torch.Tensor:
    """-> [k + 1] int64 on ``device``: the first ``k`` doc ids in key
    order (docId breaking ties), then the matched count. Docs past the
    matched ones are filtered out (at ``+inf``)."""
    pc = _ParamCursor(params)
    mask = _emit_filter(filter_spec, cols, pc, capacity, device)
    pc.finish()  # the params are exactly the filter's
    mask = mask & (torch.arange(capacity, device=device) < num_docs)
    perm = torch.arange(capacity, device=device)
    for key, asc in zip(reversed(keys), reversed(ascending)):
        v = key.to(torch.float64)
        if not asc:
            v = -v
        v = torch.where(mask, v, math.inf).index_select(0, perm) + 0.0
        perm = perm.index_select(0, torch.sort(v, stable=True).indices)
        del v
    TOPK_COUNTER.add()
    return torch.cat([perm[:k], mask.sum().view(1)])


def segment_plan(ctx: QueryContext, seg: ImmutableSegment,
                 cache: SelectionCache) -> Optional[Tuple[List[str], Tuple]]:
    """(order columns, compiled filter) of one segment, or None where the
    segment is not eligible."""
    if seg.valid_doc_ids is not None or is_mutable(seg):
        return None
    order_cols = _order_columns(ctx, seg)
    if order_cols is None:
        return None
    key = (ctx.sql if ctx.sql is not None else repr(ctx),
           filter_fingerprint(ctx), seg.segment_name)
    compiled = cache.get(key, seg)
    if compiled is None:
        params: List[Any] = []
        columns: List[str] = []
        try:
            spec = _compile_filter(ctx.filter, seg, params, columns)
        except PlanError:
            return None
        compiled = (spec, params, columns, {})
        cache.put(key, seg, compiled)
    return order_cols, compiled


def topk_args(ctx: QueryContext, seg: ImmutableSegment, staging,
              plan: Tuple[List[str], Tuple],
              stats: Optional[QueryStats] = None) -> Tuple:
    """The arguments of ``topk_docs`` for one segment: its staged columns
    (pinned by ``stats``'s lease), the filter's params on its device
    (uploaded once per plan)."""
    order_cols, (spec, params, columns, on_device) = plan
    staged = staging.stage(seg, stats)
    device = staged.device
    dev_params = on_device.get(device)
    if dev_params is None:
        dev_params = tuple(torch.as_tensor(np.asarray(p)).to(device)
                           for p in params)
        on_device[device] = dev_params
    cols = _Cols({c: staged.column(c).tree() for c in columns})
    keys = [staged.column(c).fwd for c in order_cols]
    k = min(ctx.offset + ctx.limit, seg.padded_capacity)
    return (spec, cols, dev_params, seg.num_docs, seg.padded_capacity, keys,
            tuple(ob.ascending for ob in ctx.order_by), k, device)


def device_selection(ctx: QueryContext, segments: List[ImmutableSegment],
                     staging, stats: Optional[QueryStats]
                     ) -> Optional[ResultTable]:
    """The ordered branch of ``host_engine.execute_selection`` with each
    segment's scan and sort on the card; None when the query is not
    eligible. ``staging.stage(seg, stats)`` gives a segment's staged image and
    ``staging.selection_cache`` keeps the compiled filters."""
    need = ctx.offset + ctx.limit
    if not ctx.order_by or need <= 0 or need > MAX_DEVICE_SELECTION_K:
        return None
    schema = segments[0].metadata.schema
    select = host_engine._expand_select(ctx, schema)
    names = host_engine._select_names(ctx, select)
    types = [host_engine._column_type(segments[0], e) for e in select]

    # every segment is checked before any runs, so a decline leaves the
    # stats to the host engine
    plans = [segment_plan(ctx, seg, staging.selection_cache)
             for seg in segments]
    if any(p is None for p in plans):
        return None

    picked: List[Tuple[ImmutableSegment, np.ndarray]] = []
    for seg, plan in zip(segments, plans):
        args = topk_args(ctx, seg, staging, plan, stats)
        k = args[7]
        out = topk_docs(*args).cpu().numpy()
        del args
        n = int(out[-1])
        if stats is not None:
            stats.num_segments_processed += 1
            stats.total_docs += seg.num_docs
            stats.num_docs_scanned += n
            stats.num_segments_matched += 1 if n else 0
            stats.topk_launches += 1
        if n:
            picked.append((seg, out[:min(n, k)]))

    if not picked:
        return ResultTable(DataSchema(names, types), [])
    # merge the segments' candidates as the host engine orders its rows: a
    # stable lexsort over the keys' values in segment order
    key_cols = [np.concatenate([host_engine._order_key_array(seg, ob.expr, d)
                                for seg, d in picked])
                for ob in ctx.order_by]
    order = host_engine._lexsort(key_cols,
                                 [ob.ascending for ob in ctx.order_by])
    order = order[ctx.offset: ctx.offset + ctx.limit]
    seg_of = np.concatenate([np.full(len(d), i)
                             for i, (_, d) in enumerate(picked)])
    docs = np.concatenate([d for _, d in picked])
    return ResultTable(DataSchema(names, types),
                       host_engine._gather_rows([s for s, _ in picked],
                                                select, seg_of[order],
                                                docs[order]))
