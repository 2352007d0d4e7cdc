"""Consuming segments on the card: chunked append-only columns and the
``mutable_device`` rung.

Counterpart of ``pinot_tpu/engine/mutable_staging.py``. A
``StagedMutableSegment`` keeps one consuming segment's columns on the
device and serves aggregations and group-bys over them with the general
rung's body (``engine/kernels.py``, PyTorch ops on the card), the path
immutable segments take where the fused scan declines:

- **Chunked columns, delta uploads.** Row-shaped tensors (``fwd``, ``mv``,
  ``mvcount``, ``null``) have a power-of-two row capacity; a regrowth
  copies the history on the device, and only the rows past the staged
  watermark cross from the host (``h2d_bytes`` counts every upload).
  Dictionary value tables (``dictvals``) grow in dictId space the same
  way: ids are arrival-ordered, so a staged prefix never changes.
- **One snapshot per query.** ``snapshot()`` reads the watermark (the
  doc count) first, under the resident's lock, then refreshes every
  column to it and returns the tensors as one frozen view with the upsert
  valid-doc mask at that watermark. The writer inserts a row's
  dictionary values before it publishes the row, so every id below the
  watermark has its value staged. A refresh never writes into a tensor
  that a live snapshot holds (a query in flight reads exactly its own
  watermark's rows, as with the JAX package's immutable arrays): such a
  tensor is copied on the device first (``copied_bytes``), and the copy
  the snapshot keeps counts in ``nbytes`` until it ends. With no query
  in flight the new rows are written in place.
- **Plans on a view.** ``WatermarkView`` is the segment at the snapshot:
  ``num_docs`` the watermark, ``padded_capacity`` the chunk capacity, so
  ``plan_segment`` builds a spec that fits the staged tensors. It is
  planned afresh for every query (no plan cache: the segment grows).
- **Residency.** The resident is registered under ``mutable::<segment>``
  with the query's lease and measured again after each refresh
  (``residency.account``); eviction releases it, and the next query
  stages again from the host columns.
- **Declines** are recorded with the JAX package's codes: HLL
  (``mutable_hll_lut_unstable``: the register tables go stale as the
  dictionary grows) and an empty watermark (``mutable_empty_watermark``)
  go to the host engine; a plan the device planner refuses records its
  ``plan:`` code. A failed staging or launch raises: the JAX package's
  ``mutable_exec_failed`` and ``mutable_index_exec_failed`` fallbacks are
  not copied.

A selective AND-ed EQ / IN / RANGE filter on single-value columns is
served by the index gather (``index_exec.index_gather``) over docIds from
the resident's growing dictId -> docIds map (``postings_doc_ids``),
recorded under the ``index`` point as ``mutable_index_served`` or
declined to the chunk scan with its reason.
"""

from __future__ import annotations

import threading
import weakref

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine import index_exec, kernels
from pinot_tpu_torch.engine.errors import PlanError
from pinot_tpu_torch.engine.host_eval import _matching_dict_ids
from pinot_tpu_torch.engine.plan import plan_segment
from pinot_tpu_torch.engine.results import QueryStats, record_decision
from pinot_tpu_torch.query.expressions import Identifier, PredicateType
from pinot_tpu_torch.segment import metadata as meta
from pinot_tpu_torch.segment.mutable import (
    MutableDataSource,
    MutableSegment,
    _dense_rows,
    _SnapshotColumns,
)

#: residency name prefix of a consuming segment's resident
MUTABLE_RESIDENT_PREFIX = "mutable::"

_MIN_CHUNK_ROWS = 1024

# a predicate matching more dictIds than this leaves the gather to the scan
_MAX_GATHER_IDS = 256


def resident_name(segment_name: str) -> str:
    return MUTABLE_RESIDENT_PREFIX + segment_name


def _chunk_capacity(n: int, floor: int = _MIN_CHUNK_ROWS) -> int:
    """The power of two at least ``n`` and ``floor``."""
    cap = max(1, floor)
    while cap < n:
        cap *= 2
    return cap


def _dictvals_dtype(data_type) -> np.dtype:
    """The device dtype of a growing dictionary's values, from the declared
    type alone (a dtype must not change while values arrive): INT i32,
    LONG i64, floats f32 as the immutable tables."""
    if data_type.is_integral:
        return (np.dtype(np.int32)
                if np.dtype(data_type.stored_np).itemsize <= 4
                else np.dtype(np.int64))
    return np.dtype(np.float32)


class MutableSnapshot:
    """One query's frozen view: the column tensors and the valid-doc mask
    at watermark ``wm``, over ``capacity`` rows."""

    __slots__ = ("wm", "capacity", "cols", "valid_host", "valid_device",
                 "__weakref__")

    def __init__(self, wm: int, capacity: int,
                 cols: Dict[str, Dict[str, torch.Tensor]],
                 valid_host: Optional[np.ndarray],
                 valid_device: Optional[torch.Tensor]):
        self.wm = wm
        self.capacity = capacity
        self.cols = cols
        self.valid_host = valid_host
        self.valid_device = valid_device

    def tree(self, name: str) -> Dict[str, torch.Tensor]:
        return self.cols[name]


class WatermarkView:
    """The segment at one snapshot: ``num_docs`` is the watermark,
    ``padded_capacity`` the chunk capacity. It has no ``is_mutable``, so
    the planner plans it. Dictionary reads go to the live dictionary: an
    id at or past the snapshot's staged values is held by no row below
    the watermark, so it matches no row."""

    def __init__(self, segment: MutableSegment, snap: MutableSnapshot):
        self._seg = segment
        self._wm = snap.wm
        self.segment_name = segment.segment_name
        self.num_docs = snap.wm
        self.padded_capacity = snap.capacity
        self.valid_doc_ids = snap.valid_host
        self.star_trees: List[Any] = []
        self.schema = segment.schema
        self.metadata = meta.SegmentMetadata(
            segment_name=segment.segment_name,
            table_name=segment.schema.schema_name, schema=segment.schema,
            num_docs=snap.wm, padded_capacity=snap.capacity,
            columns=_SnapshotColumns(segment, snap.wm))

    def data_source(self, column: str) -> MutableDataSource:
        col = self._seg._cols.get(column)
        if col is None:
            raise KeyError(f"column {column!r} not in segment "
                           f"{self.segment_name!r}")
        return MutableDataSource(self._seg, col, self._wm)


class StagedMutableSegment:
    """A consuming segment's chunked image on one device."""

    def __init__(self, segment: MutableSegment,
                 device: Union[str, torch.device] = "cuda"):
        self.segment = segment
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # "fwd:<col>" | "dictvals:<col>" | "mv:<col>" | "mvcount:<col>" |
        # "null:<col>" -> device tensor
        self._chunks: Dict[str, torch.Tensor] = {}
        # "cap" (row capacity), "wm" (last watermark staged), "rows:<col>",
        # "dict:<col>" (dictionary values staged), "mvw:<col>" (MV width)
        self._cursor: Dict[str, int] = {}
        # ((bitmap version, wm, cap), device mask, host mask)
        self._valid_cache = None
        # column -> {"upto": rows indexed, "lists": {dictId: [docId blocks]}}
        self._postings: Dict[str, Any] = {}
        # bytes of every postings block (counted as blocks are added: a
        # walk over the blocks would cost each residency measurement one
        # step per dictId)
        self._postings_bytes = 0
        # bytes copied from the host to the device so far
        self.h2d_bytes = 0
        # the snapshots of queries in flight, and the storage of their
        # tensors (gathered at each refresh): a refresh copies a tensor
        # held there before it writes
        self._live: "weakref.WeakSet[MutableSnapshot]" = weakref.WeakSet()
        self._held: set = set()
        # bytes copied on the device so that a live snapshot keeps its rows
        self.copied_bytes = 0

    # -- accounting ----------------------------------------------------------
    def nbytes(self) -> int:
        """The staged tensors, the postings, and the superseded tensors
        that live snapshots still hold."""
        with self._lock:
            tensors = list(self._chunks.values())
            if self._valid_cache is not None:
                tensors.append(self._valid_cache[1])
            for snap in list(self._live):
                tensors.extend(_snapshot_tensors(snap))
            seen, total = set(), self._postings_bytes
            for t in tensors:
                if t.data_ptr() not in seen:
                    seen.add(t.data_ptr())
                    total += int(t.numel() * t.element_size())
            return total

    def release(self) -> None:
        with self._lock:
            self._chunks.clear()
            self._cursor.clear()
            self._valid_cache = None
            self._postings.clear()
            self._postings_bytes = 0

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        self.h2d_bytes += int(t.numel() * t.element_size())
        return t.to(self.device)

    # -- staging -------------------------------------------------------------
    def snapshot(self) -> MutableSnapshot:
        """Stage up to the current watermark and return the query's frozen
        view (refresh and capture under one lock hold)."""
        seg = self.segment
        with self._lock:
            # the watermark first: every dictId its rows hold is inserted
            wm = int(seg._num_docs)
            self._held = {t.data_ptr() for snap in list(self._live)
                          for t in _snapshot_tensors(snap)}
            cap = int(self._cursor.get("cap", 0))
            if wm > cap or cap == 0:
                new_cap = _chunk_capacity(wm)
                if cap:
                    self._regrow_rows_locked(new_cap)
                cap = new_cap
                self._cursor["cap"] = cap
            for name, col in seg._cols.items():
                self._refresh_column_locked(name, col, wm, cap)
            self._cursor["wm"] = wm
            cols = {name: self._tree_locked(name, col)
                    for name, col in seg._cols.items()}
            valid_host, valid_device = self._valid_locked(wm, cap)
            snap = MutableSnapshot(wm, cap, cols, valid_host, valid_device)
            self._live.add(snap)
        return snap

    def _regrow_rows_locked(self, cap: int) -> None:
        """Every row-shaped tensor at ``cap`` rows, its history copied on
        the device."""
        for key, t in list(self._chunks.items()):
            if key.startswith("dictvals:"):
                continue    # grows in dictId space
            grown = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                                device=self.device)
            grown[:t.shape[0]] = t
            self._chunks[key] = grown

    def _writable_locked(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, or a device copy of it where a live snapshot holds it."""
        if t.data_ptr() not in self._held:
            return t
        self.copied_bytes += int(t.numel() * t.element_size())
        return t.clone()

    def _with_rows(self, key: str, shape, dtype, lo: int, hi: int,
                   rows: np.ndarray) -> None:
        """``key``'s tensor (zeros of ``shape`` when there is none) with
        rows ``[lo, hi)`` uploaded."""
        old = self._chunks.get(key)
        new = (torch.zeros(shape, dtype=dtype, device=self.device)
               if old is None else self._writable_locked(old))
        if hi > lo:
            new[lo:hi] = self._upload(rows)
        self._chunks[key] = new

    def _refresh_column_locked(self, name: str, col, wm: int,
                               cap: int) -> None:
        staged = int(self._cursor.get(f"rows:{name}", 0))
        if col.mv_offsets is None:
            if wm > staged or f"fwd:{name}" not in self._chunks:
                self._with_rows(f"fwd:{name}", (cap,), torch.int32, staged,
                                wm, col.fwd.view(wm)[staged:wm]
                                .astype(np.int32))
        else:
            self._refresh_mv_locked(name, col, staged, wm, cap)
        if col.fs.data_type.is_numeric:
            self._refresh_dictvals_locked(name, col)
        if col.has_nulls:
            key = f"null:{name}"
            # has_nulls can turn true mid-consume: the null store holds
            # every row from doc 0, so the first staging uploads the prefix
            lo = staged if key in self._chunks else 0
            if wm > lo or key not in self._chunks:
                self._with_rows(key, (cap,), torch.bool, lo, wm,
                                col.null.view(wm)[lo:wm])
        self._cursor[f"rows:{name}"] = wm

    def _refresh_mv_locked(self, name: str, col, staged: int, wm: int,
                           cap: int) -> None:
        width = int(self._cursor.get(f"mvw:{name}", 0))
        need = _chunk_capacity(max(col.max_mv, 1), floor=1)
        mv_key, cnt_key = f"mv:{name}", f"mvcount:{name}"
        if mv_key in self._chunks and need > width:
            # a wider row pads on the device (the history stays there)
            mv = self._chunks[mv_key]
            self._chunks[mv_key] = torch.nn.functional.pad(
                mv, (0, need - width))
        if need > width:
            width = need
            self._cursor[f"mvw:{name}"] = width
        if wm > staged or mv_key not in self._chunks:
            off = np.asarray(col.mv_offsets.view(wm + 1), dtype=np.int64)
            dense, counts = _dense_rows(col.fwd.view(int(off[-1])),
                                        off[staged:wm + 1])
            block = np.zeros((wm - staged, width), dtype=np.int32)
            block[:, :dense.shape[1]] = dense[:, :width]
            self._with_rows(mv_key, (cap, width), torch.int32, staged, wm,
                            block)
            self._with_rows(cnt_key, (cap,), torch.int32, staged, wm, counts)

    def _refresh_dictvals_locked(self, name: str, col) -> None:
        d = col.dictionary
        card = len(d)
        if card == 0:
            return
        key = f"dictvals:{name}"
        staged = int(self._cursor.get(f"dict:{name}", 0))
        old = self._chunks.get(key)
        dcap = int(old.shape[0]) if old is not None else 0
        if card <= staged:
            return
        dt = _dictvals_dtype(col.fs.data_type)
        if card > dcap:
            new = torch.zeros(_chunk_capacity(card), dtype=_TORCH[dt],
                              device=self.device)
            if old is not None:
                new[:dcap] = old
        else:
            new = self._writable_locked(old)
        # arrival-ordered ids: only the values [staged, card) are new
        new[staged:card] = self._upload(np.asarray(
            d.get_values(range(staged, card)), dtype=dt))
        self._chunks[key] = new
        self._cursor[f"dict:{name}"] = card

    def _tree_locked(self, name: str, col) -> Dict[str, torch.Tensor]:
        if col.mv_offsets is None:
            out = {"fwd": self._chunks[f"fwd:{name}"]}
        else:
            out = {"mv": self._chunks[f"mv:{name}"],
                   "mvcount": self._chunks[f"mvcount:{name}"]}
        dv = self._chunks.get(f"dictvals:{name}")
        if dv is not None:
            out["dictvals"] = dv
        nc = self._chunks.get(f"null:{name}")
        if nc is not None:
            out["null"] = nc
        return out

    def _postings_blocks(self, name: str, col, dict_ids,
                         wm: int) -> List[np.ndarray]:
        """The postings blocks of ``dict_ids`` in the single-value column
        ``name``: the consuming segment's inverted index, grown by one
        stable argsort of the rows past its last refresh (each block is
        ascending; a dictId's blocks follow in docId order)."""
        with self._lock:
            st = self._postings.get(name)
            if st is None:
                st = self._postings[name] = {"upto": 0, "lists": {}}
            upto = int(st["upto"])
            if wm > upto:
                fwd = np.asarray(col.fwd.view(wm)[upto:wm])
                order = np.argsort(fwd, kind="stable").astype(np.int64)
                sv = fwd[order]
                uniq, starts = np.unique(sv, return_index=True)
                bounds = np.append(starts, sv.size)
                lists = st["lists"]
                for i, d in enumerate(uniq.tolist()):
                    lists.setdefault(int(d), []).append(
                        order[bounds[i]:bounds[i + 1]] + upto)
                self._postings_bytes += int(order.nbytes)
                st["upto"] = wm
            return [block for d in dict_ids
                    for block in st["lists"].get(int(d), ())]

    def postings_count(self, name: str, col, dict_ids, wm: int) -> int:
        """How many docs below ``wm`` hold a dictId of ``dict_ids`` (another
        query may have indexed past this snapshot's watermark)."""
        return sum(int(np.searchsorted(b, wm))
                   for b in self._postings_blocks(name, col, dict_ids, wm))

    def postings_doc_ids(self, name: str, col, dict_ids,
                         wm: int) -> np.ndarray:
        """The ascending docIds below ``wm`` that hold a dictId of
        ``dict_ids``."""
        parts = self._postings_blocks(name, col, dict_ids, wm)
        if not parts:
            return np.empty(0, dtype=np.int64)
        docs = parts[0] if len(parts) == 1 else \
            np.sort(np.concatenate(parts))
        return docs[:int(np.searchsorted(docs, wm))]

    def _valid_locked(self, wm: int, cap: int):
        """(host mask, device mask) of the upsert valid docs at this
        watermark, or (None, None); cached on (bitmap version, wm, cap), so
        a repeated query at one watermark uploads nothing."""
        v = self.segment.valid_doc_ids
        if v is None:
            return None, None
        ver = getattr(v, "version", None)
        key = (ver, wm, cap)
        cached = self._valid_cache
        if ver is not None and cached is not None and cached[0] == key:
            return cached[2], cached[1]
        snap = np.zeros(cap, dtype=bool)
        snap[:wm] = np.asarray(v[:wm])
        dev = self._upload(snap)
        if ver is not None:
            self._valid_cache = (key, dev, snap)
        return snap, dev


def _snapshot_tensors(snap: MutableSnapshot) -> List[torch.Tensor]:
    out = [t for tree in snap.cols.values() for t in tree.values()]
    if snap.valid_device is not None:
        out.append(snap.valid_device)
    return out


_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.float32): torch.float32}


# --------------------------------------------------------------------------
# the serve path (the executor's branch for a consuming segment)
# --------------------------------------------------------------------------

def _decline(stats: QueryStats, reason: str) -> None:
    """To the host engine."""
    record_decision(stats, "mutable", "host_engine", "mutable_device",
                    reason)


def _decline_rung(stats: QueryStats, reason: str) -> None:
    """The index gather declined to the chunk scan (not to the host)."""
    record_decision(stats, "index", "mutable_device", "index_gather", reason)


def _chose_rung(stats: QueryStats, reason: str) -> None:
    record_decision(stats, "index", "index_gather", "mutable_device", reason)


def serve_group_by(executor, ctx, aggs, seg: MutableSegment,
                   stats: QueryStats):
    return _serve(executor, ctx, aggs, seg, stats, grouped=True)


def serve_aggregation(executor, ctx, aggs, seg: MutableSegment,
                      stats: QueryStats):
    return _serve(executor, ctx, aggs, seg, stats, grouped=False)


def stage(executor, seg: MutableSegment,
          stats: Optional[QueryStats] = None) -> StagedMutableSegment:
    """The segment's resident, pinned by the lease of ``stats``."""
    return executor.residency.register(
        resident_name(seg.segment_name),
        lambda: StagedMutableSegment(seg, device=executor.device),
        same=lambda r: getattr(r, "segment", None) is seg,
        lease=stats.lease if stats is not None else None)


def _serve(executor, ctx, aggs, seg: MutableSegment, stats: QueryStats,
           grouped: bool):
    """One query over the consuming segment on the device: a decoded
    result, or None for the host engine (every None is recorded)."""
    from pinot_tpu_torch.engine.executor import (
        decode_grouped_result,
        decode_scalar_result,
    )

    if any(a.base == "distinctcounthll" for a in aggs):
        _decline(stats, "mutable_hll_lut_unstable")
        return None
    if int(seg.num_docs) == 0:
        _decline(stats, "mutable_empty_watermark")
        return None
    resident = stage(executor, seg, stats)
    snap = resident.snapshot()
    # the chunks may have grown: measure again, enforce the budget
    executor.residency.account(resident_name(seg.segment_name), stats.lease)
    view = WatermarkView(seg, snap)
    try:
        plan = plan_segment(ctx, view)
    except PlanError as e:
        record_decision(stats, "plan", "host_engine", "mutable_device",
                        e.reason_code)
        return None

    try:
        res = _try_index_gather(executor, ctx, seg, resident, view, snap,
                                plan, stats, grouped)
        if res is not None:
            return res
        out = _scan(executor, plan, snap)
    except PlanError as e:   # the decode: more live groups than its cap
        record_decision(stats, "plan", "host_engine", "mutable_device",
                        e.reason_code)
        return None
    matched = int(out["num_matched"] if "num_matched" in out
                  else np.asarray(out["presence"]).sum())
    stats.num_segments_processed += 1
    stats.total_docs += snap.wm
    stats.num_docs_scanned += matched
    stats.num_segments_matched += 1 if matched else 0
    if grouped:
        return decode_grouped_result(plan, view, out)
    return decode_scalar_result(plan, view, out)


def _scan(executor, plan, snap: MutableSnapshot) -> Dict[str, Any]:
    """The plan over the snapshot on the general rung: one call, one
    copy to the host."""
    kernel = executor.kernels.get(plan.spec)
    params = kernels.device_params(plan, executor.device)
    if plan.params and plan.params[0] is None:
        # the validdocs placeholder: the snapshot's mask, at the staged
        # rows' watermark
        params = (snap.valid_device,) + params[1:]
    packed = kernel({n: snap.tree(n) for n in plan.columns}, params,
                    snap.wm, executor.device)
    return kernels.unpack_outputs(packed.cpu().numpy(), plan.spec)


def _try_index_gather(executor, ctx, seg: MutableSegment,
                      resident: StagedMutableSegment, view: WatermarkView,
                      snap: MutableSnapshot, plan, stats: QueryStats,
                      grouped: bool):
    """The consuming segment's index rung (JAX ``_try_index_gather``
    :579): a selective AND of EQ / IN / RANGE on single-value columns
    resolves docIds from the growing postings and runs the immutable
    rung's gather over the snapshot's tensors. None where it does not
    apply (recorded on a filtered query) or declines: the chunk scan
    serves."""
    from pinot_tpu_torch.engine.executor import (
        decode_grouped_result,
        decode_scalar_result,
    )

    if str(ctx.options.get("useIndexRung", "true")).lower() == "false" \
            or ctx.filter is None:
        return None     # an operator's choice, or nothing to select
    preds = index_exec._flatten_and(ctx.filter)
    if not preds:
        if preds is None:   # OR / NOT
            _decline_rung(stats, "mutable_index_unsupported_shape")
        return None
    if snap.valid_host is not None:
        # upsert: the valid docs AND the filter and the postings miss them
        _decline_rung(stats, "mutable_index_unsupported_shape")
        return None

    wm = snap.wm
    threshold = max(1, int(wm * index_exec.SELECTIVITY_THRESHOLD))
    per_pred = []
    for pred in preds:
        lhs = pred.lhs
        if not isinstance(lhs, Identifier) or lhs.name.startswith("$") \
                or pred.type not in (PredicateType.EQ, PredicateType.IN,
                                     PredicateType.RANGE):
            _decline_rung(stats, "mutable_index_unsupported_shape")
            return None
        col = seg._cols.get(lhs.name)
        if col is None or col.mv_offsets is not None:
            _decline_rung(stats, "mutable_index_unsupported_shape")
            return None
        ids = _matching_dict_ids(view.data_source(lhs.name), pred)
        if ids.size > _MAX_GATHER_IDS:   # broad: the scan wins outright
            _decline_rung(stats, "mutable_index_over_threshold")
            return None
        per_pred.append((lhs.name, col, ids))

    counts = [resident.postings_count(name, col, ids, wm)
              for name, col, ids in per_pred]
    if min(counts) > threshold:
        _decline_rung(stats, "mutable_index_over_threshold")
        return None
    # the smallest route's docIds, then the other predicates tested on
    # those docs' dictIds (the intersection of the routes, without reading
    # a broad route's postings)
    first = int(np.argmin(counts))
    name, col, ids = per_pred[first]
    idx = resident.postings_doc_ids(name, col, ids, wm)
    for i, (name, col, ids) in enumerate(per_pred):
        if i != first and idx.size:
            idx = idx[np.isin(col.fwd.view(wm)[idx], ids)]
    n = int(idx.size)

    stripped = index_exec.gather_plan(plan, n)
    padded = np.zeros(stripped.spec[4], dtype=np.int32)
    padded[:n] = idx
    packed = index_exec.index_gather(
        stripped.spec, {c: snap.tree(c) for c in stripped.columns},
        torch.from_numpy(padded).to(executor.device),
        kernels.device_params(stripped, executor.device), n)
    out = kernels.unpack_outputs(packed.cpu().numpy(), stripped.spec)
    stats.num_segments_processed += 1
    stats.total_docs += wm
    stats.num_docs_scanned += n
    if n:
        stats.num_segments_matched += 1
    _chose_rung(stats, "mutable_index_served")
    if grouped:
        return decode_grouped_result(stripped, view, out)
    return decode_scalar_result(stripped, view, out)


__all__ = ["MUTABLE_RESIDENT_PREFIX", "MutableSnapshot",
           "StagedMutableSegment", "WatermarkView", "resident_name",
           "serve_aggregation", "serve_group_by", "stage"]
