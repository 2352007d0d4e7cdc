"""Segment batches: N segments unified into one block the scan runs once.

Counterpart of ``pinot_tpu/parallel/batch.py`` (``SegmentBatch``).
Per-segment dictionaries make dictIds incomparable across segments, so a
batch re-keys every dictionary column it touches into a unified
table-level dictionary (``_merge_dictionaries``) and stacks the remapped
forward indexes into ``[S, capacity]`` arrays (multi-value columns as
``[S, capacity, max_mv]`` dictIds and ``[S, capacity]`` counts); raw
columns stack their values in their staged dtype, null bitmaps stack as
they are. Group keys composed from unified dictIds then share one key
space across segments, and one scan over the whole batch adds every
segment into the same outputs. Upsert-managed segments cannot join a
batch: their valid-doc bitmaps change under it (the JAX package refuses
them too).

A batch duck-types the segment interfaces the planner and the scan's
eligibility rules read (``metadata.column()``, ``metadata.num_docs``,
``data_source().dictionary``, ``padded_capacity``), so ``plan_segment``
plans once against the unified key space.

``StagedBatch`` is the batch's device image, the counterpart of
``StagedSegment``: planar packed columns ``[S, T, W]`` and value columns
``[S, T * TILE]`` for the fused scan, the stacked arrays of
``stacked_column`` for the jnp combine (``column``), and ``num_docs``
``[S]``, each put on the device once, under a lock so that concurrent
queries share them. ``StagedBatch.demote`` copies the device tensors into
a ``BatchHostImage`` of pinned host tensors, which also keeps the
``SegmentBatch`` (its unified dictionaries and stacked numpy arrays); a
``StagedBatch`` built with the image restores each tensor at first use
with one host-to-device copy, with no unification, stacking or packing.

The merged column metadata of a batch carries no index: ``is_sorted`` and
every index flag are false (the JAX package's batch clears ``is_sorted``
and ``has_inverted_index``), since a batch stacks the segments' forward
indexes and not their indexes.
"""

from __future__ import annotations

import threading

from collections.abc import Mapping
from dataclasses import replace
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine.fused_scan import ScanKernels
from pinot_tpu_torch.engine.staging import (
    TILE,
    H2DCopies,
    PackedColumn,
    StagedColumn,
    pack_bits,
    raw_staged_dtype,
    staged_int_dtype,
    to_host,
    wait_for_copies,
)
from pinot_tpu_torch.parallel.combine import BATCH_KERNELS
from pinot_tpu_torch.parallel.mesh import (
    Cells,
    CombineMesh,
    fold_partials,
    pad_segments,
)
from pinot_tpu_torch.segment.dictionary import Dictionary, build_dictionary
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.segment.metadata import ColumnMetadata, SegmentMetadata
from pinot_tpu_torch.segment.mutable import is_mutable
from pinot_tpu_torch.spi.data import DataType


class _LazyColumnMap(Mapping):
    """Column name -> merged ColumnMetadata, merged on first access (a
    query pays dictionary unification only for the columns it reads)."""

    def __init__(self, batch: "SegmentBatch"):
        self._batch = batch

    def __getitem__(self, name: str) -> ColumnMetadata:
        return self._batch._merged_column(name)

    def __iter__(self):
        return iter(self._batch.segments[0].metadata.columns)

    def __len__(self) -> int:
        return len(self._batch.segments[0].metadata.columns)


class BatchDataSource:
    """Column access over the whole batch (planner-facing)."""

    def __init__(self, batch: "SegmentBatch", name: str):
        self.name = name
        self.metadata = batch.metadata.column(name)
        self.dictionary: Optional[Dictionary] = batch.unified_dictionary(name)


class SegmentBatch:
    """N same-table segments, re-keyed to unified dictionaries and stacked
    into fixed-shape arrays. Raises ValueError for segments that cannot
    share a batch (consuming, upsert-managed, different schemas or column
    layouts)."""

    def __init__(self, segments: List[ImmutableSegment]):
        if not segments:
            raise ValueError("empty segment batch")
        for s in segments:
            if is_mutable(s):
                # a consuming segment grows under a batch's frozen arrays
                # (JAX :72)
                raise ValueError(f"mutable segment {s.segment_name!r} "
                                 "cannot join a device batch")
            if s.valid_doc_ids is not None:
                raise ValueError(f"upsert segment {s.segment_name!r} "
                                 "cannot join a device batch")
        self.segments = segments
        first = segments[0].metadata
        cols = set(first.columns.keys())
        for s in segments[1:]:
            if set(s.metadata.columns.keys()) != cols:
                raise ValueError("segments in a batch must share a schema")

        self.capacity = max(s.padded_capacity for s in segments)
        self._dicts: Dict[str, Dictionary] = {}
        # per column: per-segment remap arrays (old dictId -> unified)
        self._remaps: Dict[str, List[np.ndarray]] = {}
        self._merged: Dict[str, ColumnMetadata] = {}
        # column -> (S, its stacked arrays)
        self._stacked: Dict[str, Tuple[int, Dict[str, np.ndarray]]] = {}
        self._merge_lock = threading.Lock()
        self._data_sources: Dict[str, BatchDataSource] = {}

        self.metadata = SegmentMetadata(
            segment_name="batch(" + ",".join(s.segment_name
                                             for s in segments) + ")",
            table_name=first.table_name,
            schema=first.schema,
            num_docs=sum(s.num_docs for s in segments),
            padded_capacity=self.capacity,
            columns=_LazyColumnMap(self),
        )

    # -- segment duck-type (planner interface) -----------------------------
    @property
    def segment_name(self) -> str:
        return self.metadata.segment_name

    @property
    def num_docs(self) -> int:
        return self.metadata.num_docs

    @property
    def padded_capacity(self) -> int:
        return self.capacity

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    def data_source(self, column: str) -> BatchDataSource:
        ds = self._data_sources.get(column)
        if ds is None:
            self.metadata.column(column)
            ds = BatchDataSource(self, column)
            self._data_sources[column] = ds
        return ds

    def unified_dictionary(self, column: str) -> Optional[Dictionary]:
        """None for a raw column."""
        self._merged_column(column)
        return self._dicts.get(column)

    def num_docs_array(self, pad_to: int = 0) -> np.ndarray:
        """[S] per-segment doc counts (0 for pad segments), int64: the
        scan's ``num_docs`` input."""
        out = np.zeros(max(pad_to, self.num_segments), dtype=np.int64)
        for i, s in enumerate(self.segments):
            out[i] = s.num_docs
        return out

    # -- unified dictionary construction -----------------------------------
    def _merged_column(self, name: str) -> ColumnMetadata:
        cm = self._merged.get(name)
        if cm is None:
            # one merge a column however many queries plan at once
            with self._merge_lock:
                cm = self._merged.get(name)
                if cm is None:
                    cm = self._merge_column(name)
                    self._merged[name] = cm
        return cm

    def _merge_column(self, name: str) -> ColumnMetadata:
        cms = [s.metadata.column(name) for s in self.segments]
        base = cms[0]
        for cm in cms[1:]:
            if (cm.data_type is not base.data_type
                    or cm.single_value != base.single_value
                    or cm.has_dictionary != base.has_dictionary):
                raise ValueError(f"column {name!r} layout differs across "
                                 "batch")
        has_nulls = any(cm.has_nulls for cm in cms)
        max_mv = max(cm.max_num_multi_values for cm in cms)
        base = replace(base, is_sorted=False, has_inverted_index=False,
                       has_range_index=False, has_bloom_filter=False,
                       has_fst_index=False, has_text_index=False,
                       has_json_index=False)
        if not base.has_dictionary:
            lows = [cm.min_value for cm in cms if cm.min_value is not None]
            highs = [cm.max_value for cm in cms if cm.max_value is not None]
            return replace(base, cardinality=sum(cm.cardinality for cm in cms),
                           min_value=min(lows) if lows else None,
                           max_value=max(highs) if highs else None,
                           has_nulls=has_nulls)
        dicts = [s.data_source(name).dictionary for s in self.segments]
        unified, remaps = _merge_dictionaries(dicts, base.data_type)
        self._dicts[name] = unified
        self._remaps[name] = remaps
        return replace(base, cardinality=unified.cardinality,
                       min_value=unified.min_value,
                       max_value=unified.max_value,
                       has_nulls=has_nulls, max_num_multi_values=max_mv)

    # -- stacked host arrays ------------------------------------------------
    def stacked_column(self, name: str, pad_segments: int = 0
                       ) -> Dict[str, np.ndarray]:
        """The batch's ``StagedColumn.tree()``: per-segment arrays with a
        leading ``[S]`` axis (``fwd`` unified dictIds or raw values in
        their staged dtype; ``mv`` and ``mvcount``; ``null``), the shared
        ``dictvals`` of a numeric dictionary without one. ``pad_segments``
        extends S with empty segments."""
        S = max(pad_segments, self.num_segments)
        cached = self._stacked.get(name)
        if cached is not None and cached[0] == S:
            return cached[1]
        cm = self.metadata.column(name)
        cap = self.capacity
        out: Dict[str, np.ndarray] = {}
        if not cm.single_value:
            mv = np.zeros((S, cap, max(cm.max_num_multi_values, 1)),
                          dtype=np.int32)
            cnt = np.zeros((S, cap), dtype=np.int32)
            for i, seg in enumerate(self.segments):
                dense, counts = seg.data_source(name).dense_mv()
                mv[i, :dense.shape[0], :dense.shape[1]] = \
                    self._remaps[name][i][dense]
                cnt[i, :counts.shape[0]] = counts
            out["mv"], out["mvcount"] = mv, cnt
        else:
            dt = (np.int32 if cm.has_dictionary else raw_staged_dtype(cm))
            fwd = np.zeros((S, cap), dtype=dt)
            for i, seg in enumerate(self.segments):
                raw = np.asarray(seg.data_source(name).forward_index)
                fwd[i, :raw.shape[0]] = (self._remaps[name][i][raw]
                                         if cm.has_dictionary else raw)
            out["fwd"] = fwd
        if cm.has_dictionary and cm.data_type.is_numeric:
            out["dictvals"] = self._dicts[name].device_values().astype(
                staged_int_dtype(cm) if cm.data_type.is_integral
                else np.float32)
        if cm.has_nulls:
            nb = np.zeros((S, cap), dtype=bool)
            for i, seg in enumerate(self.segments):
                b = seg.data_source(name).null_bitmap
                if b is not None:
                    nb[i, :b.shape[0]] = b
            out["null"] = nb
        self._stacked[name] = (S, out)
        return out

    # -- fused-scan layouts, batch-wide --------------------------------------
    def pallas_capacity(self) -> int:
        """Per-segment doc capacity padded to whole scan tiles."""
        return -(-self.capacity // TILE) * TILE

    def pallas_tiles(self, min_tiles: int = 1) -> int:
        """Tiles per segment (T), rounded up to a multiple of
        ``min_tiles`` (a mesh's doc axis splits the tiles evenly; the pad
        tiles lie past ``num_docs``)."""
        t = self.pallas_capacity() // TILE
        return -(-t // min_tiles) * min_tiles

    def packed_column_batch(self, name: str, pad_segments: int = 0,
                            min_tiles: int = 1) -> Tuple[np.ndarray, int]:
        """(words [S, T, W] uint32, bits): planar bit-packed unified
        dictIds, the layout of ``engine/staging.py`` per segment
        (bit-identical to the JAX package's ``[S, T, W/128, 128]``);
        ``min_tiles`` as in ``pallas_tiles``."""
        cm = self.metadata.column(name)
        if not (cm.has_dictionary and cm.single_value):
            raise ValueError(f"column {name!r} is not a single-value "
                             "dictionary column")
        fwd = self.stacked_column(name, pad_segments)["fwd"]
        S = fwd.shape[0]
        bits = pack_bits(max(1, max(cm.cardinality - 1, 1).bit_length()))
        K = 32 // bits
        W = TILE // K
        tiles = self.pallas_tiles(min_tiles)
        ids = np.zeros((S, tiles * TILE), dtype=np.uint32)
        ids[:, :fwd.shape[1]] = fwd.astype(np.uint32)
        planes = ids.reshape(S, tiles, K, W)
        words = np.zeros((S, tiles, W), dtype=np.uint32)
        for k in range(K):
            words |= planes[:, :, k, :] << np.uint32(k * bits)
        return words, bits

    def value_column_batch(self, name: str, pad_segments: int = 0,
                           min_tiles: int = 1) -> Optional[np.ndarray]:
        """[S, T * TILE] per-doc values of a single-value numeric column,
        dictionary or raw: f32 for float columns, i32 or i64 for integer
        columns (``staged_int_dtype`` of the merged stats). Where the JAX
        package splits an i64 column into 12-bit limb planes
        (``value_limb_batch``), the CUDA kernel reads the i64 values. None
        for a non-numeric or multi-value column."""
        cm = self.metadata.column(name)
        if not (cm.single_value and cm.data_type.is_numeric):
            return None
        tree = self.stacked_column(name, pad_segments)
        if cm.has_dictionary:
            vals = tree["dictvals"][tree["fwd"]]
        else:
            vals = tree["fwd"].astype(staged_int_dtype(cm)
                                      if cm.data_type.is_integral
                                      else np.float32)
        S = vals.shape[0]
        out = np.zeros((S, self.pallas_tiles(min_tiles) * TILE),
                       dtype=vals.dtype)
        out[:, :vals.shape[1]] = vals
        return out


def _merge_dictionaries(dicts: List[Dictionary], data_type: DataType
                        ) -> Tuple[Dictionary, List[np.ndarray]]:
    """Merge per-segment sorted dictionaries into one table-level
    dictionary; returns (unified, [per-segment oldId -> newId remaps])."""
    arrays = [d.values for d in dicts]
    unified = np.unique(np.concatenate(arrays))
    remaps = [np.searchsorted(unified, a).astype(np.int32) for a in arrays]
    return build_dictionary(unified, data_type), remaps


def _distinct_nbytes(obj, seen=None) -> int:
    """Bytes of the distinct tensors in a container (a tensor, or a dict
    or list of them: one a cell for a mesh's batch, whose cells on one
    device share their ``dictvals``)."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        if id(obj) in seen:
            return 0
        seen.add(id(obj))
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_distinct_nbytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_distinct_nbytes(v, seen) for v in obj)
    return 0


class BatchHostImage:
    """Host-tier image of a demoted ``StagedBatch`` (JAX
    ``_BatchHostImage``, ``pinot_tpu/parallel/executor.py:885``): the
    ``SegmentBatch`` and host copies of its device tensors, pinned when
    they came from a card. Its bytes are the copies and the batch's
    stacked arrays."""

    __slots__ = ("batch", "segment_names", "packed", "values", "columns",
                 "_nbytes")

    def __init__(self, batch: SegmentBatch):
        self.batch = batch
        self.segment_names = tuple(s.segment_name for s in batch.segments)
        self.packed: Dict[str, Tuple[torch.Tensor, int]] = {}
        self.values: Dict[str, torch.Tensor] = {}
        self.columns: Dict[str, Dict[str, torch.Tensor]] = {}
        self._nbytes = 0

    def seal(self) -> "BatchHostImage":
        self._nbytes = (
            sum(_distinct_nbytes(w) for w, _ in self.packed.values())
            + _distinct_nbytes(self.values) + _distinct_nbytes(self.columns)
            + sum(a.nbytes for _S, tree in self.batch._stacked.values()
                  for a in tree.values()))
        return self

    def matches(self, segments) -> bool:
        b = self.batch
        return (b is not None and segments is not None
                and len(b.segments) == len(segments)
                and all(c is s for c, s in zip(b.segments, segments)))

    def nbytes(self) -> int:
        return self._nbytes

    def release(self) -> None:
        self.packed.clear()
        self.values.clear()
        self.columns.clear()
        self.batch = None
        self._nbytes = 0


class StagedBatch:
    """Device image of one segment batch, staged column by column on
    demand (the JAX executor's ``_staged_pallas`` / ``_device_num_docs``
    per (batch, column)); with ``host_image``, promoted from it where it
    holds the tensor. ``num_segs`` pads the segment axis with empty
    segments (``num_docs`` 0), as the JAX package pads it to the mesh.
    Its scans launch through ``kernels``, the batch wrappers of
    ``parallel/combine.py``."""

    kernels: ScanKernels = BATCH_KERNELS

    def __init__(self, batch: SegmentBatch,
                 device: Union[str, torch.device] = "cuda",
                 num_segs: int = 0,
                 host_image: Optional[BatchHostImage] = None):
        self.device = resolve_device(device)
        self.batch = batch
        self.num_segs = max(num_segs, batch.num_segments)
        self._host_image = host_image  # guarded-by-writes: _lock
        self._packed: Dict[str, PackedColumn] = {}  # guarded-by-writes: _lock
        self._values: Dict[str, torch.Tensor] = {}  # guarded-by-writes: _lock
        self._columns: Dict[str, StagedColumn] = {}  # guarded-by-writes: _lock
        self._num_docs: Optional[torch.Tensor] = None  # guarded-by-writes: _lock
        self._lock = threading.Lock()
        self._copies = H2DCopies(self.device)
        # device bytes held, kept as tensors come and go
        self._bytes = 0  # guarded-by-writes: _lock

    @property
    def provider(self) -> SegmentBatch:
        """What the planner and the scan's eligibility rules read."""
        return self.batch

    def _promote(self, table: str, key):
        img = self._host_image
        return None if img is None else getattr(img, table).pop(key, None)

    def scan_capacity(self) -> int:
        """Per-segment doc capacity padded to whole scan tiles."""
        return self.batch.pallas_capacity()

    def num_docs_tensor(self) -> torch.Tensor:
        """[S] int64 docs of each segment, on the device."""
        if self._num_docs is None:
            with self._lock:
                if self._num_docs is None:
                    self._num_docs = torch.from_numpy(
                        self.batch.num_docs_array(self.num_segs)).to(
                            self.device)
                    self._bytes += self._num_docs.numel() * 8
        return self._num_docs

    def packed_column(self, name: str) -> PackedColumn:
        pc = self._packed.get(name)
        if pc is None:
            with self._lock:
                pc = self._packed.get(name)
                if pc is None:
                    hp = self._promote("packed", name)
                    if hp is not None:
                        pc = PackedColumn(self._copies.restore(hp[0]),
                                          hp[1])
                    else:
                        words, bits = self.batch.packed_column_batch(
                            name, self.num_segs)
                        pc = PackedColumn(torch.from_numpy(
                            words.view(np.int32)).to(self.device), bits)
                    self._packed[name] = pc
                    self._bytes += pc.words.numel() * 4
        return pc

    def value_column(self, name: str) -> Optional[torch.Tensor]:
        v = self._values.get(name)
        if v is None:
            with self._lock:
                v = self._values.get(name)
                if v is None:
                    hv = self._promote("values", name)
                    if hv is not None:
                        v = self._copies.restore(hv)
                    else:
                        host = self.batch.value_column_batch(name,
                                                             self.num_segs)
                        if host is None:
                            return None
                        v = torch.from_numpy(host).to(self.device)
                    self._values[name] = v
                    self._bytes += v.numel() * v.element_size()
        return v

    def combine_num_docs(self) -> torch.Tensor:
        """The jnp combine's ``num_docs``: [S] int64 on the device."""
        return self.num_docs_tensor()

    def held_column(self, name: str) -> Optional[StagedColumn]:
        """The column's staged arrays where they are staged, else None
        (nothing is staged): the root cell's on a mesh."""
        return self._columns.get(name)

    def segment_rows(self, name: str, i: int
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Copies of segment ``i``'s ``fwd`` and ``null`` rows of a staged
        column, on the batch's device."""
        sc = self._columns[name]
        return (sc.fwd[i].clone(),
                None if sc.null is None else sc.null[i].clone())

    def column(self, name: str) -> StagedColumn:
        """The jnp combine's arrays of a column: ``stacked_column`` on the
        device (``fwd`` / ``mv`` / ``mvcount`` / ``null`` with a leading
        ``[S]`` axis, the shared ``dictvals``)."""
        sc = self._columns.get(name)
        if sc is None:
            with self._lock:
                sc = self._columns.get(name)
                if sc is None:
                    hc = self._promote("columns", name)
                    if hc is not None:
                        sc = StagedColumn(**{k: self._copies.restore(t)
                                             for k, t in hc.items()})
                    else:
                        tree = self.batch.stacked_column(name, self.num_segs)
                        sc = StagedColumn(**{
                            k: torch.from_numpy(np.ascontiguousarray(v)).to(
                                self.device)
                            for k, v in tree.items()})
                    self._columns[name] = sc
                    self._bytes += sc.nbytes()
        return sc

    def nbytes(self) -> int:
        """Device bytes this batch holds."""
        return self._bytes

    def demote(self) -> BatchHostImage:
        """Copy the device tensors into a host image, wait for the copies,
        release the tensors; what this batch's own image still held
        carries over."""
        with self._lock:
            img = BatchHostImage(self.batch)
            for name, pc in self._packed.items():
                img.packed[name] = (to_host(pc.words), pc.bits)
            for name, v in self._values.items():
                img.values[name] = to_host(v)
            for name, sc in self._columns.items():
                img.columns[name] = {k: to_host(t)
                                     for k, t in sc.tree().items()}
            wait_for_copies(self.device)
            src = self._host_image
            if src is not None:
                for table in ("packed", "values", "columns"):
                    mine = getattr(img, table)
                    for k, v in getattr(src, table).items():
                        mine.setdefault(k, v)
            self._release_locked()
        return img.seal()

    def release(self) -> None:
        """Drop the device tensors and what is left of the host image (a
        launch in flight keeps its own)."""
        with self._lock:
            self._release_locked()

    def _release_locked(self) -> None:
        self._copies.wait()
        img = self._host_image
        if img is not None:
            img.release()
            self._host_image = None
        self._packed.clear()
        self._values.clear()
        self._columns.clear()
        self._num_docs = None
        self._bytes = 0


class MeshStagedBatch(StagedBatch):
    """Device image of one segment batch over a mesh of more than one cell
    (``parallel/mesh.py``): each cell's block on the cell's device, staged
    column by column on demand. The segments pad to a multiple of
    ``n_seg`` and the tiles to a multiple of ``n_doc`` (JAX's
    ``min_tiles``, ``pinot_tpu/parallel/executor.py:744-770``); a cell
    holds ``S / n_seg`` segments of packed words ``[., T / n_doc, W]``
    and value columns ``[., T / n_doc * TILE]``, the jnp combine's stacked
    arrays split at ``capacity / n_doc`` docs, and the shared ``dictvals``
    once a device. ``num_docs_tensor`` gives each cell the fused scan's
    clamped doc counts, ``combine_num_docs`` the jnp combine's per-segment
    ones. The bytes are summed over the cells; demotion copies every
    block to the host image and promotion restores each block to its
    cell."""

    def __init__(self, batch: SegmentBatch, mesh: CombineMesh,
                 num_segs: int = 0,
                 host_image: Optional[BatchHostImage] = None):
        super().__init__(batch, device=mesh.root,
                         num_segs=pad_segments(max(num_segs,
                                                   batch.num_segments),
                                               mesh.n_seg),
                         host_image=host_image)
        self.mesh = mesh
        self.tiles = batch.pallas_tiles(mesh.n_doc)
        self._copies_on = {d: H2DCopies(d) for d in mesh.devices}
        self._combine_nd: Optional[Cells] = None

    def scan_capacity(self) -> int:
        return self.tiles * TILE

    def _blocks(self, host: np.ndarray, width: int) -> Cells:
        """``host`` [S, width * n_doc, ...] cut into the cells' blocks, each
        copied to its cell."""
        m = self.mesh
        s_l = host.shape[0] // m.n_seg
        blocks = []
        for c, dev in enumerate(m.cells):
            si, di = divmod(c, m.n_doc)
            blk = np.ascontiguousarray(host[si * s_l:(si + 1) * s_l,
                                            di * width:(di + 1) * width])
            blocks.append(torch.from_numpy(blk).to(dev))
        return Cells(m, blocks, host.shape)

    def _restore(self, blocks: List[torch.Tensor], shape) -> Cells:
        return Cells(self.mesh,
                     [self._copies_on[dev].restore(h)
                      for h, dev in zip(blocks, self.mesh.cells)], shape)

    def _per_cell(self, host: np.ndarray, clamp: bool) -> Cells:
        m = self.mesh
        s_l = host.shape[0] // m.n_seg
        span = self.tiles // m.n_doc * TILE
        blocks = []
        for c, dev in enumerate(m.cells):
            si, di = divmod(c, m.n_doc)
            nd = host[si * s_l:(si + 1) * s_l]
            if clamp:
                nd = np.clip(nd - di * span, 0, span)
            blocks.append(torch.from_numpy(np.ascontiguousarray(nd)).to(dev))
        return Cells(m, blocks, host.shape)

    def num_docs_tensor(self) -> Cells:
        """Each cell's [S / n_seg] doc counts in its tile block:
        ``clamp(num_docs - di * T_l * TILE, 0, T_l * TILE)``."""
        if self._num_docs is None:
            with self._lock:
                if self._num_docs is None:
                    nd = self._per_cell(
                        self.batch.num_docs_array(self.num_segs), True)
                    self._num_docs = nd
                    self._bytes += nd.nbytes()
        return self._num_docs

    def combine_num_docs(self) -> Cells:
        """Each cell's segments' whole doc counts (the body takes the
        cell's ``doc_offset``)."""
        if self._combine_nd is None:
            with self._lock:
                if self._combine_nd is None:
                    nd = self._per_cell(
                        self.batch.num_docs_array(self.num_segs), False)
                    self._combine_nd = nd
                    self._bytes += nd.nbytes()
        return self._combine_nd

    def packed_column(self, name: str) -> PackedColumn:
        pc = self._packed.get(name)
        if pc is None:
            with self._lock:
                pc = self._packed.get(name)
                if pc is None:
                    hp = self._promote("packed", name)
                    if hp is not None:
                        pc = PackedColumn(self._restore(*hp[0]), hp[1])
                    else:
                        words, bits = self.batch.packed_column_batch(
                            name, self.num_segs, self.mesh.n_doc)
                        pc = PackedColumn(self._blocks(
                            words.view(np.int32),
                            self.tiles // self.mesh.n_doc), bits)
                    self._packed[name] = pc
                    self._bytes += pc.words.nbytes()
        return pc

    def value_column(self, name: str) -> Optional[Cells]:
        v = self._values.get(name)
        if v is None:
            with self._lock:
                v = self._values.get(name)
                if v is None:
                    hv = self._promote("values", name)
                    if hv is not None:
                        v = self._restore(*hv)
                    else:
                        host = self.batch.value_column_batch(
                            name, self.num_segs, self.mesh.n_doc)
                        if host is None:
                            return None
                        v = self._blocks(host,
                                         self.tiles // self.mesh.n_doc * TILE)
                    self._values[name] = v
                    self._bytes += v.nbytes()
        return v

    def column(self, name: str) -> StagedColumn:
        raise ValueError("a mesh's batch holds a column a cell: "
                         "column_cells")

    def held_column(self, name: str) -> Optional[StagedColumn]:
        cols = self._columns.get(name)
        return None if cols is None else cols[0]

    def segment_rows(self, name: str, i: int
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Segment ``i``'s rows joined from its cells' doc blocks, on the
        mesh's root."""
        m, cols = self.mesh, self._columns[name]
        si, il = divmod(i, self.num_segs // m.n_seg)
        mine = cols[si * m.n_doc:(si + 1) * m.n_doc]
        fwd = fold_partials([sc.fwd[il] for sc in mine], "cat", m.root)
        null = (None if mine[0].null is None else
                fold_partials([sc.null[il] for sc in mine], "cat", m.root))
        return fwd, null

    def column_cells(self, name: str) -> List[StagedColumn]:
        """The jnp combine's arrays of a column, one ``StagedColumn`` a
        cell: its segments' rows split at ``capacity / n_doc`` docs, and
        the ``dictvals`` of its device."""
        cols = self._columns.get(name)
        if cols is None:
            with self._lock:
                cols = self._columns.get(name)
                if cols is None:
                    hc = self._promote("columns", name)
                    cols = (self._restore_columns(hc) if hc is not None
                            else self._stage_columns(name))
                    self._columns[name] = cols
                    self._bytes += _distinct_nbytes([sc.tree() for sc in cols])
        return cols

    def _stage_columns(self, name: str) -> List[StagedColumn]:
        m = self.mesh
        tree = self.batch.stacked_column(name, self.num_segs)
        cap = self.batch.capacity
        if cap % m.n_doc:
            raise ValueError(f"capacity {cap} !| doc axis {m.n_doc}")
        split = {k: self._blocks(np.ascontiguousarray(v), cap // m.n_doc)
                 for k, v in tree.items() if k != "dictvals"}
        dv = tree.get("dictvals")
        dv_on = ({} if dv is None else
                 {d: torch.from_numpy(np.ascontiguousarray(dv)).to(d)
                  for d in m.devices})
        return [StagedColumn(dictvals=dv_on.get(dev),
                             **{k: cells[c] for k, cells in split.items()})
                for c, dev in enumerate(m.cells)]

    def _restore_columns(self, trees: List[Dict[str, torch.Tensor]]
                         ) -> List[StagedColumn]:
        m = self.mesh
        dv_on: Dict[torch.device, torch.Tensor] = {}
        out = []
        for tree, dev in zip(trees, m.cells):
            copies = self._copies_on[dev]
            fields = {k: copies.restore(t) for k, t in tree.items()
                      if k != "dictvals"}
            if "dictvals" in tree and dev not in dv_on:
                dv_on[dev] = copies.restore(tree["dictvals"])
            out.append(StagedColumn(dictvals=dv_on.get(dev), **fields))
        return out

    def demote(self) -> BatchHostImage:
        with self._lock:
            img = BatchHostImage(self.batch)
            for name, pc in self._packed.items():
                img.packed[name] = (([to_host(b) for b in pc.words],
                                     pc.words.shape), pc.bits)
            for name, v in self._values.items():
                img.values[name] = ([to_host(b) for b in v], v.shape)
            hosted: Dict[int, torch.Tensor] = {}   # a device's dictvals once

            def host(t: torch.Tensor) -> torch.Tensor:
                if id(t) not in hosted:
                    hosted[id(t)] = to_host(t)
                return hosted[id(t)]

            for name, cols in self._columns.items():
                img.columns[name] = [{k: host(t) for k, t in sc.tree().items()}
                                     for sc in cols]
            for dev in self.mesh.devices:
                wait_for_copies(dev)
            src = self._host_image
            if src is not None:
                for table in ("packed", "values", "columns"):
                    mine = getattr(img, table)
                    for k, v in getattr(src, table).items():
                        mine.setdefault(k, v)
            self._release_locked()
        return img.seal()

    def _release_locked(self) -> None:
        for copies in self._copies_on.values():
            copies.wait()
        super()._release_locked()
        self._combine_nd = None
