"""Device staging: segment columns -> tensors on one device.

Counterpart of ``pinot_tpu/engine/staging.py``. For the fused scan, planar
bit-packed dictIds (``packed_column``) and per-doc values
(``value_column``, decoded from the dictionary or read from a raw
column); for the general rung (``engine/kernels.py``), each column's
arrays (``column``):

- single-value dictionary column: ``fwd`` int32 dictIds [capacity];
- raw single-value column: ``fwd`` the values [capacity], integers in
  ``staged_int_dtype``, floats in f64 (filter literals then compare with
  the exact stored values; the JAX package's note at :31-36);
- multi-value column: ``mv`` int32 dictIds [capacity, max_mv] and
  ``mvcount`` int32 [capacity];
- numeric dictionary: ``dictvals``, the dictionary's values (i32 or i64 by
  ``staged_int_dtype``, f32 for floats);
- nullable column: ``null`` bool [capacity].

Each is staged once per segment and cached. ``valid_mask`` is the upsert
valid-doc snapshot the ``validdocs`` filter leaf reads. ``index_slice``
holds the index rung's padded docId arrays, one per resolved filter, the
least recently used dropped past ``INDEX_SLICE_CAP``. ``startree_nodes``
holds a star-tree's record columns (JAX :437-501), staged at first use and
released one tree at a time (``release_startree``).

Planar layout (bit-identical to the JAX package's ``_pack``): docs are cut
into tiles of ``TILE`` docs; with ``B`` bits per value and ``K = 32 / B``
values per 32-bit word, a tile has ``W = TILE / K`` words and value ``j`` of
the tile sits in word ``j % W`` at bit ``(j // W) * B``. Neighbouring docs
therefore sit in neighbouring words, which a CUDA warp reads coalesced.
The words are held as ``torch.int32`` carrying the uint32 bit pattern.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Union

import numpy as np
import torch

from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.segment.immutable import ImmutableSegment

# docs per tile of the fused scan (the JAX package's PALLAS_TILE)
TILE = 4096

_I32_MIN, _I32_MAX = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)

# index-rung docId arrays kept per staged segment (the JAX package's
# _INDEX_SLICE_CAP): a working-set bound, each at most a few percent of
# the segment's docs
INDEX_SLICE_CAP = 64


def staged_int_dtype(cm) -> np.dtype:
    """Device dtype of an integral column's values, from its min/max."""
    if (cm.min_value is not None and cm.max_value is not None
            and _I32_MIN <= int(cm.min_value)
            and int(cm.max_value) <= _I32_MAX):
        return np.dtype(np.int32)
    return np.dtype(np.int64)


def raw_staged_dtype(cm) -> np.dtype:
    """Device dtype of a raw column's ``fwd``: integers by their stats,
    floats f64."""
    return (staged_int_dtype(cm) if cm.data_type.is_integral
            else np.dtype(np.float64))


def pack_bits(bits_needed: int) -> int:
    """Power-of-two bit width, so no value straddles two words."""
    for b in (1, 2, 4, 8, 16):
        if bits_needed <= b:
            return b
    return 32


def pack_planar(ids: np.ndarray, bits: int) -> np.ndarray:
    """dictIds [tiles * TILE] -> planar words [tiles, W] uint32."""
    K = 32 // bits
    W = TILE // K
    tiles = ids.shape[0] // TILE
    planes = ids.astype(np.uint32).reshape(tiles, K, W)
    words = np.zeros((tiles, W), dtype=np.uint32)
    for k in range(K):
        words |= planes[:, k, :] << np.uint32(k * bits)
    return words


class PackedColumn:
    """Planar bit-packed dictIds: ``words`` [num_tiles, W] int32 tensor."""

    def __init__(self, words: torch.Tensor, bits: int):
        self.words = words
        self.bits = bits
        self.vals_per_word = 32 // bits


_TREE_KEYS = ("fwd", "dictvals", "mv", "mvcount", "null")


class StagedColumn:
    """One column's arrays for the general rung (see the module
    docstring); absent arrays are None."""

    def __init__(self, fwd: Optional[torch.Tensor] = None,
                 dictvals: Optional[torch.Tensor] = None,
                 mv: Optional[torch.Tensor] = None,
                 mvcount: Optional[torch.Tensor] = None,
                 null: Optional[torch.Tensor] = None):
        self.fwd = fwd
        self.dictvals = dictvals
        self.mv = mv
        self.mvcount = mvcount
        self.null = null

    def tree(self) -> Dict[str, torch.Tensor]:
        """The arrays the rung reads, by name (only those present)."""
        return {k: getattr(self, k) for k in _TREE_KEYS
                if getattr(self, k) is not None}

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tree().values())


class StagedSegment:
    """Device image of one segment, staged column by column on demand."""

    def __init__(self, segment: ImmutableSegment,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.segment = segment
        self.num_docs = segment.num_docs
        self.capacity = segment.padded_capacity
        self._packed: Dict[str, PackedColumn] = {}
        self._values: Dict[str, torch.Tensor] = {}
        self._columns: Dict[str, StagedColumn] = {}
        self._num_docs: Optional[torch.Tensor] = None
        self._index_slices: "OrderedDict[Hashable, torch.Tensor]" = \
            OrderedDict()
        self._startree: Dict[int, Dict[str, torch.Tensor]] = {}

    @property
    def provider(self) -> ImmutableSegment:
        """What the planner and the scan's eligibility rules read."""
        return self.segment

    def num_docs_tensor(self) -> torch.Tensor:
        """``[num_docs]`` int64 on the device: the scan's input for a batch
        of one segment, uploaded once."""
        if self._num_docs is None:
            self._num_docs = torch.tensor([self.num_docs], dtype=torch.int64,
                                          device=self.device)
        return self._num_docs

    def scan_capacity(self) -> int:
        """Doc capacity padded up to whole tiles (the kernel masks the
        tail past ``num_docs``); the JAX package's ``pallas_capacity``."""
        return -(-self.capacity // TILE) * TILE

    def packed_column(self, name: str) -> Optional[PackedColumn]:
        pc = self._packed.get(name)
        if pc is None:
            cm = self.segment.metadata.column(name)
            if not (cm.has_dictionary and cm.single_value):
                return None
            bits = pack_bits(max(1, max(cm.cardinality - 1, 1).bit_length()))
            ids = np.zeros(self.scan_capacity(), dtype=np.uint32)
            fwd = np.asarray(self.segment.data_source(name).forward_index)
            ids[:fwd.shape[0]] = fwd
            words = pack_planar(ids, bits).view(np.int32)
            pc = PackedColumn(torch.from_numpy(words).to(self.device), bits)
            self._packed[name] = pc
        return pc

    def value_column(self, name: str) -> Optional[torch.Tensor]:
        """Per-doc values [scan_capacity] of a single-value numeric column,
        dictionary or raw: f32 for float columns, i32 or i64 for integer
        columns (``staged_int_dtype``)."""
        v = self._values.get(name)
        if v is None:
            ds = self.segment.data_source(name)
            cm = ds.metadata
            if not (cm.single_value and cm.data_type.is_numeric):
                return None
            dt = (staged_int_dtype(cm) if cm.data_type.is_integral
                  else np.dtype(np.float32))
            vals = np.zeros(self.scan_capacity(), dtype=dt)
            fwd = np.asarray(ds.forward_index)
            if cm.has_dictionary:
                vals[:fwd.shape[0]] = ds.dictionary.device_values().astype(
                    dt)[fwd]
            else:
                vals[:fwd.shape[0]] = fwd
            v = torch.from_numpy(vals).to(self.device)
            self._values[name] = v
        return v

    def column(self, name: str) -> StagedColumn:
        """The general rung's arrays of a column."""
        sc = self._columns.get(name)
        if sc is None:
            sc = self._stage(name)
            self._columns[name] = sc
        return sc

    def _stage(self, name: str) -> StagedColumn:
        ds = self.segment.data_source(name)
        cm = ds.metadata

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        sc = StagedColumn()
        if not cm.single_value:
            dense, counts = ds.dense_mv()
            sc.mv = put(np.asarray(dense, dtype=np.int32))
            sc.mvcount = put(np.asarray(counts, dtype=np.int32))
        elif cm.has_dictionary:
            sc.fwd = put(np.asarray(ds.forward_index).astype(np.int32))
        else:
            sc.fwd = put(np.asarray(ds.forward_index).astype(
                raw_staged_dtype(cm)))
        if cm.has_dictionary and cm.data_type.is_numeric:
            dt = (staged_int_dtype(cm) if cm.data_type.is_integral
                  else np.dtype(np.float32))
            sc.dictvals = put(ds.dictionary.device_values().astype(dt))
        if cm.has_nulls:
            sc.null = put(np.asarray(ds.null_bitmap, dtype=bool))
        return sc

    def valid_mask(self) -> Optional[torch.Tensor]:
        """Upsert valid-doc snapshot [capacity] bool on the device, or None
        for a segment that is not upsert-managed (the JAX package's
        ``valid_mask``, :540-564). Uploaded at every call, so each query
        sees the bitmap as it is when it runs."""
        v = self.segment.valid_doc_ids
        if v is None:
            return None
        snap = np.zeros(self.capacity, dtype=bool)
        snap[:self.num_docs] = np.asarray(v[:self.num_docs])
        return torch.from_numpy(snap).to(self.device)

    def index_slice(self, key: Hashable,
                    build: Callable[[], np.ndarray]) -> torch.Tensor:
        """The index rung's padded docId array for one resolved filter
        (``key``), put on the device once and reused by repeated queries;
        ``build()`` gives the host array on a miss. Least recently used
        first out past ``INDEX_SLICE_CAP``."""
        arr = self._index_slices.get(key)
        if arr is not None:
            self._index_slices.move_to_end(key)
            return arr
        arr = torch.from_numpy(np.ascontiguousarray(build())).to(self.device)
        self._index_slices[key] = arr
        while len(self._index_slices) > INDEX_SLICE_CAP:
            self._index_slices.popitem(last=False)
        return arr

    def startree_nodes(self, tree_index: int) -> Dict[str, torch.Tensor]:
        """Star-tree ``tree_index``'s record columns on the device, keyed
        as the node plan reads them (``plan.startree_dim_key`` /
        ``startree_metric_key``): int32 dictIds per split dimension (STAR
        = -1), int64 counts and float64 values per pair. Staged once; a
        repeated query uploads none."""
        key = int(tree_index)
        t = self._startree.get(key)
        if t is None:
            from pinot_tpu_torch.engine.plan import (
                startree_dim_key,
                startree_metric_key,
            )

            tree = self.segment.star_trees[key]
            dims = np.asarray(tree.dims)
            t = {}
            for i, name in enumerate(tree.config.dimensions_split_order):
                t[startree_dim_key(name)] = torch.from_numpy(
                    np.ascontiguousarray(dims[:, i], dtype=np.int32)).to(
                        self.device)
            for pair, vals in tree.metrics.items():
                fn, _, col = pair.partition("__")
                dt = np.int64 if fn == "count" else np.float64
                t[startree_metric_key(fn, col)] = torch.from_numpy(
                    np.ascontiguousarray(vals, dtype=dt)).to(self.device)
            self._startree[key] = t
        return t

    def release_startree(self, tree_index: int) -> int:
        """Drop one tree's device columns, its siblings staying; -> the
        device bytes released."""
        t = self._startree.pop(int(tree_index), None)
        if t is None:
            return 0
        return sum(a.numel() * a.element_size() for a in t.values())

    def startree_nbytes(self) -> Dict[int, int]:
        """Device bytes per staged tree."""
        return {ti: sum(a.numel() * a.element_size() for a in t.values())
                for ti, t in self._startree.items()}

    def index_nbytes(self) -> int:
        """Device bytes of the resident docId arrays."""
        return sum(a.numel() * a.element_size()
                   for a in self._index_slices.values())

    def nbytes(self) -> int:
        """Device bytes this segment holds."""
        return (sum(pc.words.numel() * 4 for pc in self._packed.values())
                + sum(v.numel() * v.element_size()
                      for v in self._values.values())
                + sum(c.nbytes() for c in self._columns.values())
                + self.index_nbytes()
                + sum(self.startree_nbytes().values()))
