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

Residency (``engine/residency.py``): ``nbytes`` counts every device
tensor a segment holds, ``demote`` copies them into a
``SegmentHostImage`` of pinned host tensors and releases them, and a
``StagedSegment`` built with that image restores each array at its next
``column`` / ``packed_column`` / ``value_column`` / ``startree_nodes``
call with one host-to-device copy instead of a rebuild (JAX
``_promote_column`` :237, ``_promote_packed`` :303, ``_promote_startree``
:475). Builds serialise on a per-segment lock, so concurrent queries
share one set of device tensors. A ``StagedSegment`` built with a
``borrower`` (the residency manager's ``column_borrower``) first asks it
for a column's arrays: a resident batch holding the segment may lend them
from its device copy (JAX :216-229).
"""

from __future__ import annotations

import threading
import weakref

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple, Union

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


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned, enqueued without waiting, for a CUDA
    tensor (the caller waits before it reads it or drops ``t``); a clone
    for a CPU tensor."""
    if t.device.type != "cuda":
        return t.clone()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


class H2DCopies:
    """Copies from a host image back to ``device``: a pinned source is
    copied without waiting and stays referenced until its copy completes
    (``wait`` waits for every pending one). ``bytes`` counts what was
    restored."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bytes = 0
        self._pending: List[Tuple[Any, torch.Tensor]] = []

    def restore(self, h: torch.Tensor) -> torch.Tensor:
        self.bytes += _nbytes(h)
        if self.device.type != "cuda":
            return h.to(self.device)
        d = h.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._pending = [(e, src) for e, src in self._pending
                         if not e.query()]
        self._pending.append((event, h))
        return d

    def wait(self) -> None:
        for event, _src in self._pending:
            event.synchronize()
        self._pending.clear()


class SegmentHostImage:
    """Host-RAM tier image of one demoted ``StagedSegment`` (JAX
    ``SegmentHostImage`` :109-175): host copies of its device tensors,
    pinned when they came from a card, in the same containers (column
    trees by name, packed words with their width, value columns, star-tree
    node columns by tree). Promotion hands the image to a new
    ``StagedSegment``, which moves each array back at first use."""

    __slots__ = ("columns", "packed", "values", "startree", "segment_names",
                 "_segment_ref", "_nbytes")

    def __init__(self, segment):
        # weak: an image must not keep an unloaded segment alive; identity
        # is checked again at promotion
        self._segment_ref = weakref.ref(segment)
        self.segment_names = (segment.segment_name,)
        self.columns: Dict[str, Dict[str, torch.Tensor]] = {}
        self.packed: Dict[str, Tuple[torch.Tensor, int]] = {}
        self.values: Dict[str, torch.Tensor] = {}
        self.startree: Dict[int, Dict[str, torch.Tensor]] = {}
        self._nbytes = 0

    def seal(self) -> "SegmentHostImage":
        """Fix the byte count once the image is filled (the residency
        manager accounts it at admission to the host tier)."""
        self._nbytes = (
            sum(_nbytes(t) for tree in self.columns.values()
                for t in tree.values())
            + sum(_nbytes(w) for w, _ in self.packed.values())
            + sum(_nbytes(v) for v in self.values.values())
            + sum(_nbytes(t) for tree in self.startree.values()
                  for t in tree.values()))
        return self

    def empty(self) -> bool:
        return not (self.columns or self.packed or self.values
                    or self.startree)

    def matches(self, segment) -> bool:
        """A reloaded segment (same name, new object) is never served a
        stale image."""
        return segment is not None and self._segment_ref() is segment

    def nbytes(self) -> int:
        return self._nbytes

    def release(self) -> None:
        self.columns.clear()
        self.packed.clear()
        self.values.clear()
        self.startree.clear()
        self._nbytes = 0


class StagedSegment:
    """Device image of one segment, staged column by column on demand;
    with ``host_image``, promoted from the host tier where the image holds
    the array."""

    def __init__(self, segment: ImmutableSegment,
                 device: Union[str, torch.device] = "cuda",
                 host_image: Optional[SegmentHostImage] = None,
                 borrower: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.segment = segment
        self.num_docs = segment.num_docs
        self.capacity = segment.padded_capacity
        self._host_image = host_image
        # ``borrower(segment, name)`` -> a StagedColumn from a resident
        # batch's device copy, or None
        self._borrower = borrower
        # reads are lock-free dict gets; builds, promotions and release
        # hold the lock
        self._lock = threading.RLock()
        self._packed: Dict[str, PackedColumn] = {}
        self._values: Dict[str, torch.Tensor] = {}
        self._columns: Dict[str, StagedColumn] = {}
        self._num_docs: Optional[torch.Tensor] = None
        self._index_slices: "OrderedDict[Hashable, torch.Tensor]" = \
            OrderedDict()
        self._startree: Dict[int, Dict[str, torch.Tensor]] = {}
        self._copies = H2DCopies(self.device)
        # device bytes held, kept with every insertion and removal (the
        # residency manager reads it at each stage and query)
        self._bytes = 0

    @property
    def provider(self) -> ImmutableSegment:
        """What the planner and the scan's eligibility rules read."""
        return self.segment

    def num_docs_tensor(self) -> torch.Tensor:
        """``[num_docs]`` int64 on the device: the scan's input for a batch
        of one segment, uploaded once."""
        if self._num_docs is None:
            with self._lock:
                if self._num_docs is None:
                    self._num_docs = torch.tensor(
                        [self.num_docs], dtype=torch.int64,
                        device=self.device)
                    self._bytes += 8
        return self._num_docs

    def scan_capacity(self) -> int:
        """Doc capacity padded up to whole tiles (the kernel masks the
        tail past ``num_docs``); the JAX package's ``pallas_capacity``."""
        return -(-self.capacity // TILE) * TILE

    # -- promotion from the host image ---------------------------------------
    @property
    def promoted_bytes(self) -> int:
        """Bytes restored from the host image so far."""
        return self._copies.bytes

    def _restore(self, h: torch.Tensor) -> torch.Tensor:
        return self._copies.restore(h)

    def _promote(self, table: str, key):
        """Pop ``key`` of the host image's ``table``, or None."""
        img = self._host_image
        if img is None:
            return None
        return getattr(img, table).pop(key, None)

    # -- staging -------------------------------------------------------------
    def packed_column(self, name: str) -> Optional[PackedColumn]:
        pc = self._packed.get(name)
        if pc is not None:
            return pc
        with self._lock:
            pc = self._packed.get(name)
            if pc is None:
                hp = self._promote("packed", name)
                if hp is not None:
                    pc = PackedColumn(self._restore(hp[0]), hp[1])
                else:
                    pc = self._pack(name)
                    if pc is None:
                        return None
                self._packed[name] = pc
                self._bytes += _nbytes(pc.words)
        return pc

    def _pack(self, name: str) -> Optional[PackedColumn]:
        cm = self.segment.metadata.column(name)
        if not (cm.has_dictionary and cm.single_value):
            return None
        bits = pack_bits(max(1, max(cm.cardinality - 1, 1).bit_length()))
        ids = np.zeros(self.scan_capacity(), dtype=np.uint32)
        fwd = np.asarray(self.segment.data_source(name).forward_index)
        ids[:fwd.shape[0]] = fwd
        words = pack_planar(ids, bits).view(np.int32)
        return PackedColumn(torch.from_numpy(words).to(self.device), bits)

    def value_column(self, name: str) -> Optional[torch.Tensor]:
        """Per-doc values [scan_capacity] of a single-value numeric column,
        dictionary or raw: f32 for float columns, i32 or i64 for integer
        columns (``staged_int_dtype``)."""
        v = self._values.get(name)
        if v is not None:
            return v
        with self._lock:
            v = self._values.get(name)
            if v is None:
                hv = self._promote("values", name)
                v = (self._restore(hv) if hv is not None
                     else self._decode_values(name))
                if v is None:
                    return None
                self._values[name] = v
                self._bytes += _nbytes(v)
        return v

    def _decode_values(self, name: str) -> Optional[torch.Tensor]:
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
        return torch.from_numpy(vals).to(self.device)

    def column(self, name: str) -> StagedColumn:
        """The general rung's arrays of a column."""
        sc = self._columns.get(name)
        if sc is not None:
            return sc
        with self._lock:
            sc = self._columns.get(name)
            if sc is None:
                if self._borrower is not None:
                    sc = self._borrower(self.segment, name)
                if sc is None:
                    hc = self._promote("columns", name)
                    sc = (StagedColumn(**{k: self._restore(v)
                                          for k, v in hc.items()})
                          if hc is not None else self._stage(name))
                self._columns[name] = sc
                self._bytes += sc.nbytes()
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
        first out past ``INDEX_SLICE_CAP``. Never demoted: one upload
        rebuilds it."""
        with self._lock:
            arr = self._index_slices.get(key)
            if arr is not None:
                self._index_slices.move_to_end(key)
                return arr
            arr = torch.from_numpy(np.ascontiguousarray(build())).to(
                self.device)
            self._index_slices[key] = arr
            self._bytes += _nbytes(arr)
            while len(self._index_slices) > INDEX_SLICE_CAP:
                self._bytes -= _nbytes(
                    self._index_slices.popitem(last=False)[1])
        return arr

    def startree_nodes(self, tree_index: int) -> Dict[str, torch.Tensor]:
        """Star-tree ``tree_index``'s record columns on the device, keyed
        as the node plan reads them (``plan.startree_dim_key`` /
        ``startree_metric_key``): int32 dictIds per split dimension (STAR
        = -1), int64 counts and float64 values per pair. Staged once (or
        promoted from the host image); a repeated query uploads none."""
        key = int(tree_index)
        t = self._startree.get(key)
        if t is not None:
            return t
        with self._lock:
            t = self._startree.get(key)
            if t is None:
                ht = self._promote("startree", key)
                t = ({k: self._restore(v) for k, v in ht.items()}
                     if ht is not None else self._stage_startree(key))
                self._startree[key] = t
                self._bytes += sum(_nbytes(a) for a in t.values())
        return t

    def _stage_startree(self, key: int) -> Dict[str, torch.Tensor]:
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
        return t

    def release_startree(self, tree_index: int) -> int:
        """Drop one tree's device columns, its siblings staying; -> the
        device bytes released."""
        with self._lock:
            t = self._startree.pop(int(tree_index), None)
            freed = 0 if t is None else sum(_nbytes(a) for a in t.values())
            self._bytes -= freed
        return freed

    def startree_nbytes(self) -> Dict[int, int]:
        """Device bytes per staged tree."""
        return {ti: sum(_nbytes(a) for a in t.values())
                for ti, t in list(self._startree.items())}

    def index_nbytes(self) -> int:
        """Device bytes of the resident docId arrays."""
        return sum(_nbytes(a) for a in list(self._index_slices.values()))

    def nbytes(self) -> int:
        """Device bytes this segment holds (what the residency manager
        accounts)."""
        return self._bytes

    def demote(self) -> Optional[SegmentHostImage]:
        """Copy every device array into a host image, wait for the copies,
        then release the device arrays (JAX ``demote`` :588). Arrays of
        this segment's own promotion image not yet promoted carry over, so
        a demote after a promote loses nothing. None when nothing was
        staged. The docId arrays of the index rung are not kept."""
        with self._lock:
            img = SegmentHostImage(self.segment)
            for name, sc in self._columns.items():
                img.columns[name] = {k: to_host(v)
                                     for k, v in sc.tree().items()}
            for name, pc in self._packed.items():
                img.packed[name] = (to_host(pc.words), pc.bits)
            for name, v in self._values.items():
                img.values[name] = to_host(v)
            for ti, tree in self._startree.items():
                img.startree[ti] = {k: to_host(v) for k, v in tree.items()}
            if self.device.type == "cuda":
                # the host copies are complete before anything reads them
                # or the device arrays are dropped
                torch.cuda.current_stream(self.device).synchronize()
            src = self._host_image
            if src is not None:
                for table in ("columns", "packed", "values", "startree"):
                    mine = getattr(img, table)
                    for k, v in getattr(src, table).items():
                        mine.setdefault(k, v)
                src.release()
                self._host_image = None
            self._drop_locked()
        return None if img.empty() else img.seal()

    def release(self) -> None:
        """Drop every device array and what is left of the host image (JAX
        ``release`` :632); locked against in-flight builds, so none lands
        in a released segment."""
        with self._lock:
            img = self._host_image
            if img is not None:
                img.release()
                self._host_image = None
            self._drop_locked()

    def _drop_locked(self) -> None:
        self._copies.wait()
        self._packed.clear()
        self._values.clear()
        self._columns.clear()
        self._index_slices.clear()
        self._startree.clear()
        self._num_docs = None
        self._bytes = 0
