"""Mutable (consuming) segment: rows indexed one at a time, queryable
while they arrive.

Counterpart of ``pinot_tpu/segment/mutable.py``: one writer thread indexes
rows into append-only column stores (``index``); readers take the doc
count (``num_docs``) first and read that prefix, which the writer never
changes (it publishes a row's count last). Dictionaries assign ids in
arrival order (``MutableDictionary``), so a staged prefix of ids and
values stays valid as the dictionary grows, and a range predicate scans
the values (``matching_range_ids``) where a sorted dictionary gives an
id interval.

Reads present the port's layout (``segment/immutable.py``): a
single-value column's ``forward_index`` holds dictIds, a multi-value
column's the dense ``[rows, max values]`` dictIds with ``mv_counts``
(built from the writer's flat ids and offsets when read), ``null_bitmap``
the null rows. A consuming segment has no index; the device serves it
through ``engine/mutable_staging.py`` and the host engine reads it here.
``build_immutable`` seals it into an in-memory ``ImmutableSegment``
through the port's ``SegmentBuilder`` (on-disk segments are not ported).
"""

from __future__ import annotations

import threading
import time

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.segment import metadata as meta
from pinot_tpu_torch.segment.creator import SegmentBuilder
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.spi.data import DataType, FieldSpec, Schema
from pinot_tpu_torch.spi.table import IndexingConfig
from pinot_tpu_torch.utils.hll import dictionary_register_luts

_GROW = 2
_INITIAL_CAPACITY = 1024


class MutableDictionary:
    """value -> dictId in arrival order (not sorted). ``index`` is the
    writer's get-or-insert; the rest reads."""

    def __init__(self, data_type: DataType):
        self.data_type = data_type
        self._index: Dict[Any, int] = {}
        self._values: List[Any] = []
        self._min: Any = None
        self._max: Any = None
        # (cardinality, values array) of the last ``values`` read
        self._array: Tuple[int, Optional[np.ndarray]] = (0, None)
        self._hll_luts: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self._values)

    @property
    def cardinality(self) -> int:
        return len(self._values)

    def index(self, value: Any) -> int:
        """Get-or-insert (writer thread only)."""
        i = self._index.get(value)
        if i is None:
            i = len(self._values)
            self._values.append(value)
            self._index[value] = i
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
        return i

    def index_of(self, value: Any) -> int:
        return self._index.get(value, -1)

    def get_value(self, dict_id: int) -> Any:
        return self._values[int(dict_id)]

    def get_values(self, dict_ids: Sequence[int]) -> List[Any]:
        return [self._values[int(i)] for i in dict_ids]

    @property
    def values(self) -> np.ndarray:
        """The values by dictId: numeric in the stored dtype, strings as a
        numpy unicode array. Later inserts append, so an array read at
        cardinality ``k`` stays right for ids below ``k``."""
        n = len(self._values)
        got_n, arr = self._array
        if arr is None or got_n != n:
            vals = self._values[:n]
            arr = (np.asarray(vals, dtype=self.data_type.stored_np)
                   if self.data_type.is_numeric
                   else np.asarray(vals, dtype=np.str_))
            self._array = (n, arr)
        return arr

    @property
    def min_value(self) -> Any:
        return self._min

    @property
    def max_value(self) -> Any:
        return self._max

    def device_values(self) -> Optional[np.ndarray]:
        return self.values if self.data_type.is_numeric else None

    def hll_register_luts(self, log2m: int) -> Tuple[np.ndarray, np.ndarray]:
        """Memoized per log2m as the sorted dictionary's are: stale once
        the dictionary grows, so the consuming rung declines HLL
        (``mutable_hll_lut_unstable``)."""
        luts = self._hll_luts.get(log2m)
        if luts is None:
            luts = dictionary_register_luts(self.get_values(range(len(self))),
                                            log2m)
            self._hll_luts[log2m] = luts
        return luts

    def matching_range_ids(self, lo: Any, hi: Any, lo_inclusive: bool,
                           hi_inclusive: bool) -> np.ndarray:
        """The ascending dictIds whose values lie in the range: a scan of
        the unsorted values (JAX :83)."""
        if self.data_type.is_numeric:
            vals = self.values
            m = np.ones(len(vals), dtype=bool)
            if lo is not None:
                m &= (vals >= lo) if lo_inclusive else (vals > lo)
            if hi is not None:
                m &= (vals <= hi) if hi_inclusive else (vals < hi)
            return np.nonzero(m)[0].astype(np.int64)
        ids = []
        for i, v in enumerate(self._values[:len(self._values)]):
            if lo is not None and not (v >= lo if lo_inclusive else v > lo):
                continue
            if hi is not None and not (v <= hi if hi_inclusive else v < hi):
                continue
            ids.append(i)
        return np.asarray(ids, dtype=np.int64)

    def range_to_dict_id_interval(self, lo, hi, lo_inclusive, hi_inclusive):
        raise TypeError("mutable dictionaries are unsorted; "
                        "use matching_range_ids")


class _GrowArray:
    """Append-only numpy array, capacity doubling (a reader's view of a
    prefix stays valid: a regrowth copies into a new array)."""

    def __init__(self, dtype):
        self._arr = np.zeros(_INITIAL_CAPACITY, dtype=dtype)
        self._n = 0

    def append(self, v) -> None:
        if self._n == self._arr.shape[0]:
            bigger = np.zeros(self._arr.shape[0] * _GROW,
                              dtype=self._arr.dtype)
            bigger[:self._n] = self._arr
            self._arr = bigger
        self._arr[self._n] = v
        self._n += 1

    def view(self, n: Optional[int] = None) -> np.ndarray:
        return self._arr[:self._n if n is None else n]


class _MutableColumn:
    def __init__(self, fs: FieldSpec):
        self.fs = fs
        self.single_value = fs.single_value
        self.convert = fs.data_type.converter
        self.dictionary = MutableDictionary(fs.data_type)
        # single-value: dictIds; multi-value: flat dictIds and offsets
        self.fwd = _GrowArray(np.int32)
        self.mv_offsets = _GrowArray(np.int64) if not fs.single_value \
            else None
        if self.mv_offsets is not None:
            self.mv_offsets.append(0)
        self.null = _GrowArray(bool)
        self.has_nulls = False
        self.max_mv = 0


def _dense_rows(flat: np.ndarray, offsets: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat ids and ``[n + 1]`` offsets -> (dense [n, max(max count, 1)]
    int32 ids, zero past each row's count; counts [n] int32)."""
    counts = np.diff(offsets).astype(np.int32)
    n = counts.shape[0]
    width = max(int(counts.max(initial=0)), 1)
    dense = np.zeros((n, width), dtype=np.int32)
    total = int(offsets[-1] - offsets[0])
    if total:
        rows = np.repeat(np.arange(n), counts)
        cols = (np.arange(total, dtype=np.int64)
                - np.repeat(offsets[:-1] - offsets[0], counts))
        dense[rows, cols] = flat[int(offsets[0]):int(offsets[-1])]
    return dense, counts


class MutableDataSource:
    """One column's first ``n`` rows in the port's read layout."""

    inverted_index = None
    range_order = None
    range_sorted_values = None
    bloom_filter = None
    fst_index = None
    text_index = None
    json_index = None

    def __init__(self, seg: "MutableSegment", col: _MutableColumn, n: int):
        self.name = col.fs.name
        self._col = col
        self._n = n
        self.metadata = seg._column_metadata(col, n)
        self.dictionary: MutableDictionary = col.dictionary
        self._dense: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def forward_index(self) -> np.ndarray:
        if self._col.mv_offsets is None:
            return self._col.fwd.view(self._n)
        return self.dense_mv()[0]

    @property
    def mv_counts(self) -> Optional[np.ndarray]:
        if self._col.mv_offsets is None:
            return None
        return self.dense_mv()[1]

    @property
    def null_bitmap(self) -> Optional[np.ndarray]:
        if not self._col.has_nulls:
            return None
        return self._col.null.view(self._n)

    def dense_mv(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._col.mv_offsets is None:
            raise ValueError(f"column {self.name!r} is single-value")
        if self._dense is None:
            off = self._col.mv_offsets.view(self._n + 1)
            self._dense = _dense_rows(self._col.fwd.view(int(off[-1])), off)
        return self._dense


class MutableSegment:
    """One writer calls ``index``; readers snapshot ``num_docs`` and read
    that prefix. ``valid_doc_ids`` is set for an upsert table
    (``segment/upsert.py``); a consuming segment has no star-tree."""

    is_mutable = True

    #: the key under which the null transformer lists a row's null fields
    #: (it substitutes default values, so nullness rides along)
    NULL_FIELDS_KEY = "__nulls__"

    def __init__(self, schema: Schema, segment_name: str,
                 capacity: int = 1_000_000,
                 indexing_config: Optional[IndexingConfig] = None):
        self.schema = schema
        self.segment_name = segment_name
        self.capacity = capacity
        self.indexing = indexing_config or IndexingConfig()
        self._cols: Dict[str, _MutableColumn] = {
            fs.name: _MutableColumn(fs) for fs in schema.field_specs}
        self._num_docs = 0
        self.valid_doc_ids = None
        self.star_trees: List[Any] = []
        # per row, the monotonic clock when it was indexed (ingest to
        # queryable latency is measured from it)
        self._append_ts = _GrowArray(np.float64)
        # rows whose freshness was recorded already
        # (engine/mutable_staging.py observe_freshness)
        self._fresh_observed = 0
        self._fresh_lock = threading.Lock()

    # -- write path -----------------------------------------------------------
    def index(self, row: Dict[str, Any]) -> bool:
        """Index one transformed row; False when the segment is at
        capacity."""
        if self._num_docs >= self.capacity:
            return False
        null_fields = row.get(self.NULL_FIELDS_KEY) or ()
        for name, col in self._cols.items():
            v = row.get(name)
            if col.single_value and v is not None and v == v \
                    and name not in null_fields:
                # the common case: a present single-value value
                col.null.append(False)
                col.fwd.append(col.dictionary.index(col.convert(v)))
            else:
                self._index_value(col, v, name in null_fields)
        self._append_ts.append(time.monotonic())
        # publish the row last: readers snapshot _num_docs
        self._num_docs += 1
        return True

    @staticmethod
    def _index_value(col: _MutableColumn, v: Any,
                     declared_null: bool) -> None:
        fs = col.fs
        is_null = (declared_null or v is None
                   or (isinstance(v, float) and v != v))
        if fs.single_value:
            if is_null:
                col.has_nulls = True
                if v is None or v != v:
                    v = fs.default_null_value
            col.null.append(is_null)
            col.fwd.append(col.dictionary.index(col.convert(v)))
            return
        if is_null or (isinstance(v, (list, tuple, np.ndarray))
                       and len(v) == 0):
            is_null = True
            col.has_nulls = True
            vals = ([fs.default_null_value] if v is None
                    or not isinstance(v, (list, tuple, np.ndarray))
                    or not len(v) else list(v))
        elif isinstance(v, (list, tuple, np.ndarray)):
            vals = list(v)
        else:
            vals = [v]
        col.null.append(is_null)
        for x in vals:
            col.fwd.append(col.dictionary.index(col.convert(x)))
        col.mv_offsets.append(int(col.mv_offsets.view()[-1]) + len(vals))
        col.max_mv = max(col.max_mv, len(vals))

    # -- read path ------------------------------------------------------------
    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def padded_capacity(self) -> int:
        return meta.pad_capacity(self._num_docs)

    @property
    def metadata(self) -> meta.SegmentMetadata:
        n = self._num_docs
        return meta.SegmentMetadata(
            segment_name=self.segment_name,
            table_name=self.schema.schema_name, schema=self.schema,
            num_docs=n, padded_capacity=meta.pad_capacity(n),
            columns=_SnapshotColumns(self, n))

    def data_source(self, column: str) -> MutableDataSource:
        col = self._cols.get(column)
        if col is None:
            raise KeyError(f"column {column!r} not in segment "
                           f"{self.segment_name!r}")
        return MutableDataSource(self, col, self._num_docs)

    def _column_metadata(self, col: _MutableColumn, n: int
                         ) -> meta.ColumnMetadata:
        d = col.dictionary
        return meta.ColumnMetadata(
            name=col.fs.name, data_type=col.fs.data_type,
            field_type=col.fs.field_type, cardinality=len(d),
            min_value=d.min_value, max_value=d.max_value,
            has_dictionary=True, single_value=col.fs.single_value,
            has_nulls=col.has_nulls, max_num_multi_values=col.max_mv)

    # -- seal -----------------------------------------------------------------
    def build_immutable(self, segment_name: Optional[str] = None,
                        indexing_config: Optional[IndexingConfig] = None
                        ) -> ImmutableSegment:
        """The first ``num_docs`` rows as an in-memory immutable segment
        (sorted dictionaries, the indexes and star-trees of
        ``indexing_config``, default the consuming-time config), built by
        the port's ``SegmentBuilder`` from the columns' values (JAX
        :338, which builds on disk)."""
        n = self._num_docs
        frame: Dict[str, Any] = {}
        for name, col in self._cols.items():
            ds = MutableDataSource(self, col, n)
            d = col.dictionary
            vals = d.values
            nulls = ds.null_bitmap
            if col.fs.single_value:
                rows = vals[np.asarray(ds.forward_index)]
                if nulls is not None and nulls.any():
                    rows = [None if z else v
                            for v, z in zip(rows.tolist(), nulls.tolist())]
                frame[name] = rows
            else:
                dense, counts = ds.dense_mv()
                counts = counts.copy()
                if nulls is not None:
                    counts[nulls] = 0   # the builder's null MV row
                frame[name] = (vals[dense], counts)
        builder = SegmentBuilder(self.schema, segment_name or self.segment_name,
                                 indexing=indexing_config or self.indexing)
        return builder.build(frame)


class _SnapshotColumns(dict):
    """Column metadata at one doc-count snapshot, made on first read."""

    def __init__(self, seg: MutableSegment, n: int):
        super().__init__()
        self._seg = seg
        self._n = n
        for name in seg._cols:
            dict.__setitem__(self, name, None)

    def __getitem__(self, name: str) -> meta.ColumnMetadata:
        v = dict.__getitem__(self, name)
        if v is None:
            v = self._seg._column_metadata(self._seg._cols[name], self._n)
            dict.__setitem__(self, name, v)
        return v

    def get(self, name: str, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]


def is_mutable(segment) -> bool:
    """Whether ``segment`` is still consuming (its contents advance)."""
    return getattr(segment, "is_mutable", False)


def is_arrival_ordered(dictionary) -> bool:
    """Whether ``dictionary`` numbers its values in arrival order (a
    consuming segment's): a range of values is then a set of dictIds, not
    an interval."""
    return isinstance(dictionary, MutableDictionary)


__all__ = ["MutableDataSource", "MutableDictionary", "MutableSegment",
           "is_arrival_ordered", "is_mutable"]
