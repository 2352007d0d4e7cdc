"""In-memory segment builder from a column frame.

Counterpart of ``pinot_tpu/segment/creator.py`` (``SegmentBuilder``,
``_normalize`` and ``_build_column`` at :297-410): dictionary-encoded
columns, raw columns (``no_dictionary_columns``, single-value numeric
only, as the JAX builder allows), multi-value columns, null handling and
the indexes an ``IndexingConfig`` names (built in memory by
``segment_from_arrays``); the segment lives in memory (no on-disk format
yet).

A frame maps each column to its rows: a numpy array or a list for a
single-value column (``None``, and NaN in a float column, is null); for a
multi-value column a list of lists (``None`` or an empty list is null), or
``(values [n, k], counts [n])``, the dense form a generator draws in one
call. A null row stores the field's default null value (a null MV row the
one-value list of it), and the column's null bitmap marks it.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.segment.convert import ColumnArrays, segment_from_arrays
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.spi.data import FieldSpec, Schema
from pinot_tpu_torch.spi.table import IndexingConfig
from pinot_tpu_torch.utils.partition import get_partition_function


def _is_null(v: Any) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _sv_values(fs: FieldSpec, rows: Sequence[Any]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (values in the stored type, null mask)."""
    dt = fs.data_type
    if isinstance(rows, np.ndarray) and dt.is_numeric \
            and rows.dtype.kind in "iuf":
        nulls = (np.isnan(rows) if rows.dtype.kind == "f"
                 else np.zeros(rows.shape[0], dtype=bool))
        vals = rows.copy() if nulls.any() else rows
        vals[nulls] = fs.default_null_value
        return vals.astype(dt.stored_np), nulls
    if isinstance(rows, np.ndarray) and rows.dtype.kind == "U" \
            and not dt.is_numeric:
        return rows, np.zeros(rows.shape[0], dtype=bool)
    nulls = np.fromiter((_is_null(v) for v in rows), dtype=bool,
                        count=len(rows))
    vals = [fs.default_null_value if n else dt.convert(v)
            for v, n in zip(rows, nulls)]
    return np.asarray(vals, dtype=dt.stored_np if dt.is_numeric
                      else np.str_), nulls


def _mv_values(fs: FieldSpec, rows: Any
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (dense values [n, k], counts [n], null mask)."""
    dt = fs.data_type
    np_dt = dt.stored_np if dt.is_numeric else np.str_
    if isinstance(rows, tuple):
        dense, counts = np.asarray(rows[0]), np.asarray(rows[1], np.int32)
        nulls = counts == 0
        if nulls.any():
            dense = dense.astype(np_dt)
            dense[nulls, 0] = fs.default_null_value
            counts = np.where(nulls, 1, counts).astype(np.int32)
        return dense.astype(np_dt), counts, nulls
    lists, nulls = [], np.zeros(len(rows), dtype=bool)
    for i, v in enumerate(rows):
        vals = ([] if v is None or (isinstance(v, float) and v != v)
                else [dt.convert(x) for x in
                      (v if isinstance(v, (list, tuple, np.ndarray)) else [v])
                      if not _is_null(x)])
        if not vals:
            nulls[i] = True
            vals = [fs.default_null_value]
        lists.append(vals)
    counts = np.asarray([len(v) for v in lists], dtype=np.int32)
    dense = np.zeros((len(lists), max(int(counts.max(initial=0)), 1)),
                     dtype=np_dt if dt.is_numeric else object)
    for i, v in enumerate(lists):
        dense[i, :len(v)] = v
    return dense.astype(np_dt), counts, nulls


class SegmentBuilder:
    def __init__(self, schema: Schema, segment_name: str,
                 table_name: Optional[str] = None,
                 no_dictionary_columns: Sequence[str] = (),
                 indexing: Optional[IndexingConfig] = None):
        self.schema = schema
        self.segment_name = segment_name
        self.table_name = table_name or schema.schema_name
        self.indexing = indexing
        self.no_dictionary_columns = set(no_dictionary_columns) | set(
            indexing.no_dictionary_columns if indexing else ())

    def build(self, frame: Mapping[str, Any]) -> ImmutableSegment:
        """One in-memory segment. A column of the indexing config's
        ``segment_partition_config`` records the partitions its values
        fall in (JAX ``SegmentBuilder._partition_meta``)."""
        sizes = {len(frame[c][1]) if isinstance(frame[c], tuple)
                 else len(frame[c]) for c in self.schema.column_names}
        if len(sizes) != 1:
            raise ValueError(f"ragged column lengths: {sorted(sizes)}")
        num_docs = sizes.pop()
        columns = {fs.name: self._partitioned(self._column(fs, frame[fs.name]),
                                              fs.name)
                   for fs in self.schema.field_specs}
        return segment_from_arrays(self.segment_name, num_docs, columns,
                                   table_name=self.table_name,
                                   indexing=self.indexing)

    def _partitioned(self, arrays: ColumnArrays, name: str) -> ColumnArrays:
        spc = self.indexing.segment_partition_config if self.indexing \
            else None
        if spc is None or name not in spc.column_partition_map:
            return arrays
        cfg = spc.column_partition_map[name]
        fn = get_partition_function(cfg.get("functionName", "Murmur"),
                                    int(cfg.get("numPartitions", 1)))
        distinct = (arrays.dictionary if arrays.dictionary is not None
                    else np.unique(arrays.values))
        arrays.partition_function = fn.name
        arrays.num_partitions = fn.num_partitions
        arrays.partitions = sorted({fn.partition(v)
                                    for v in distinct.tolist()})
        return arrays

    def _column(self, fs: FieldSpec, rows: Any) -> ColumnArrays:
        if not fs.single_value:
            dense, counts, nulls = _mv_values(fs, rows)
            valid = np.arange(dense.shape[1])[None, :] < counts[:, None]
            uniq, inv = np.unique(dense[valid], return_inverse=True)
            ids = np.zeros(dense.shape, dtype=np.int32)
            ids[valid] = inv.reshape(-1)
            return ColumnArrays(fs.data_type, fs.field_type, uniq, ids,
                                mv_counts=counts, null=nulls)
        vals, nulls = _sv_values(fs, rows)
        if fs.name in self.no_dictionary_columns and fs.data_type.is_numeric:
            return ColumnArrays(fs.data_type, fs.field_type, values=vals,
                                null=nulls)
        uniq, ids = np.unique(vals, return_inverse=True)
        return ColumnArrays(fs.data_type, fs.field_type, uniq,
                            ids.reshape(-1), null=nulls)
