"""Carry segments across as plain arrays.

``segment_from_arrays`` builds a port segment from per-column numpy arrays:
a dictionary column's sorted values and dictIds (dense dictIds plus counts
per row for a multi-value column), a raw column's values, a null bitmap,
and the segment's upsert valid-doc snapshot. It plays the role weights play
in a model port: the tests take these arrays out of a segment the JAX
package built (``columns_of`` reads any segment with the
``metadata.columns`` / ``data_source(c)`` interface: ``dictionary``,
``forward_index``, ``dense_mv()``, ``null_bitmap``), so both packages scan
identical data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from pinot_tpu_torch.segment.dictionary import build_dictionary
from pinot_tpu_torch.segment.immutable import DataSource, ImmutableSegment
from pinot_tpu_torch.segment.metadata import (
    ColumnMetadata,
    SegmentMetadata,
    pad_capacity,
)
from pinot_tpu_torch.spi.data import DataType, FieldSpec, FieldType, Schema


@dataclass
class ColumnArrays:
    """One column's arrays, each ``num_docs`` (or ``padded_capacity``) rows.

    - dictionary column: ``dictionary`` (sorted unique values) and
      ``dict_ids`` ([rows] dictIds; for a multi-value column the dense
      [rows, max values] dictIds, zero past each row's ``mv_counts``);
    - raw single-value numeric column: ``values``, no dictionary;
    - ``null``: [rows] bool, the rows that are null (they hold the null
      default value).
    ``min_value`` / ``max_value`` are checked against the data when given;
    ``partition_function``, ``num_partitions`` and ``partitions`` are the
    column's partition metadata, carried as given.
    """

    data_type: DataType
    field_type: FieldType
    dictionary: Optional[np.ndarray] = None
    dict_ids: Optional[np.ndarray] = None
    min_value: Any = None
    max_value: Any = None
    values: Optional[np.ndarray] = None
    mv_counts: Optional[np.ndarray] = None
    null: Optional[np.ndarray] = None
    partition_function: Optional[str] = None
    num_partitions: int = 0
    partitions: Optional[List[int]] = None


def _narrow_id_dtype(cardinality: int) -> np.dtype:
    if cardinality <= (1 << 8):
        return np.dtype(np.uint8)
    if cardinality <= (1 << 16):
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def _rows(col: str, arr: np.ndarray, num_docs: int, capacity: int
          ) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.shape[0] not in (num_docs, capacity):
        raise ValueError(f"column {col!r}: {arr.shape[0]} rows for "
                         f"{num_docs} docs")
    return arr[:num_docs]


def _padded(live: np.ndarray, capacity: int, dtype) -> np.ndarray:
    out = np.zeros((capacity,) + live.shape[1:], dtype=dtype)
    out[:live.shape[0]] = live
    return out


def _column(col: str, a: ColumnArrays, num_docs: int, capacity: int
            ) -> DataSource:
    null = None
    if a.null is not None:
        null = _padded(_rows(col, a.null, num_docs, capacity).astype(bool),
                       capacity, bool)
    mv_counts = None
    max_mv = 0
    if a.dictionary is None:
        if a.values is None or a.mv_counts is not None \
                or not a.data_type.is_numeric:
            raise ValueError(f"column {col!r}: a raw column is single-value "
                             "numeric values")
        live = _rows(col, a.values, num_docs, capacity).astype(
            a.data_type.stored_np)
        d = None
        card = int(np.unique(live).shape[0])
        lo = live.min().item() if num_docs else None
        hi = live.max().item() if num_docs else None
        fwd = _padded(live, capacity, live.dtype)
    else:
        d = build_dictionary(a.dictionary, a.data_type)
        card = d.cardinality
        ids = _rows(col, a.dict_ids, num_docs, capacity)
        if a.mv_counts is None:
            entries = ids
            fwd = _padded(ids, capacity, _narrow_id_dtype(card))
        else:
            counts = _rows(col, a.mv_counts, num_docs, capacity).astype(
                np.int32)
            max_mv = int(counts.max()) if num_docs else 0
            ids = ids[:, :max(max_mv, 1)]
            entries = ids[np.arange(ids.shape[1])[None, :] < counts[:, None]]
            fwd = _padded(ids, capacity, np.int32)
            mv_counts = _padded(counts, capacity, np.int32)
        if entries.size and (int(entries.min()) < 0
                             or int(entries.max()) >= card):
            raise ValueError(f"column {col!r}: dictId outside [0, {card})")
        lo = d.min_value if card else None
        hi = d.max_value if card else None
    for given, derived, what in ((a.min_value, lo, "min"),
                                 (a.max_value, hi, "max")):
        if given is not None and given != derived:
            raise ValueError(f"column {col!r}: {what} stat {given!r} "
                             f"disagrees with the data ({derived!r})")
    cm = ColumnMetadata(
        name=col, data_type=a.data_type, field_type=a.field_type,
        cardinality=card, min_value=lo, max_value=hi,
        has_dictionary=d is not None, single_value=a.mv_counts is None,
        has_nulls=bool(null is not None and null.any()),
        max_num_multi_values=max_mv,
        partition_function=a.partition_function,
        num_partitions=a.num_partitions,
        partitions=list(a.partitions or []))
    return DataSource(col, cm, d, fwd, mv_counts,
                      null if cm.has_nulls else None)


def segment_from_arrays(name: str, num_docs: int,
                        columns: Mapping[str, ColumnArrays],
                        table_name: Optional[str] = None,
                        valid_doc_ids: Optional[np.ndarray] = None
                        ) -> ImmutableSegment:
    """``valid_doc_ids`` ([num_docs] bool) makes the segment
    upsert-managed: only its true docs are live."""
    capacity = pad_capacity(num_docs)
    table = table_name or name
    schema = Schema(table, [FieldSpec(c, a.data_type, a.field_type,
                                      single_value=a.mv_counts is None)
                            for c, a in columns.items()])
    sources = {col: _column(col, a, num_docs, capacity)
               for col, a in columns.items()}
    md = SegmentMetadata(segment_name=name, table_name=table, schema=schema,
                         num_docs=num_docs, padded_capacity=capacity,
                         columns={c: ds.metadata for c, ds in sources.items()})
    seg = ImmutableSegment(md, sources)
    if valid_doc_ids is not None:
        seg.valid_doc_ids = _rows("valid_doc_ids", valid_doc_ids, num_docs,
                                  capacity).astype(bool)
    return seg


def columns_of(segment) -> Dict[str, ColumnArrays]:
    """Per-column arrays of a segment (a port segment or one loaded by the
    JAX package), in the order of its schema's fields."""
    n = segment.num_docs
    out: Dict[str, ColumnArrays] = {}
    # in the schema's field order, which ``SELECT *`` lists
    order = {c: i for i, c in
             enumerate(segment.metadata.schema.column_names)}
    for col, cm in sorted(segment.metadata.columns.items(),
                          key=lambda kv: order.get(kv[0], len(order))):
        ds = segment.data_source(col)
        dt = DataType.from_string(cm.data_type.label)
        a = ColumnArrays(data_type=dt,
                         field_type=FieldType(cm.field_type.value),
                         min_value=cm.min_value, max_value=cm.max_value,
                         partition_function=cm.partition_function,
                         num_partitions=cm.num_partitions,
                         partitions=list(cm.partitions))
        if not cm.has_dictionary:
            a.values = np.asarray(ds.forward_index)[:n]
        else:
            a.dictionary = np.asarray(
                ds.dictionary.get_values(range(cm.cardinality)),
                dtype=dt.stored_np if dt.is_numeric else np.str_)
            if cm.single_value:
                a.dict_ids = np.asarray(ds.forward_index)[:n]
            else:
                dense, counts = ds.dense_mv()
                a.dict_ids = np.asarray(dense)[:n]
                a.mv_counts = np.asarray(counts)[:n]
        if ds.null_bitmap is not None:
            a.null = np.asarray(ds.null_bitmap)[:n]
        out[col] = a
    return out
