"""Carry segments across as plain arrays.

``segment_from_arrays`` builds a port segment from per-column numpy arrays:
the sorted dictionary values, the dictIds, the data and field types. It
plays the role weights play in a model port: the tests take these arrays
out of a segment the JAX package built (``columns_of`` reads any segment
with the ``metadata.columns`` / ``data_source(c).dictionary`` /
``forward_index`` interface), so both packages scan identical data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

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
    data_type: DataType
    field_type: FieldType
    dictionary: np.ndarray      # sorted unique values
    dict_ids: np.ndarray        # [num_docs] or [padded_capacity] dictIds
    min_value: Any = None       # stats; derived from the dictionary if None
    max_value: Any = None


def _narrow_id_dtype(cardinality: int) -> np.dtype:
    if cardinality <= (1 << 8):
        return np.dtype(np.uint8)
    if cardinality <= (1 << 16):
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def segment_from_arrays(name: str, num_docs: int,
                        columns: Mapping[str, ColumnArrays],
                        table_name: Optional[str] = None) -> ImmutableSegment:
    capacity = pad_capacity(num_docs)
    table = table_name or name
    schema = Schema(table, [FieldSpec(c, a.data_type, a.field_type)
                            for c, a in columns.items()])
    metas: Dict[str, ColumnMetadata] = {}
    sources: Dict[str, DataSource] = {}
    for col, a in columns.items():
        d = build_dictionary(a.dictionary, a.data_type)
        card = d.cardinality
        ids = np.asarray(a.dict_ids)
        if ids.shape[0] not in (num_docs, capacity):
            raise ValueError(f"column {col!r}: {ids.shape[0]} dictIds for "
                             f"{num_docs} docs")
        live = ids[:num_docs]
        if num_docs and (int(live.min()) < 0 or int(live.max()) >= card):
            raise ValueError(f"column {col!r}: dictId outside [0, {card})")
        fwd = np.zeros(capacity, dtype=_narrow_id_dtype(card))
        fwd[:num_docs] = live
        lo = d.min_value if card else None
        hi = d.max_value if card else None
        for given, derived, what in ((a.min_value, lo, "min"),
                                     (a.max_value, hi, "max")):
            if given is not None and given != derived:
                raise ValueError(f"column {col!r}: {what} stat {given!r} "
                                 f"disagrees with the dictionary ({derived!r})")
        cm = ColumnMetadata(name=col, data_type=a.data_type,
                            field_type=a.field_type, cardinality=card,
                            min_value=lo, max_value=hi)
        metas[col] = cm
        sources[col] = DataSource(col, cm, d, fwd)
    md = SegmentMetadata(segment_name=name, table_name=table, schema=schema,
                         num_docs=num_docs, padded_capacity=capacity,
                         columns=metas)
    return ImmutableSegment(md, sources)


def columns_of(segment) -> Dict[str, ColumnArrays]:
    """Per-column arrays of a dictionary-encoded single-value segment (a
    port segment or one loaded by the JAX package)."""
    out: Dict[str, ColumnArrays] = {}
    for col, cm in segment.metadata.columns.items():
        if not (cm.has_dictionary and cm.single_value):
            raise ValueError(f"column {col!r} is not a dictionary-encoded "
                             "single-value column")
        ds = segment.data_source(col)
        dt = DataType.from_string(cm.data_type.label)
        vals = ds.dictionary.get_values(range(cm.cardinality))
        out[col] = ColumnArrays(
            data_type=dt, field_type=FieldType(cm.field_type.value),
            dictionary=np.asarray(vals, dtype=dt.stored_np
                                  if dt.is_numeric else np.str_),
            dict_ids=np.asarray(ds.forward_index)[:segment.num_docs],
            min_value=cm.min_value, max_value=cm.max_value)
    return out
