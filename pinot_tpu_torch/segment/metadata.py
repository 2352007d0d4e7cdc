"""Segment and column metadata.

Counterpart of ``pinot_tpu/segment/metadata.py``: what the planner needs
without touching column data. ``padded_capacity`` is the doc count rounded
up to ``DOC_TILE``, as the JAX package pads it, so plans carry the same
capacity on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

from pinot_tpu_torch.spi.data import DataType, FieldType, Schema

DOC_TILE = 1024


def pad_capacity(num_docs: int) -> int:
    return max(DOC_TILE, ((num_docs + DOC_TILE - 1) // DOC_TILE) * DOC_TILE)


@dataclass
class ColumnMetadata:
    name: str
    data_type: DataType
    field_type: FieldType
    cardinality: int
    min_value: Any = None
    max_value: Any = None
    has_dictionary: bool = True
    single_value: bool = True
    has_nulls: bool = False


@dataclass
class SegmentMetadata:
    segment_name: str
    table_name: str
    schema: Schema
    num_docs: int
    padded_capacity: int
    columns: Dict[str, ColumnMetadata] = field(default_factory=dict)

    def column(self, name: str) -> ColumnMetadata:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in segment "
                           f"{self.segment_name!r}") from None
