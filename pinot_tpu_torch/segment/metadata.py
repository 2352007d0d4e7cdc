"""Segment and column metadata.

Counterpart of ``pinot_tpu/segment/metadata.py``: what the planner needs
without touching column data. ``padded_capacity`` is the doc count rounded
up to ``DOC_TILE``, as the JAX package pads it, so plans carry the same
capacity on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.spi.data import DataType, FieldType, Schema

DOC_TILE = 1024


def pad_capacity(num_docs: int) -> int:
    return max(DOC_TILE, ((num_docs + DOC_TILE - 1) // DOC_TILE) * DOC_TILE)


@dataclass
class ColumnMetadata:
    """``has_dictionary=False`` is a raw (RAW-encoded) single-value numeric
    column: its forward index holds the values and ``cardinality`` counts
    its distinct values. A multi-value column holds up to
    ``max_num_multi_values`` values a row. A partitioned column names its
    partition function, the partition count and the partitions its values
    fall in (the segment pruner reads them).

    ``is_sorted``: the column's dictIds (a raw column's values) never
    decrease over the docs, computed for every single-value column as the
    JAX creator computes it (a multi-value column is never sorted). The
    ``has_*`` flags name the indexes the segment was built with
    (``spi/table.py`` ``IndexingConfig``)."""

    name: str
    data_type: DataType
    field_type: FieldType
    cardinality: int
    min_value: Any = None
    max_value: Any = None
    has_dictionary: bool = True
    single_value: bool = True
    has_nulls: bool = False
    max_num_multi_values: int = 0
    partition_function: Optional[str] = None
    num_partitions: int = 0
    partitions: List[int] = field(default_factory=list)
    is_sorted: bool = False
    has_inverted_index: bool = False
    has_range_index: bool = False
    has_bloom_filter: bool = False
    has_fst_index: bool = False
    has_text_index: bool = False
    has_json_index: bool = False


@dataclass
class SegmentMetadata:
    segment_name: str
    table_name: str
    schema: Schema
    num_docs: int
    padded_capacity: int
    columns: Dict[str, ColumnMetadata] = field(default_factory=dict)
    # star-trees built with the segment, and each one's build seconds
    star_tree_count: int = 0
    star_tree_build_s: List[float] = field(default_factory=list)
    # free-form properties: a sealed realtime segment's stream offsets and
    # partition (``segment.realtime.startOffset`` / ``endOffset`` /
    # ``partition``)
    custom: Dict[str, Any] = field(default_factory=dict)

    def column(self, name: str) -> ColumnMetadata:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in segment "
                           f"{self.segment_name!r}") from None
