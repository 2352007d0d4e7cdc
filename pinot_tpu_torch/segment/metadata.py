"""Segment and column metadata.

Counterpart of ``pinot_tpu/segment/metadata.py``: what the planner needs
without touching column data. ``padded_capacity`` is the doc count rounded
up to ``DOC_TILE``, as the JAX package pads it, so plans carry the same
capacity on both sides.

``to_dict`` / ``from_dict`` / ``save`` / ``load`` are the JAX package's
``metadata.json`` (JAX :58-260), keys and value forms alike, so either
package reads the other's segment directories: ``stored_dtype`` names the
forward index's form on disk (``packed:<bits>`` for a single-value
dictionary column), ``crc`` the CRC-32 of the ``columns/`` files, and
``custom`` free-form properties (a sealed realtime segment's offsets).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from pinot_tpu_torch.spi.data import DataType, FieldType, Schema

DOC_TILE = 1024

SEGMENT_FORMAT_VERSION = "tpu-v1"
METADATA_FILE = "metadata.json"


def pad_capacity(num_docs: int) -> int:
    return max(DOC_TILE, ((num_docs + DOC_TILE - 1) // DOC_TILE) * DOC_TILE)


def narrowest_int_dtype(cardinality: int) -> str:
    """The smallest signed int dtype holding dictIds [0, cardinality): the
    on-disk dtype of a multi-value column's flat dictIds (JAX :43)."""
    if cardinality <= (1 << 7):
        return "int8"
    if cardinality <= (1 << 15):
        return "int16"
    return "int32"


def now_ms() -> int:
    return int(time.time() * 1000)


def _json_value(v: Any) -> Any:
    if v is None:
        return None
    if isinstance(v, bytes):
        return {"__bytes__": v.hex()}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, (np.floating, float)):
        f = float(v)
        if f in (float("inf"), float("-inf")) or f != f:
            return {"__float__": repr(f)}
        return f
    return v


def _unjson_value(v: Any) -> Any:
    if isinstance(v, dict):
        if "__bytes__" in v:
            return bytes.fromhex(v["__bytes__"])
        if "__float__" in v:
            return float(v["__float__"])
    return v


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
    # the forward index's form on disk: "packed:<bits>" (single-value
    # dictionary column), the flat dictIds' dtype (multi-value) or the
    # values' dtype (raw); None for a segment never written
    stored_dtype: Optional[str] = None
    total_number_of_entries: int = 0   # multi-value: the flat dictIds
    compression_codec: Optional[str] = None  # a raw column's chunk codec
    has_geo_index: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "dataType": self.data_type.label,
            "fieldType": self.field_type.value,
            "singleValue": self.single_value,
            "encoding": "DICT" if self.has_dictionary else "RAW",
            "cardinality": self.cardinality,
            "storedDtype": self.stored_dtype,
            "minValue": _json_value(self.min_value),
            "maxValue": _json_value(self.max_value),
            "isSorted": self.is_sorted,
            "hasDictionary": self.has_dictionary,
            "hasInvertedIndex": self.has_inverted_index,
            "hasNulls": self.has_nulls,
            "hasBloomFilter": self.has_bloom_filter,
            "hasJsonIndex": self.has_json_index,
            "hasTextIndex": self.has_text_index,
            "hasFstIndex": self.has_fst_index,
            "hasGeoIndex": self.has_geo_index,
            "hasRangeIndex": self.has_range_index,
            "maxNumMultiValues": self.max_num_multi_values,
            "totalNumberOfEntries": self.total_number_of_entries,
        }
        if self.partition_function:
            d["partitionFunction"] = self.partition_function
            d["numPartitions"] = self.num_partitions
            d["partitions"] = list(self.partitions)
        if self.compression_codec:
            d["compressionCodec"] = self.compression_codec
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ColumnMetadata":
        return cls(
            name=d["name"],
            data_type=DataType.from_string(d["dataType"]),
            field_type=FieldType[d["fieldType"]],
            single_value=d["singleValue"],
            cardinality=d["cardinality"],
            stored_dtype=d["storedDtype"],
            min_value=_unjson_value(d.get("minValue")),
            max_value=_unjson_value(d.get("maxValue")),
            is_sorted=d.get("isSorted", False),
            has_dictionary=d.get("hasDictionary", True),
            has_inverted_index=d.get("hasInvertedIndex", False),
            has_nulls=d.get("hasNulls", False),
            has_bloom_filter=d.get("hasBloomFilter", False),
            has_json_index=d.get("hasJsonIndex", False),
            has_text_index=d.get("hasTextIndex", False),
            has_fst_index=d.get("hasFstIndex", False),
            has_geo_index=d.get("hasGeoIndex", False),
            has_range_index=d.get("hasRangeIndex", False),
            max_num_multi_values=d.get("maxNumMultiValues", 0),
            total_number_of_entries=d.get("totalNumberOfEntries", 0),
            partition_function=d.get("partitionFunction"),
            num_partitions=d.get("numPartitions", 0),
            partitions=list(d.get("partitions", [])),
            compression_codec=d.get("compressionCodec"),
        )


def column_range(md: "SegmentMetadata", column: Optional[str]
                 ) -> tuple:
    """(min, max) of ``column`` over the segment's rows, ints for an
    integral column; (None, None) without the column or values."""
    cm = md.columns.get(column) if column is not None else None
    if cm is None or cm.min_value is None:
        return None, None
    if cm.data_type.is_integral:
        return int(cm.min_value), int(cm.max_value)
    return cm.min_value, cm.max_value


@dataclass
class SegmentMetadata:
    """``time_column`` / ``min_time`` / ``max_time`` are the schema's time
    column and its range, recorded as the JAX builder records them; the
    port's controller reads a segment's range from the table's time
    column instead (``controller/state.py`` ``segment_time_range``)."""

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
    format_version: str = SEGMENT_FORMAT_VERSION
    creation_time_ms: int = 0
    time_column: Optional[str] = None
    min_time: Any = None
    max_time: Any = None
    crc: int = 0

    def column(self, name: str) -> ColumnMetadata:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in segment "
                           f"{self.segment_name!r}") from None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "segmentName": self.segment_name,
            "tableName": self.table_name,
            "schema": self.schema.to_dict(),
            "numDocs": self.num_docs,
            "paddedCapacity": self.padded_capacity,
            "formatVersion": self.format_version,
            "creationTimeMs": self.creation_time_ms,
            "timeColumn": self.time_column,
            "minTime": _json_value(self.min_time),
            "maxTime": _json_value(self.max_time),
            "crc": self.crc,
            "starTreeCount": self.star_tree_count,
            "starTreeBuildS": self.star_tree_build_s,
            "columns": {n: c.to_dict() for n, c in self.columns.items()},
            "custom": self.custom,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SegmentMetadata":
        return cls(
            segment_name=d["segmentName"],
            table_name=d["tableName"],
            schema=Schema.from_dict(d["schema"]),
            num_docs=d["numDocs"],
            padded_capacity=d["paddedCapacity"],
            format_version=d.get("formatVersion", SEGMENT_FORMAT_VERSION),
            creation_time_ms=d.get("creationTimeMs", 0),
            time_column=d.get("timeColumn"),
            min_time=_unjson_value(d.get("minTime")),
            max_time=_unjson_value(d.get("maxTime")),
            crc=d.get("crc", 0),
            star_tree_count=d.get("starTreeCount", 0),
            star_tree_build_s=d.get("starTreeBuildS", []),
            columns={n: ColumnMetadata.from_dict(c)
                     for n, c in d.get("columns", {}).items()},
            custom=d.get("custom", {}),
        )

    def save(self, path: str) -> None:
        """Write ``metadata.json`` under a temporary name, then rename it
        into place: a reader sees the old file or the new, never half."""
        from pinot_tpu_torch.segment.creator import write_file

        write_file(path, json.dumps(self.to_dict(), indent=1,
                                    sort_keys=True).encode())

    @classmethod
    def load(cls, path: str) -> "SegmentMetadata":
        with open(path) as f:
            return cls.from_dict(json.load(f))
