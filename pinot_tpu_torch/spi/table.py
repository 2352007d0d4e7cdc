"""Table config: the indexes a segment is built with, a realtime table's
stream, upsert and ingestion settings, and what the cluster reads of a
table.

Counterpart of ``pinot_tpu/spi/table.py``: ``StarTreeIndexConfig`` (:49),
``SegmentPartitionConfig`` (:76), ``IndexingConfig`` (:90-142),
``SegmentsValidationConfig`` (:186-215, the time column, the replication,
the retention and the push type),
``TenantConfig`` (:221), ``TableType``, ``UpsertMode``, ``UpsertConfig``,
``StreamIngestionConfig`` with the reference's flat stream-config map
reader (:265-318), ``TransformConfig``, ``IngestionConfig``,
``QuotaConfig`` (:383), ``RoutingConfig`` (:406, the broker's instance
selector and segment pruners), ``FieldConfig`` (:150-180, a column's raw
encoding and the chunk codec of its forward index on disk) and
``TableConfig`` (:426, with the minion's ``task_config`` and the
``tier_configs`` at :441-445), cut to the knobs the port's segment
builder, the realtime consumer (``ingestion/realtime.py``), the record
transformers, the controller with its periodic tasks and minion task
generators, the broker's routing and its quota honour (no JSON round trip
of the whole table: the cluster state store keeps the config object,
``controller/state.py``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


@dataclass
class StarTreeIndexConfig:
    """One star-tree: the dimensions in split order, the dimensions that
    get no star child, the function-column pairs (``"SUM__revenue"``,
    ``"COUNT__*"``, ``"SUM__a*b"`` for a derived pair) and the record
    count at which a node stops splitting."""

    dimensions_split_order: List[str] = field(default_factory=list)
    skip_star_node_creation_for_dimensions: List[str] = field(
        default_factory=list)
    function_column_pairs: List[str] = field(default_factory=list)
    max_leaf_records: int = 10_000


@dataclass
class SegmentPartitionConfig:
    """column -> ``{"functionName": ..., "numPartitions": ...}``: the
    builder records the partitions each segment's values fall in, the
    broker's partition pruner reads them."""

    column_partition_map: Dict[str, Dict[str, Any]] = field(
        default_factory=dict)


@dataclass
class IndexingConfig:
    """Column lists per index kind:

    - ``inverted_index_columns``: per-dictId posting lists (dictionary
      columns, single- or multi-value);
    - ``range_index_columns``: the sorted-order permutation of a raw
      single-value column's values;
    - ``bloom_filter_columns``: a bloom filter over the distinct values;
    - ``fst_index_columns``, ``text_index_columns``,
      ``json_index_columns``: the REGEXP_LIKE, TEXT_MATCH and JSON_MATCH
      indexes of single-value string columns;
    - ``no_dictionary_columns``: raw (value) encoding, single-value
      numeric columns only;
    - ``star_tree_index_configs``: the star-trees built over the segment;
      with none, ``enable_default_star_tree`` builds one over the
      dimensions of bounded cardinality (``segment/convert.py``)."""

    inverted_index_columns: List[str] = field(default_factory=list)
    range_index_columns: List[str] = field(default_factory=list)
    bloom_filter_columns: List[str] = field(default_factory=list)
    fst_index_columns: List[str] = field(default_factory=list)
    text_index_columns: List[str] = field(default_factory=list)
    json_index_columns: List[str] = field(default_factory=list)
    no_dictionary_columns: List[str] = field(default_factory=list)
    star_tree_index_configs: List[StarTreeIndexConfig] = field(
        default_factory=list)
    enable_default_star_tree: bool = False
    segment_partition_config: Optional[SegmentPartitionConfig] = None


class TableType(Enum):
    OFFLINE = "OFFLINE"
    REALTIME = "REALTIME"

    @property
    def suffix(self) -> str:
        return "_" + self.value


def table_name_with_type(raw_name: str, table_type: TableType) -> str:
    """``myTable`` + OFFLINE -> ``myTable_OFFLINE``."""
    if raw_name.endswith(table_type.suffix):
        return raw_name
    return raw_name + table_type.suffix


def table_type_from_name(name: str) -> Optional[TableType]:
    for t in TableType:
        if name.endswith(t.suffix):
            return t
    return None


def raw_table_name(name: str) -> str:
    """``myTable_REALTIME`` -> ``myTable``."""
    for t in TableType:
        if name.endswith(t.suffix):
            return name[: -len(t.suffix)]
    return name


class UpsertMode(Enum):
    NONE = "NONE"
    FULL = "FULL"
    PARTIAL = "PARTIAL"


@dataclass
class UpsertConfig:
    """The upsert mode and the column whose larger value wins (the time
    column when None)."""

    mode: UpsertMode = UpsertMode.NONE
    comparison_column: Optional[str] = None


@dataclass
class StreamIngestionConfig:
    """A realtime table's stream: ``stream_type`` picks a registered
    consumer factory (``ingestion/stream.py``), ``decoder`` the message
    decoder; a consuming segment commits at ``segment_flush_threshold_rows``
    rows or after ``segment_flush_threshold_millis``."""

    stream_type: str = "fake"
    topic: str = ""
    decoder: str = "json"
    segment_flush_threshold_rows: int = 100_000
    segment_flush_threshold_millis: int = 6 * 3600 * 1000
    properties: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_stream_configs_map(cls, m: Dict[str, Any]
                                ) -> "StreamIngestionConfig":
        """The reference's flat ``tableIndexConfig.streamConfigs`` map
        (``stream.<type>.topic.name``,
        ``realtime.segment.flush.threshold.rows`` or ``.size``,
        ``realtime.segment.flush.threshold.time``)."""
        stream_type = m.get("streamType", "fake")
        prefix = f"stream.{stream_type}."
        topic = m.get(prefix + "topic.name", m.get("topic", ""))
        decoder = m.get(prefix + "decoder.class.name",
                        m.get("decoder", "json"))
        rows = int(m.get("realtime.segment.flush.threshold.rows",
                         m.get("realtime.segment.flush.threshold.size",
                               100_000)))
        millis = _duration_ms(m.get("realtime.segment.flush.threshold.time",
                                    6 * 3600 * 1000))
        props = {k: v for k, v in m.items() if k != "streamType"}
        return cls(stream_type=stream_type, topic=topic, decoder=decoder,
                   segment_flush_threshold_rows=rows,
                   segment_flush_threshold_millis=millis, properties=props)


_UNIT_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
            "d": 86_400_000}


def _duration_ms(v: Any) -> int:
    """Milliseconds from an int, a numeric string or a period ('12h',
    '1d12h', '500ms')."""
    s = str(v).strip().lower()
    try:
        return int(s)
    except ValueError:
        pass
    if not re.fullmatch(r"(?:\d+\s*(?:ms|s|m|h|d)\s*)+", s):
        raise ValueError(f"bad duration {v!r} (want millis or e.g. '6h')")
    return sum(int(n) * _UNIT_MS[u]
               for n, u in re.findall(r"(\d+)\s*(ms|s|m|h|d)", s))


@dataclass
class TransformConfig:
    """One derived column: a SQL expression over the row's fields."""

    column: str
    transform_function: str


@dataclass
class IngestionConfig:
    """``filter_function``: rows it matches are dropped;
    ``transform_configs``: derived columns."""

    filter_function: Optional[str] = None
    transform_configs: List[TransformConfig] = field(default_factory=list)


@dataclass
class SegmentsValidationConfig:
    """The table's time column (the broker's time pruner and the segment
    time range read it), how many servers host each segment, how long the
    retention manager keeps a segment (``retention_time_unit`` such as
    ``"DAYS"`` times ``retention_time_value``; None keeps it for ever) and
    the push type (``APPEND`` | ``REFRESH``)."""

    time_column_name: Optional[str] = None
    time_type: str = "MILLISECONDS"
    replication: int = 1
    retention_time_unit: Optional[str] = None
    retention_time_value: Optional[int] = None
    segment_push_type: str = "APPEND"


@dataclass
class TenantConfig:
    broker: str = "DefaultTenant"
    server: str = "DefaultTenant"


@dataclass
class QuotaConfig:
    """Queries a second the broker admits for the table (None: no
    quota)."""

    max_queries_per_second: Optional[float] = None
    storage: Optional[str] = None    # recorded, not enforced


@dataclass
class RoutingConfig:
    """``instance_selector_type``: ``balanced`` | ``replicaGroup`` |
    ``strictReplicaGroup``; ``segment_pruner_types``: ``["partition"]``
    turns the broker's partition pruner on."""

    instance_selector_type: str = "balanced"
    segment_pruner_types: List[str] = field(default_factory=list)


@dataclass
class FieldConfig:
    """One column's encoding directives (``fieldConfigList``):
    ``encoding_type`` RAW stores a single-value numeric column's values
    without a dictionary, and ``compression_codec`` (ZSTANDARD, ZLIB,
    PASS_THROUGH; SNAPPY and LZ4 are written as ZSTANDARD, or ZLIB where
    ``zstandard`` is missing) compresses such a column's forward index in
    chunks on disk (``segment/compression.py``)."""

    name: str
    encoding_type: str = "DICTIONARY"   # DICTIONARY | RAW
    index_type: Optional[str] = None
    compression_codec: Optional[str] = None
    properties: Dict[str, str] = field(default_factory=dict)


@dataclass
class TableConfig:
    """What the consumer, the transformers and the cluster read of a
    table."""

    table_name: str
    table_type: TableType = TableType.OFFLINE
    validation_config: SegmentsValidationConfig = field(
        default_factory=SegmentsValidationConfig)
    indexing_config: IndexingConfig = field(default_factory=IndexingConfig)
    tenant_config: TenantConfig = field(default_factory=TenantConfig)
    routing_config: RoutingConfig = field(default_factory=RoutingConfig)
    quota_config: QuotaConfig = field(default_factory=QuotaConfig)
    upsert_config: Optional[UpsertConfig] = None
    stream_config: Optional[StreamIngestionConfig] = None
    ingestion_config: Optional[IngestionConfig] = None
    field_config_list: List[FieldConfig] = field(default_factory=list)
    # task type -> its config map (the reference's taskTypeConfigsMap),
    # read by the minion task generators (controller/tasks.py)
    task_config: Dict[str, Dict[str, str]] = field(default_factory=dict)
    # the tiers' dicts (``TierConfig.to_dict`` layout, controller/tiers.py)
    tier_configs: List[Dict[str, Any]] = field(default_factory=list)

    def __post_init__(self):
        if isinstance(self.table_type, str):
            self.table_type = TableType[self.table_type.upper()]
        self.table_name = raw_table_name(self.table_name)

    @property
    def table_name_with_type(self) -> str:
        return table_name_with_type(self.table_name, self.table_type)

    @property
    def replication(self) -> int:
        return self.validation_config.replication
