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
generators, the broker's routing and its quota honour. Every config has
JAX's JSON form (``to_dict`` / ``from_dict``, JAX :460-530): the same
keys in the same order, so the remote state service and ``POST /tables``
carry a table, and a config file loads as it does in JAX. Fields the port
reads nowhere (the sorted column, var-length dictionaries, metric
pre-aggregation, null handling, partial-upsert strategies, the query and
custom maps) are kept so a config round-trips.
"""

from __future__ import annotations

import json
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

    def to_dict(self) -> Dict[str, Any]:
        return {
            "dimensionsSplitOrder": self.dimensions_split_order,
            "skipStarNodeCreationForDimensions":
                self.skip_star_node_creation_for_dimensions,
            "functionColumnPairs": self.function_column_pairs,
            "maxLeafRecords": self.max_leaf_records,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StarTreeIndexConfig":
        return cls(
            dimensions_split_order=d.get("dimensionsSplitOrder", []),
            skip_star_node_creation_for_dimensions=d.get(
                "skipStarNodeCreationForDimensions", []),
            function_column_pairs=d.get("functionColumnPairs", []),
            max_leaf_records=d.get("maxLeafRecords", 10_000))


@dataclass
class SegmentPartitionConfig:
    """column -> ``{"functionName": ..., "numPartitions": ...}``: the
    builder records the partitions each segment's values fall in, the
    broker's partition pruner reads them."""

    column_partition_map: Dict[str, Dict[str, Any]] = field(
        default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"columnPartitionMap": self.column_partition_map}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SegmentPartitionConfig":
        return cls(column_partition_map=d.get("columnPartitionMap", {}))


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
    # recorded for the JSON form; the port's builder reads none of them
    sorted_column: List[str] = field(default_factory=list)
    var_length_dictionary_columns: List[str] = field(default_factory=list)
    aggregate_metrics: bool = False
    null_handling_enabled: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "invertedIndexColumns": self.inverted_index_columns,
            "rangeIndexColumns": self.range_index_columns,
            "sortedColumn": self.sorted_column,
            "bloomFilterColumns": self.bloom_filter_columns,
            "textIndexColumns": self.text_index_columns,
            "fstIndexColumns": self.fst_index_columns,
            "noDictionaryColumns": self.no_dictionary_columns,
            "jsonIndexColumns": self.json_index_columns,
            "varLengthDictionaryColumns":
                self.var_length_dictionary_columns,
            "enableDefaultStarTree": self.enable_default_star_tree,
            "aggregateMetrics": self.aggregate_metrics,
            "nullHandlingEnabled": self.null_handling_enabled,
        }
        if self.star_tree_index_configs:
            d["starTreeIndexConfigs"] = [
                c.to_dict() for c in self.star_tree_index_configs]
        if self.segment_partition_config:
            d["segmentPartitionConfig"] = \
                self.segment_partition_config.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IndexingConfig":
        spc = d.get("segmentPartitionConfig")
        return cls(
            inverted_index_columns=d.get("invertedIndexColumns") or [],
            range_index_columns=d.get("rangeIndexColumns") or [],
            sorted_column=d.get("sortedColumn") or [],
            bloom_filter_columns=d.get("bloomFilterColumns") or [],
            text_index_columns=d.get("textIndexColumns") or [],
            fst_index_columns=d.get("fstIndexColumns") or [],
            no_dictionary_columns=d.get("noDictionaryColumns") or [],
            json_index_columns=d.get("jsonIndexColumns") or [],
            var_length_dictionary_columns=d.get(
                "varLengthDictionaryColumns") or [],
            star_tree_index_configs=[
                StarTreeIndexConfig.from_dict(c)
                for c in d.get("starTreeIndexConfigs") or []],
            enable_default_star_tree=d.get("enableDefaultStarTree", False),
            segment_partition_config=(
                SegmentPartitionConfig.from_dict(spc) if spc else None),
            aggregate_metrics=d.get("aggregateMetrics", False),
            null_handling_enabled=d.get("nullHandlingEnabled", False))


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
    partial_upsert_strategies: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"mode": self.mode.value,
                "comparisonColumn": self.comparison_column,
                "partialUpsertStrategies": self.partial_upsert_strategies}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UpsertConfig":
        return cls(mode=UpsertMode[d.get("mode", "NONE").upper()],
                   comparison_column=d.get("comparisonColumn"),
                   partial_upsert_strategies=d.get(
                       "partialUpsertStrategies", {}))


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

    def to_dict(self) -> Dict[str, Any]:
        return {
            "streamType": self.stream_type,
            "topic": self.topic,
            "decoder": self.decoder,
            "segmentFlushThresholdRows": self.segment_flush_threshold_rows,
            "segmentFlushThresholdMillis":
                self.segment_flush_threshold_millis,
            "properties": self.properties,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StreamIngestionConfig":
        return cls(
            stream_type=d.get("streamType", "fake"),
            topic=d.get("topic", ""),
            decoder=d.get("decoder", "json"),
            segment_flush_threshold_rows=int(
                d.get("segmentFlushThresholdRows", 100_000)),
            segment_flush_threshold_millis=int(
                d.get("segmentFlushThresholdMillis", 6 * 3600 * 1000)),
            properties=d.get("properties", {}))

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

    def to_dict(self) -> Dict[str, Any]:
        return {"columnName": self.column,
                "transformFunction": self.transform_function}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformConfig":
        return cls(d["columnName"], d["transformFunction"])


@dataclass
class IngestionConfig:
    """``filter_function``: rows it matches are dropped;
    ``transform_configs``: derived columns."""

    filter_function: Optional[str] = None
    transform_configs: List[TransformConfig] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.filter_function:
            d["filterConfig"] = {"filterFunction": self.filter_function}
        if self.transform_configs:
            d["transformConfigs"] = [t.to_dict()
                                     for t in self.transform_configs]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IngestionConfig":
        return cls(
            filter_function=(d.get("filterConfig") or {}).get(
                "filterFunction"),
            transform_configs=[TransformConfig.from_dict(t)
                               for t in d.get("transformConfigs") or []])


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

    def to_dict(self) -> Dict[str, Any]:
        return {
            "timeColumnName": self.time_column_name,
            "timeType": self.time_type,
            "replication": str(self.replication),
            "retentionTimeUnit": self.retention_time_unit,
            "retentionTimeValue": (
                str(self.retention_time_value)
                if self.retention_time_value is not None else None),
            "segmentPushType": self.segment_push_type,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SegmentsValidationConfig":
        rtv = d.get("retentionTimeValue")
        return cls(
            time_column_name=d.get("timeColumnName"),
            time_type=d.get("timeType", "MILLISECONDS"),
            replication=int(d.get("replication", 1)),
            retention_time_unit=d.get("retentionTimeUnit"),
            retention_time_value=(int(rtv) if rtv not in (None, "")
                                  else None),
            segment_push_type=d.get("segmentPushType", "APPEND"))


@dataclass
class TenantConfig:
    broker: str = "DefaultTenant"
    server: str = "DefaultTenant"

    def to_dict(self) -> Dict[str, Any]:
        return {"broker": self.broker, "server": self.server}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TenantConfig":
        return cls(broker=d.get("broker", "DefaultTenant"),
                   server=d.get("server", "DefaultTenant"))


@dataclass
class QuotaConfig:
    """Queries a second the broker admits for the table (None: no
    quota)."""

    max_queries_per_second: Optional[float] = None
    storage: Optional[str] = None    # recorded, not enforced

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.max_queries_per_second is not None:
            d["maxQueriesPerSecond"] = str(self.max_queries_per_second)
        if self.storage:
            d["storage"] = self.storage
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuotaConfig":
        qps = d.get("maxQueriesPerSecond")
        return cls(max_queries_per_second=(float(qps) if qps is not None
                                           else None),
                   storage=d.get("storage"))


@dataclass
class RoutingConfig:
    """``instance_selector_type``: ``balanced`` | ``replicaGroup`` |
    ``strictReplicaGroup``; ``segment_pruner_types``: ``["partition"]``
    turns the broker's partition pruner on."""

    instance_selector_type: str = "balanced"
    segment_pruner_types: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"instanceSelectorType": self.instance_selector_type,
                "segmentPrunerTypes": self.segment_pruner_types}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoutingConfig":
        return cls(
            instance_selector_type=d.get("instanceSelectorType",
                                         "balanced"),
            segment_pruner_types=d.get("segmentPrunerTypes") or [])


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

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name,
                             "encodingType": self.encoding_type}
        if self.index_type:
            d["indexType"] = self.index_type
        if self.compression_codec:
            d["compressionCodec"] = self.compression_codec
        if self.properties:
            d["properties"] = self.properties
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FieldConfig":
        return cls(name=d["name"],
                   encoding_type=d.get("encodingType", "DICTIONARY"),
                   index_type=d.get("indexType"),
                   compression_codec=d.get("compressionCodec"),
                   properties=d.get("properties") or {})


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
    # recorded for the JSON form (``query``, ``metadata.customConfigs``)
    query_config: Dict[str, Any] = field(default_factory=dict)
    custom_config: Dict[str, Any] = field(default_factory=dict)

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

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "tableName": self.table_name_with_type,
            "tableType": self.table_type.value,
            "segmentsConfig": self.validation_config.to_dict(),
            "tableIndexConfig": self.indexing_config.to_dict(),
            "tenants": self.tenant_config.to_dict(),
            "metadata": {"customConfigs": self.custom_config},
        }
        if (self.routing_config.instance_selector_type != "balanced"
                or self.routing_config.segment_pruner_types):
            d["routing"] = self.routing_config.to_dict()
        if self.quota_config.to_dict():
            d["quota"] = self.quota_config.to_dict()
        if self.upsert_config:
            d["upsertConfig"] = self.upsert_config.to_dict()
        if self.stream_config:
            d["streamConfig"] = self.stream_config.to_dict()
        if self.ingestion_config:
            d["ingestionConfig"] = self.ingestion_config.to_dict()
        if self.query_config:
            d["query"] = self.query_config
        if self.task_config:
            d["task"] = {"taskTypeConfigsMap": self.task_config}
        if self.field_config_list:
            d["fieldConfigList"] = [c.to_dict()
                                    for c in self.field_config_list]
        if self.tier_configs:
            d["tierConfigs"] = self.tier_configs
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TableConfig":
        uc = d.get("upsertConfig")
        sc = d.get("streamConfig")
        if sc is not None:
            stream_config = StreamIngestionConfig.from_dict(sc)
        else:
            # the reference's layout: the flat map inside tableIndexConfig
            nested = (d.get("tableIndexConfig") or {}).get("streamConfigs")
            stream_config = (
                StreamIngestionConfig.from_stream_configs_map(nested)
                if nested else None)
        return cls(
            table_name=d["tableName"],
            table_type=TableType[d.get("tableType", "OFFLINE").upper()],
            validation_config=SegmentsValidationConfig.from_dict(
                d.get("segmentsConfig", {})),
            indexing_config=IndexingConfig.from_dict(
                d.get("tableIndexConfig", {})),
            tenant_config=TenantConfig.from_dict(d.get("tenants", {})),
            routing_config=RoutingConfig.from_dict(d.get("routing", {})),
            quota_config=QuotaConfig.from_dict(d.get("quota", {})),
            upsert_config=UpsertConfig.from_dict(uc) if uc else None,
            stream_config=stream_config,
            ingestion_config=(
                IngestionConfig.from_dict(d["ingestionConfig"])
                if d.get("ingestionConfig") else None),
            query_config=d.get("query", {}),
            custom_config=(d.get("metadata") or {}).get("customConfigs", {}),
            task_config=(d.get("task") or {}).get("taskTypeConfigsMap", {}),
            field_config_list=[FieldConfig.from_dict(c)
                               for c in d.get("fieldConfigList") or []],
            tier_configs=d.get("tierConfigs") or [])

    @classmethod
    def from_json(cls, s: str) -> "TableConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_file(cls, path: str) -> "TableConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))
