"""Cluster state store: the Helix / ZooKeeper role.

Counterpart of ``pinot_tpu/controller/state.py`` (``SegmentZKMetadata``,
``InstanceInfo``, ``ClusterStateStore`` :133): one strongly consistent
in-process store of schemas, table configs, segment metadata, IdealState
and ExternalView maps, instance partitions and the instance registry,
with path-prefix watches through which servers and the broker follow
changes. ``segment_time_range`` is the time range a pushed or committed
segment records. Every mutation runs under one lock and bumps the version (the ZK
zxid); watchers fire outside the lock, in mutation order, one draining
thread at a time (``_drain_notifications``), and a watcher may mutate the
store again.

Two differences from the JAX store: schemas and table configs are kept as
objects (deep copies in and out) where JAX keeps their JSON dicts, since
the port's configs have no JSON form; and there is no JSON snapshot file
or mutation log (no remote replica reads them yet).
"""

from __future__ import annotations

import copy
import json
import logging
import threading
import time

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from pinot_tpu_torch.spi.data import FieldType, Schema
from pinot_tpu_torch.spi.table import TableConfig

log = logging.getLogger(__name__)


# segment states in IdealState / ExternalView
ONLINE = "ONLINE"
CONSUMING = "CONSUMING"
OFFLINE = "OFFLINE"
ERROR = "ERROR"


def segment_time_range(metadata, time_column: Optional[str]
                       ) -> Tuple[Optional[object], Optional[object]]:
    """(min, max) of the time column over the rows of the segment whose
    ``SegmentMetadata`` this is, ints for an integral column; (None, None)
    without a time column or values. The schema's TIME / DATE_TIME column
    stands in where the table names none."""
    schema = metadata.schema
    if time_column is None:
        time_column = next(
            (fs.name for fs in schema.field_specs
             if fs.field_type in (FieldType.TIME, FieldType.DATE_TIME)),
            None)
    cm = metadata.columns.get(time_column) if time_column else None
    if cm is None or cm.min_value is None:
        return None, None
    if cm.data_type.is_integral:
        return int(cm.min_value), int(cm.max_value)
    return cm.min_value, cm.max_value


@dataclass
class SegmentZKMetadata:
    """The segment metadata the controller records at a push (the
    reference's SegmentZKMetadata)."""

    segment_name: str
    table_name: str  # with type suffix
    status: str = ONLINE              # ONLINE | CONSUMING | OFFLINE
    download_url: str = ""            # deep-store location
    crc: int = 0
    creation_time_ms: int = 0
    push_time_ms: int = 0
    start_time: Optional[int] = None  # time-column units
    end_time: Optional[int] = None
    total_docs: int = 0
    # realtime (LLC) checkpoint
    start_offset: Optional[str] = None
    end_offset: Optional[str] = None
    partition: Optional[int] = None
    sequence: Optional[int] = None
    # column -> {functionName, numPartitions, partitions} for the broker's
    # partition pruning
    partition_metadata: Dict[str, Any] = field(default_factory=dict)
    custom: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "segmentName": self.segment_name,
            "tableName": self.table_name,
            "status": self.status,
            "downloadUrl": self.download_url,
            "crc": self.crc,
            "creationTimeMs": self.creation_time_ms,
            "pushTimeMs": self.push_time_ms,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "totalDocs": self.total_docs,
            "startOffset": self.start_offset,
            "endOffset": self.end_offset,
            "partition": self.partition,
            "sequence": self.sequence,
            "partitionMetadata": self.partition_metadata,
            "custom": self.custom,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SegmentZKMetadata":
        return cls(
            segment_name=d["segmentName"], table_name=d["tableName"],
            status=d.get("status", ONLINE),
            download_url=d.get("downloadUrl", ""), crc=d.get("crc", 0),
            creation_time_ms=d.get("creationTimeMs", 0),
            push_time_ms=d.get("pushTimeMs", 0),
            start_time=d.get("startTime"), end_time=d.get("endTime"),
            total_docs=d.get("totalDocs", 0),
            start_offset=d.get("startOffset"), end_offset=d.get("endOffset"),
            partition=d.get("partition"), sequence=d.get("sequence"),
            partition_metadata=d.get("partitionMetadata", {}),
            custom=d.get("custom", {}),
        )


@dataclass
class InstanceInfo:
    """An instance's config and liveness (Helix InstanceConfig and
    LiveInstance)."""

    instance_id: str
    instance_type: str          # BROKER | SERVER | CONTROLLER | MINION
    host: str = "localhost"
    port: int = 0
    tags: List[str] = field(default_factory=lambda: ["DefaultTenant"])
    alive: bool = True
    # last heartbeat (ms since epoch); the ephemeral-znode liveness analogue
    heartbeat_ms: int = 0
    # fault-domain label (the balanced assignment spreads replicas over
    # distinct domains)
    failure_domain: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"instanceId": self.instance_id,
                "type": self.instance_type, "host": self.host,
                "port": self.port, "tags": self.tags, "alive": self.alive,
                "heartbeatMs": self.heartbeat_ms,
                "failureDomain": self.failure_domain}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InstanceInfo":
        return cls(d["instanceId"], d["type"], d.get("host", "localhost"),
                   d.get("port", 0), d.get("tags", ["DefaultTenant"]),
                   d.get("alive", True), d.get("heartbeatMs", 0),
                   d.get("failureDomain"))


Watcher = Callable[[str, Any], None]


class ClusterStateStore:
    """The single source of truth for cluster metadata.

    Paths (the ZK layout):
      schemas/<name>, tables/<nameWithType>,
      segments/<table>/<segment>           (SegmentZKMetadata),
      idealstate/<table>                   ({segment: {instance: state}}),
      externalview/<table>,
      instancepartitions/<table>,
      instances/<id>
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._data: Dict[str, Any] = {}  # guarded-by: _lock
        self._version = 0  # guarded-by: _lock
        self._watchers: List[Tuple[str, Watcher]] = []  # guarded-by: _lock
        # mutation-ordered notifications, drained under _notify_lock so
        # watchers see updates in version order even when mutators race
        self._pending: List[Tuple[str, Any]] = []  # guarded-by: _lock
        # RLock: a watcher may mutate the store, re-entering the drain
        self._notify_lock = threading.RLock()

    @staticmethod
    def _copy(v: Any) -> Any:
        if isinstance(v, (dict, list)):
            return json.loads(json.dumps(v))
        if isinstance(v, (Schema, TableConfig)):
            return copy.deepcopy(v)
        return v

    # -- raw property store --------------------------------------------------
    def get(self, path: str, default: Any = None) -> Any:
        with self._lock:
            v = self._data.get(path, default)
        return self._copy(v)

    def _apply_locked(self, path: str, value: Any) -> int:
        self._data[path] = value
        self._version += 1
        self._pending.append((path, value))
        return self._version

    def set(self, path: str, value: Any) -> int:
        value = self._copy(value)   # detach from the caller's object
        with self._lock:
            v = self._apply_locked(path, value)
        self._drain_notifications()
        return v

    def compare_and_set(self, path: str, expected: Any, value: Any) -> bool:
        """Set ``path`` only while it holds ``expected`` (the ZK
        setData-with-version)."""
        value = self._copy(value)
        with self._lock:
            if self._data.get(path) != expected:
                return False
            self._apply_locked(path, value)
        self._drain_notifications()
        return True

    def update(self, path: str, fn: Callable[[Any], Any],
               default: Any = None) -> Any:
        """Atomic read-modify-write."""
        with self._lock:
            cur = self._data.get(path, default)
            new = self._copy(fn(self._copy(cur)))
            self._apply_locked(path, new)
        self._drain_notifications()
        return self._copy(new)

    def delete(self, path: str) -> None:
        with self._lock:
            existed = path in self._data
            if existed:
                del self._data[path]
                self._version += 1
                self._pending.append((path, None))
        if existed:
            self._drain_notifications()

    def children(self, prefix: str) -> List[str]:
        prefix = prefix.rstrip("/") + "/"
        with self._lock:
            keys = [k for k in self._data if k.startswith(prefix)]
        return sorted(keys)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # -- watches -------------------------------------------------------------
    def watch(self, prefix: str, watcher: Watcher) -> None:
        """``watcher(path, value)`` fires for every mutation under
        ``prefix`` (``value`` None for a delete)."""
        with self._lock:
            self._watchers.append((prefix, watcher))

    def _drain_notifications(self) -> None:
        """Deliver queued notifications in mutation order. One thread drains
        at a time; a mutator racing past a draining thread leaves its event
        in the queue for the drainer."""
        while True:
            with self._notify_lock:
                with self._lock:
                    if not self._pending:
                        return
                    batch, self._pending = self._pending, []
                    # under the lock watch() appends under: a registration
                    # racing the drain sees the whole batch or none of it
                    watchers = list(self._watchers)
                for path, value in batch:
                    for prefix, w in watchers:
                        if path.startswith(prefix):
                            try:
                                w(path, self._copy(value))
                            except Exception:  # must not poison the store
                                log.exception("watcher failed for %s", path)

    # -- typed accessors (ZKMetadataProvider) --------------------------------
    def add_schema(self, schema: Schema) -> None:
        self.set(f"schemas/{schema.schema_name}", schema)

    def get_schema(self, name: str) -> Optional[Schema]:
        return self.get(f"schemas/{name}")

    def schema_names(self) -> List[str]:
        return [p.split("/", 1)[1] for p in self.children("schemas")]

    def add_table_config(self, config: TableConfig) -> None:
        self.set(f"tables/{config.table_name_with_type}", config)

    def get_table_config(self, name_with_type: str) -> Optional[TableConfig]:
        return self.get(f"tables/{name_with_type}")

    def table_names(self) -> List[str]:
        return [p.split("/", 1)[1] for p in self.children("tables")]

    def delete_table(self, name_with_type: str) -> None:
        for p in self.children(f"segments/{name_with_type}"):
            self.delete(p)
        self.delete(f"idealstate/{name_with_type}")
        self.delete(f"externalview/{name_with_type}")
        self.delete(f"tables/{name_with_type}")

    # segments
    def set_segment_metadata(self, md: SegmentZKMetadata) -> None:
        self.set(f"segments/{md.table_name}/{md.segment_name}", md.to_dict())

    def get_segment_metadata(self, table: str,
                             segment: str) -> Optional[SegmentZKMetadata]:
        d = self.get(f"segments/{table}/{segment}")
        return SegmentZKMetadata.from_dict(d) if d else None

    def segment_names(self, table: str) -> List[str]:
        return [p.rsplit("/", 1)[1]
                for p in self.children(f"segments/{table}")]

    def segment_metadata_list(self, table: str) -> List[SegmentZKMetadata]:
        return [SegmentZKMetadata.from_dict(self.get(p))
                for p in self.children(f"segments/{table}")]

    def delete_segment(self, table: str, segment: str) -> None:
        self.delete(f"segments/{table}/{segment}")

    # ideal state / external view: {segment: {instance: state}}
    def get_ideal_state(self, table: str) -> Dict[str, Dict[str, str]]:
        return self.get(f"idealstate/{table}", {}) or {}

    def set_ideal_state(self, table: str,
                        state: Dict[str, Dict[str, str]]) -> None:
        self.set(f"idealstate/{table}", state)

    def update_ideal_state(self, table: str,
                           fn: Callable[[Dict[str, Dict[str, str]]],
                                        Dict[str, Dict[str, str]]]) -> Dict:
        return self.update(f"idealstate/{table}", fn, default={})

    def get_external_view(self, table: str) -> Dict[str, Dict[str, str]]:
        return self.get(f"externalview/{table}", {}) or {}

    def report_instance_state(self, table: str, segment: str,
                              instance: str, state: str) -> None:
        """A server's state report (the Helix current-state -> ExternalView
        roll-up)."""

        def apply(ev):
            ev = ev or {}
            seg = ev.setdefault(segment, {})
            if state == OFFLINE:
                seg.pop(instance, None)
                if not seg:
                    ev.pop(segment, None)
            else:
                seg[instance] = state
            return ev

        self.update(f"externalview/{table}", apply, default={})

    # instance partitions: the replica-group layout the assignment writes
    # and the broker's replica-group selectors read
    def set_instance_partitions(self, table: str,
                                groups: List[List[str]]) -> None:
        self.set(f"instancepartitions/{table}", [list(g) for g in groups])

    def get_instance_partitions(self, table: str
                                ) -> Optional[List[List[str]]]:
        return self.get(f"instancepartitions/{table}")

    # instances
    def register_instance(self, info: InstanceInfo) -> None:
        self.set(f"instances/{info.instance_id}", info.to_dict())

    def get_instance(self, instance_id: str) -> Optional[InstanceInfo]:
        d = self.get(f"instances/{instance_id}")
        return InstanceInfo.from_dict(d) if d else None

    def instances(self, instance_type: Optional[str] = None,
                  only_alive: bool = False) -> List[InstanceInfo]:
        out = []
        for p in self.children("instances"):
            info = InstanceInfo.from_dict(self.get(p))
            if instance_type and info.instance_type != instance_type:
                continue
            if only_alive and not info.alive:
                continue
            out.append(info)
        return out

    def set_instance_alive(self, instance_id: str, alive: bool) -> None:
        def apply(d):
            if d:
                d["alive"] = alive
            return d

        self.update(f"instances/{instance_id}", apply)

    def touch_instance(self, instance_id: str,
                       now_ms: Optional[int] = None) -> None:
        """Heartbeat (the ephemeral-znode keepalive): refreshes heartbeatMs
        and revives a dead-marked instance."""
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)

        def apply(d):
            if d:
                d["heartbeatMs"] = now_ms
                d["alive"] = True
            return d

        self.update(f"instances/{instance_id}", apply)
