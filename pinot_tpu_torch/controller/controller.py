"""Controller: the cluster-mutation API, cut to offline tables.

Counterpart of ``pinot_tpu/controller/controller.py`` (``Controller``):
schemas and tables (``add_table`` with the replica-group instance
partitions), segment pushes and their assignment (``add_segment``),
deletes, instance registration and tags, and the liveness check that
marks an instance whose heartbeat went stale as dead. Realtime tables
(the LLC manager, the segment-completion FSM and its commit handler),
minion tasks, lineage, retention, rebalance and the periodic loop are not
part of this module: ``add_table`` of a REALTIME table raises before it
writes anything. The controller owns its cluster's deep store
(``spi/filesystem.py`` ``MemoryDeepStore``), which its servers fetch
from; deleting a segment or a table drops it there too.

A pushed segment's time range is the min and max of the table's time
column (``segmentsConfig.timeColumnName``) in the segment, or of the
schema's TIME / DATE_TIME column where the table names none; the JAX
controller reads the range its segment builder recorded from the schema's
time column alone.
"""

from __future__ import annotations

import logging
import time

from typing import List, Optional, Tuple

from pinot_tpu_torch.controller.assignment import (
    BalancedSegmentAssignment,
    ReplicaGroupSegmentAssignment,
    SegmentAssignment,
    assignment_for_table,
    compute_instance_partitions,
)
from pinot_tpu_torch.controller.state import (
    ONLINE,
    ClusterStateStore,
    InstanceInfo,
    SegmentZKMetadata,
)
from pinot_tpu_torch.engine.errors import QueryError
from pinot_tpu_torch.segment.metadata import SegmentMetadata
from pinot_tpu_torch.spi.filesystem import MemoryDeepStore
from pinot_tpu_torch.spi.data import FieldType, Schema
from pinot_tpu_torch.spi.table import TableConfig, TableType

log = logging.getLogger(__name__)


def segment_time_range(metadata: SegmentMetadata,
                       time_column: Optional[str]
                       ) -> Tuple[Optional[object], Optional[object]]:
    """(min, max) of the time column over the segment's rows, ints for an
    integral column; (None, None) without a time column or values."""
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


class Controller:
    """Single-controller deployment (the reference's lead controller)."""

    def __init__(self, store: Optional[ClusterStateStore] = None,
                 controller_id: str = "controller_0"):
        self.store = store or ClusterStateStore()
        self.deep_store = MemoryDeepStore()
        self.controller_id = controller_id
        self.store.register_instance(
            InstanceInfo(controller_id, "CONTROLLER"))

    # -- schema / table management ------------------------------------------
    def add_schema(self, schema: Schema) -> None:
        self.store.add_schema(schema)

    def add_table(self, config: TableConfig) -> None:
        """Validate, create the IdealState and, for replica-group routing,
        store the instance partitions."""
        name = config.table_name_with_type
        if config.table_type is TableType.REALTIME:
            raise QueryError(
                f"realtime table {name}: the port's cluster serves offline "
                "tables only (realtime and hybrid tables in the cluster are "
                "ROADMAP.md queue 1 item 5a)")
        if self.store.get_table_config(name) is not None:
            raise ValueError(f"table {name} already exists")
        if self.store.get_schema(config.table_name) is None:
            raise ValueError(f"no schema named {config.table_name!r} — "
                             "add the schema first")
        groups = None
        if config.routing_config.instance_selector_type != "balanced":
            # replica-group routing: the assignment and the broker's
            # selectors share one stored layout
            servers = [i.instance_id
                       for i in self.store.instances("SERVER",
                                                     only_alive=True)]
            if not servers:
                raise ValueError(
                    f"replica-group table {name} needs live servers at "
                    "creation time (instance partitions are computed here)")
            groups = compute_instance_partitions(servers, config.replication)
        self.store.add_table_config(config)
        self.store.set_ideal_state(name, {})
        if groups is not None:
            self.store.set_instance_partitions(name, groups)

    def update_table(self, config: TableConfig) -> None:
        """Replace an existing table's config."""
        name = config.table_name_with_type
        if self.store.get_table_config(name) is None:
            raise KeyError(f"no such table {name}")
        self.store.add_table_config(config)

    def delete_table(self, name_with_type: str) -> None:
        self.store.delete_table(name_with_type)
        self.deep_store.delete_table(name_with_type)

    def table_names(self) -> List[str]:
        return self.store.table_names()

    # -- offline segment push -------------------------------------------------
    def add_segment(self, table_with_type: str, metadata: SegmentMetadata,
                    download_url: str) -> None:
        """Segment push: record the segment's metadata and assign it to
        servers."""
        cfg = self.store.get_table_config(table_with_type)
        if cfg is None:
            raise KeyError(f"no such table {table_with_type}")
        partition_meta = {
            cm.name: {"functionName": cm.partition_function,
                      "numPartitions": cm.num_partitions,
                      "partitions": list(cm.partitions)}
            for cm in metadata.columns.values() if cm.partition_function}
        start, end = segment_time_range(
            metadata, cfg.validation_config.time_column_name)
        now_ms = int(time.time() * 1000)
        zk = SegmentZKMetadata(
            segment_name=metadata.segment_name, table_name=table_with_type,
            status=ONLINE, download_url=download_url,
            creation_time_ms=now_ms, push_time_ms=now_ms,
            start_time=start, end_time=end, total_docs=metadata.num_docs,
            partition_metadata=partition_meta)
        self.store.set_segment_metadata(zk)

        servers, replication = assignment_for_table(self.store,
                                                    table_with_type)
        groups = self.store.get_instance_partitions(table_with_type)
        # replicas spread over distinct failure domains where servers
        # report them
        domains = {i.instance_id: i.failure_domain
                   for i in self.store.instances("SERVER")
                   if i.failure_domain}
        strategy: SegmentAssignment = (
            ReplicaGroupSegmentAssignment(len(groups), groups=groups)
            if groups else BalancedSegmentAssignment(domains=domains))

        def apply(ideal):
            ideal = ideal or {}
            chosen = strategy.assign(metadata.segment_name, ideal, servers,
                                     replication)
            ideal[metadata.segment_name] = {i: ONLINE for i in chosen}
            return ideal

        self.store.update_ideal_state(table_with_type, apply)

    def delete_segment(self, table: str, segment: str) -> None:
        self.store.delete_segment(table, segment)

        def apply(ideal):
            ideal = ideal or {}
            ideal.pop(segment, None)
            return ideal

        self.store.update_ideal_state(table, apply)
        self.deep_store.delete_segment(table, segment)

    # -- instances ----------------------------------------------------------
    def register_instance(self, info: InstanceInfo) -> None:
        self.store.register_instance(info)

    def update_instance_tags(self, instance_id: str,
                             tags: List[str]) -> None:
        """Re-tag an instance (the tenant-membership mutation), as an atomic
        read-modify-write so a concurrent heartbeat's heartbeatMs is never
        overwritten by a stale copy."""
        if self.store.get_instance(instance_id) is None:
            raise KeyError(f"unknown instance {instance_id!r}")

        def apply(d):
            if d:
                d["tags"] = list(tags)
            return d

        self.store.update(f"instances/{instance_id}", apply)

    def run_liveness_check(self, timeout_ms: int = 10_000,
                           now_ms: Optional[int] = None) -> List[str]:
        """Mark instances whose heartbeat went stale as dead, so routing
        excludes them; a fresh heartbeat revives them
        (``store.touch_instance``). Instances that never sent one are left
        alone. -> the newly dead instance ids."""
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        newly_dead = []
        for info in self.store.instances():
            if not info.heartbeat_ms:
                continue    # never heartbeated: liveness managed by hand
            stale = now_ms - info.heartbeat_ms > timeout_ms
            if stale and info.alive:
                log.warning("instance %s heartbeat stale (%dms): marking "
                            "dead", info.instance_id,
                            now_ms - info.heartbeat_ms)
                self.store.set_instance_alive(info.instance_id, False)
                newly_dead.append(info.instance_id)
        return newly_dead
