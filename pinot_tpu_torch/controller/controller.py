"""Controller: the cluster-mutation API.

Counterpart of ``pinot_tpu/controller/controller.py`` (``Controller``):
schemas and tables (``add_table`` with the replica-group instance
partitions, and for a REALTIME table one CONSUMING segment per stream
partition), segment pushes and their assignment (``add_segment``),
deletes, instance registration and tags, and the liveness check that
marks an instance whose heartbeat went stale as dead. The realtime path:
the LLC segment manager (``controller/llc.py``), the segment-completion
FSM (``controller/completion.py``) whose commit handler flips a
committed segment ONLINE and opens the next sequence
(``_on_segment_commit``), and ``run_realtime_validation``, which
recreates a partition's dead CONSUMING segment. Minion tasks, lineage,
retention, rebalance and the periodic loop (``start_periodic_tasks``)
are not part of this module. The controller owns its cluster's deep store
(``spi/filesystem.py`` ``MemoryDeepStore``), which its servers fetch
from and the completion FSM keeps committed realtime segments in;
deleting a segment or a table drops it there too.

A segment's time range is the min and max of the table's time column
(``segmentsConfig.timeColumnName``) in the segment, or of the schema's
TIME / DATE_TIME column where the table names none
(``state.segment_time_range``), for a push and a realtime commit alike;
the JAX controller reads the range its segment builder recorded from the
schema's time column alone.
"""

from __future__ import annotations

import logging
import threading
import time

from typing import Dict, List, Optional

from pinot_tpu_torch.controller.assignment import (
    BalancedSegmentAssignment,
    ReplicaGroupSegmentAssignment,
    SegmentAssignment,
    assignment_for_table,
    compute_instance_partitions,
)
from pinot_tpu_torch.controller.completion import SegmentCompletionManager
from pinot_tpu_torch.controller.llc import (
    LLCRealtimeSegmentManager,
    parse_llc_name,
)
from pinot_tpu_torch.controller.state import (
    ONLINE,
    ClusterStateStore,
    InstanceInfo,
    SegmentZKMetadata,
    segment_time_range,
)
from pinot_tpu_torch.ingestion.stream import StreamOffset
from pinot_tpu_torch.segment.metadata import SegmentMetadata
from pinot_tpu_torch.spi.filesystem import MemoryDeepStore
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.table import (
    TableConfig,
    TableType,
    table_type_from_name,
)

log = logging.getLogger(__name__)


class Controller:
    """Single-controller deployment (the reference's lead controller)."""

    def __init__(self, store: Optional[ClusterStateStore] = None,
                 controller_id: str = "controller_0",
                 llc_seed: Optional[str] = None):
        self.store = store or ClusterStateStore()
        self.deep_store = MemoryDeepStore()
        self.controller_id = controller_id
        self.llc = LLCRealtimeSegmentManager(self.store, seed=llc_seed)
        self.completion = SegmentCompletionManager(
            num_replicas_provider=self._num_replicas_for_segment,
            commit_handler=self._on_segment_commit,
            deep_store=self.deep_store, table_of=self._table_of)
        # segment -> table for the FSM, filled by add_table, commits and
        # validation from several threads
        self._lock = threading.Lock()
        self._segment_tables: Dict[str, str] = {}  # guarded-by: _lock
        self.store.register_instance(
            InstanceInfo(controller_id, "CONTROLLER"))

    # -- schema / table management ------------------------------------------
    def add_schema(self, schema: Schema) -> None:
        self.store.add_schema(schema)

    def add_table(self, config: TableConfig) -> None:
        """Validate, create the IdealState, for replica-group routing store
        the instance partitions, and for a REALTIME table create one
        CONSUMING segment per stream partition."""
        name = config.table_name_with_type
        if config.table_type is TableType.REALTIME \
                and config.stream_config is None:
            raise ValueError("realtime table needs a stream config")
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
        if config.table_type is TableType.REALTIME:
            consuming = self.llc.setup_new_table(name)
            with self._lock:
                for seg in consuming:
                    self._segment_tables[seg] = name

    def update_table(self, config: TableConfig) -> None:
        """Replace an existing table's config."""
        name = config.table_name_with_type
        if self.store.get_table_config(name) is None:
            raise KeyError(f"no such table {name}")
        self.store.add_table_config(config)

    def delete_table(self, name_with_type: str) -> None:
        """Drop the table, its segments' metadata, its deep-store entries
        and its segments' completion FSMs (a table made again under the
        name may reuse a segment name)."""
        segments = self.store.segment_names(name_with_type)
        self.store.delete_table(name_with_type)
        self.deep_store.delete_table(name_with_type)
        with self._lock:
            for seg in segments:
                self._segment_tables.pop(seg, None)
        for seg in segments:
            self.completion.forget(seg)

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

    # -- segment completion ---------------------------------------------------
    def _num_replicas_for_segment(self, segment_name: str) -> int:
        table = self._table_of(segment_name)
        if table:
            ideal = self.store.get_ideal_state(table)
            if segment_name in ideal:
                return max(len(ideal[segment_name]), 1)
        return 1

    def _table_of(self, segment_name: str) -> Optional[str]:
        with self._lock:
            t = self._segment_tables.get(segment_name)
        if t:
            return t
        try:
            raw, _, _ = parse_llc_name(segment_name)
        except ValueError:
            return None
        name = raw + "_REALTIME"
        if self.store.get_table_config(name) is None:
            return None
        with self._lock:
            self._segment_tables[segment_name] = name
        return name

    def _on_segment_commit(self, segment_name: str, instance: str,
                           offset: StreamOffset, location: str,
                           metadata: SegmentMetadata) -> None:
        """The completion FSM's commit handler: the segment goes ONLINE
        and the next sequence opens."""
        table = self._table_of(segment_name)
        if table is None:
            raise KeyError(f"cannot resolve table for {segment_name}")
        new_consuming = self.llc.commit_segment(
            table, segment_name, offset, location, metadata)
        with self._lock:
            self._segment_tables[new_consuming] = table

    def run_realtime_validation(self) -> List[str]:
        """Recreate each realtime table's dead CONSUMING segments
        (RealtimeSegmentValidationManager); -> the new segments."""
        created = []
        for table in self.store.table_names():
            if table_type_from_name(table) is TableType.REALTIME:
                fresh = self.llc.ensure_all_partitions_consuming(table)
                with self._lock:
                    for seg in fresh:
                        self._segment_tables[seg] = table
                created.extend(fresh)
        return created

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
