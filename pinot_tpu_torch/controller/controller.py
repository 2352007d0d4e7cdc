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
recreates a partition's dead CONSUMING segment. ``update_table`` then
``reload_table`` (JAX :131) asks every server hosting the table to add
the indexes its config gained to the segments on disk (the server's
reload transition).

The segment lifecycle (JAX :189-205, :276-452): the lineage protocol
(``start_replace_segments`` / ``end_replace_segments`` /
``revert_replace_segments``, ``controller/lineage.py``), which minion
tasks follow so that no query sees both a merge's inputs and its outputs
(``end_replace_segments`` flips the entry only once every output is
ONLINE on its live replicas, and reverts it at ``replace_timeout_s``;
JAX's flips at once);
``rebalance_table``, make-before-break (every target replica added, the
ExternalView awaited, then the old replicas dropped); and the periodic
tasks, each taking ``now_ms`` so a test can drive a fake clock:
``run_retention_manager`` (lineage cleanup, then the segments past the
table's retention deleted), ``run_segment_status_check``,
``run_task_generation`` (the minion task generators, ``task_manager``,
``controller/tasks.py``) and ``run_segment_relocation`` (aged segments to
their tier's servers, ``controller/tiers.py``). ``start_periodic_tasks``
runs them with the liveness check and the realtime validation on a
thread of its own, which ``stop`` joins. A deleted segment leaves its
servers and their cards; its files stay where they are. A
segment pushed as a directory is located by its ``file://`` URL; the
controller also owns its cluster's in-memory deep store
(``spi/filesystem.py`` ``MemoryDeepStore``) for segments pushed as
objects, which its servers fetch from and the completion FSM keeps
in-memory realtime seals in; deleting a segment or a table drops it
there too (files stay where they are, as in JAX).

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
    compute_target_assignment,
    rebalance_steps,
)
from pinot_tpu_torch.controller.completion import SegmentCompletionManager
from pinot_tpu_torch.controller.llc import (
    LLCRealtimeSegmentManager,
    parse_llc_name,
)
from pinot_tpu_torch.controller.lineage import SegmentLineageManager
from pinot_tpu_torch.controller.state import (
    CONSUMING,
    OFFLINE,
    ONLINE,
    ClusterStateStore,
    InstanceInfo,
    SegmentZKMetadata,
    segment_time_range,
)
from pinot_tpu_torch.ingestion.stream import StreamOffset
from pinot_tpu_torch.segment.metadata import SegmentMetadata
from pinot_tpu_torch.spi.filesystem import MemoryDeepStore
from pinot_tpu_torch.spi.metrics import MetricsRegistry
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.controller.tasks import PinotTaskManager
from pinot_tpu_torch.controller.tiers import SegmentRelocator
from pinot_tpu_torch.spi.table import (
    TableConfig,
    TableType,
    table_type_from_name,
)

log = logging.getLogger(__name__)

_RETENTION_UNIT_MS = {
    "MILLISECONDS": 1, "SECONDS": 1000, "MINUTES": 60_000,
    "HOURS": 3_600_000, "DAYS": 86_400_000,
}


class Controller:
    """Single-controller deployment (the reference's lead controller)."""

    def __init__(self, store: Optional[ClusterStateStore] = None,
                 controller_id: str = "controller_0",
                 llc_seed: Optional[str] = None):
        self.store = store or ClusterStateStore()  # race-ok: delegates_locking
        self.metrics = MetricsRegistry(role="controller")
        self.metrics.gauge("tables", lambda: len(self.store.table_names()))
        self.metrics.gauge("segments", lambda: sum(
            len(self.store.segment_names(t))
            for t in self.store.table_names()))
        self.metrics.gauge("live_servers", lambda: len(
            self.store.instances("SERVER", only_alive=True)))
        self.deep_store = MemoryDeepStore()
        self.controller_id = controller_id
        self.task_manager = PinotTaskManager(self.store)
        self.lineage = SegmentLineageManager(self.store)
        #: how long ``end_replace_segments`` waits for the outputs to be
        #: served before it reverts the replacement
        self.replace_timeout_s = 60.0
        self.llc = LLCRealtimeSegmentManager(self.store, seed=llc_seed)
        self.completion = SegmentCompletionManager(
            num_replicas_provider=self._num_replicas_for_segment,
            commit_handler=self._on_segment_commit,
            deep_store=self.deep_store, table_of=self._table_of)
        # segment -> table for the FSM, filled by add_table, commits and
        # validation from several threads
        self._lock = threading.Lock()
        self._segment_tables: Dict[str, str] = {}  # guarded-by: _lock
        self._periodic_stop = threading.Event()
        self._periodic_thread: Optional[threading.Thread] = None
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

    def reload_table(self, name_with_type: str) -> None:
        """Ask every server hosting the table to reload its segments,
        adding the indexes its config now names (``reloadrequests/<table>``
        in the state store, which the servers watch)."""
        if self.store.get_table_config(name_with_type) is None:
            raise KeyError(f"no such table {name_with_type}")
        self.store.update(f"reloadrequests/{name_with_type}",
                          lambda v: (v or 0) + 1)

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
            status=ONLINE, download_url=download_url, crc=metadata.crc,
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

    # -- segment lineage ------------------------------------------------------
    def start_replace_segments(self, table: str, segments_from: List[str],
                               segments_to: List[str]) -> str:
        return self.lineage.start_replace(table, segments_from, segments_to)

    def end_replace_segments(self, table: str, entry_id: str) -> None:
        """Flip the entry COMPLETED once every output is ONLINE in the
        ExternalView on each of its live assigned replicas, so a query
        routed after the flip finds the outputs served; past
        ``replace_timeout_s`` the entry is reverted (the inputs stay
        visible) and ``TimeoutError`` raised. The JAX controller flips at
        once (``pinot_tpu/minion/tasks.py:146`` calls it right after the
        push)."""
        outputs = next((e.segments_to for e in self.lineage.entries(table)
                        if e.entry_id == entry_id), None)
        if outputs is None:
            raise KeyError(f"no lineage entry {entry_id} for {table}")
        deadline = time.monotonic() + self.replace_timeout_s
        while not self._outputs_online(table, outputs):
            if time.monotonic() >= deadline:
                self.lineage.revert_replace(table, entry_id)
                raise TimeoutError(
                    f"lineage {entry_id}: outputs of {table} not ONLINE "
                    f"after {self.replace_timeout_s}s; reverted")
            time.sleep(0.01)
        self.lineage.end_replace(table, entry_id)

    def _outputs_online(self, table: str, segments: List[str]) -> bool:
        ideal, ev = self.store.get_many(f"idealstate/{table}",
                                        f"externalview/{table}")
        ideal, ev = ideal or {}, ev or {}
        alive = {i.instance_id for i in self.store.instances(
            "SERVER", only_alive=True)}
        for seg in segments:
            online = {i for i, st in ev.get(seg, {}).items()
                      if st == ONLINE}
            want = {i for i in ideal.get(seg, {}) if i in alive}
            if not online or not want <= online:
                return False
        return True

    def revert_replace_segments(self, table: str, entry_id: str) -> None:
        self.lineage.revert_replace(table, entry_id)

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

    # -- rebalance ------------------------------------------------------------
    def rebalance_table(self, table: str, dry_run: bool = False,
                        convergence_timeout_s: float = 30.0,
                        best_effort: bool = True) -> List[Dict]:
        """Move the table's segments to the assignment its live servers
        now give, make-before-break: after each step but the last, wait
        for the ExternalView to converge before the old replicas are
        dropped. With ``best_effort`` a convergence timeout goes on (a
        warning); without it the rebalance raises and leaves the added
        replicas in place. -> the steps (the only output of a
        ``dry_run``)."""
        servers, replication = assignment_for_table(self.store, table)
        current = self.store.get_ideal_state(table)
        # a replica-group table recomputes and stores its instance
        # partitions, so the target and the broker's selectors agree
        groups = None
        if self.store.get_instance_partitions(table) is not None and servers:
            groups = compute_instance_partitions(servers, replication)
            if not dry_run:
                self.store.set_instance_partitions(table, groups)
        target = compute_target_assignment(
            current, servers, replication, groups=groups,
            domains={i.instance_id: i.failure_domain
                     for i in self.store.instances("SERVER")
                     if i.failure_domain})
        steps = rebalance_steps(current, target)
        if dry_run:
            return steps
        for i, step in enumerate(steps):
            self.store.set_ideal_state(table, step)
            if i == len(steps) - 1:
                break
            if not self._wait_external_view(table, step,
                                            convergence_timeout_s):
                if not best_effort:
                    raise RuntimeError(
                        f"rebalance of {table} stalled: ExternalView did not "
                        f"converge within {convergence_timeout_s}s")
                log.warning("rebalance %s: ExternalView convergence timeout, "
                            "going on best-effort", table)
        return steps

    def _wait_external_view(self, table: str, ideal: Dict,
                            timeout_s: float, poll_s: float = 0.05) -> bool:
        deadline = time.monotonic() + timeout_s
        while True:
            ev = self.store.get_external_view(table)
            if all(ev.get(seg, {}).get(inst) == st
                   for seg, m in ideal.items()
                   for inst, st in m.items() if st != OFFLINE):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    # -- periodic tasks -------------------------------------------------------
    def run_retention_manager(self, now_ms: Optional[int] = None
                              ) -> List[str]:
        """Lineage cleanup of every table, then delete the segments whose
        end time is past the table's retention. -> the deleted segments."""
        now_ms = now_ms or int(time.time() * 1000)
        deleted = []
        for table in self.store.table_names():
            self.lineage.cleanup(table, now_ms=now_ms)
            cfg = self.store.get_table_config(table)
            vc = cfg.validation_config
            if not vc.retention_time_unit or not vc.retention_time_value:
                continue
            unit_ms = _RETENTION_UNIT_MS.get(vc.retention_time_unit.upper())
            if unit_ms is None:
                continue
            cutoff = now_ms - vc.retention_time_value * unit_ms
            time_unit_ms = _RETENTION_UNIT_MS.get(vc.time_type.upper(), 1)
            for md in self.store.segment_metadata_list(table):
                if md.status == CONSUMING or md.end_time is None:
                    continue
                if md.end_time * time_unit_ms < cutoff:
                    self.delete_segment(table, md.segment_name)
                    deleted.append(md.segment_name)
        return deleted

    def run_segment_status_check(self) -> Dict[str, Dict[str, int]]:
        """Per table: segments, replicas the IdealState expects, and those
        the ExternalView does not show (the reference's
        SegmentStatusChecker)."""
        report = {}
        for table in self.store.table_names():
            ideal = self.store.get_ideal_state(table)
            ev = self.store.get_external_view(table)
            missing = sum(1 for seg, m in ideal.items()
                          for inst, st in m.items()
                          if st != OFFLINE and ev.get(seg, {}).get(inst) != st)
            report[table] = {
                "segments": len(ideal),
                "replicasExpected": sum(len(m) for m in ideal.values()),
                "replicasMissing": missing,
            }
        return report

    def run_task_generation(self, now_ms: Optional[int] = None) -> List[str]:
        """Minion tasks for every table with a ``task_config``. -> the new
        task ids."""
        return self.task_manager.generate_tasks(now_ms=now_ms)

    def run_segment_relocation(self, now_ms: Optional[int] = None
                               ) -> List[str]:
        """Aged segments to their tier's servers. -> the moved segments."""
        relocator = SegmentRelocator(self.store)
        moved = []
        for table in self.store.table_names():
            moved.extend(relocator.relocate_table(table, now_ms=now_ms))
        return moved

    def start_periodic_tasks(self, interval_s: float = 5.0) -> None:
        """Run the periodic tasks every ``interval_s`` on a thread of
        their own until ``stop``."""
        if self._periodic_thread is not None:
            return

        def loop():
            while not self._periodic_stop.wait(interval_s):
                try:
                    self.run_liveness_check()
                    self.run_retention_manager()
                    self.run_realtime_validation()
                    self.run_task_generation()
                    self.run_segment_relocation()
                except Exception:
                    log.exception("periodic task failed")

        self._periodic_stop.clear()
        self._periodic_thread = threading.Thread(
            target=loop, daemon=True, name="controller-periodic")
        self._periodic_thread.start()

    def stop(self) -> None:
        """Stop the periodic loop and join its thread."""
        self._periodic_stop.set()
        thread, self._periodic_thread = self._periodic_thread, None
        if thread is not None:
            thread.join(timeout=30)

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
