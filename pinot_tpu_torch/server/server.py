"""Server instance: segment hosting and instance-level query execution.

Counterpart of ``pinot_tpu/server/server.py`` (``ServerInstance`` :49):
the server registers itself in the cluster state store, watches the
IdealState, reconciles its assigned segments, reports ExternalView
states, and answers instance query requests through its scheduler into
``ServerQueryExecutor.execute_instance``. The transitions: OFFLINE ->
ONLINE fetches the segment from its cluster's deep store and hosts it;
OFFLINE -> CONSUMING starts a consumer thread for the segment's stream
partition at its start offset, negotiating its commit through the
server's completion protocol (the controller's completion FSM in a
cluster); the consumer's end seals the segment (COMMITTED: its own seal;
KEEP: it seals its own rows; DISCARD: it fetches the committer's seal)
and swaps it in under running queries, then picks up the next sequence;
unassigned drops the segment (and stops its consumer). An upsert table
gets one upsert manager a server, comparing on the config's comparison
column, else the table's time column. Hosting a segment prefetches it to
the card in the background (``segment_added``), and a seal evicts the
consuming segment's resident first; dropping a segment evicts it
(``segment_removed``). Every failure inside a query travels in-band as an
exception ``DataTable``, Pinot's contract; the broker reports it as a
partial result.

Tracing and telemetry (JAX :94-106, :442-449, :602-645): the server binds
the process decision ledger and telemetry center to its registry, gives
the flight recorder its scheduler state, samples its scheduler's queue
depth, hangs the scheduler-queue wait under a traced query's root as its
first child (``SchedulerQueue``), and serves ``queries_debug``,
``telemetry_debug``, ``slo_debug``, ``freshness_debug`` and
``flightrecorder_debug``.

The executor defaults to ``ServerQueryExecutor(device="cuda")``; a caller
on the CPU passes ``executor=ServerQueryExecutor(device="cpu")``. Not part
of this module: reload (it rewrites segments on disk, ROADMAP item 7),
``table_size`` (on-disk bytes), the kernel-blocklist debug view, and the
REST routes of the debug views (they wait for the transport).
"""

from __future__ import annotations

import logging
import threading
import time

from typing import Any, Dict, List, Optional

from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.common.tracing import LEDGER, attach_root_child
from pinot_tpu_torch.controller.state import (
    CONSUMING,
    OFFLINE,
    ONLINE,
    ClusterStateStore,
    InstanceInfo,
)
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.engine.mutable_staging import resident_name
from pinot_tpu_torch.engine.pruner import prune_segments
from pinot_tpu_torch.ingestion.realtime import (
    ConsumerState,
    RealtimeSegmentDataManager,
    SegmentCompletionProtocol,
)
from pinot_tpu_torch.ingestion.stream import StreamOffset
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.segment.upsert import table_upsert_manager
from pinot_tpu_torch.server.data_manager import (
    InstanceDataManager,
    RealtimeTableDataManager,
)
from pinot_tpu_torch.server.scheduler import make_scheduler
from pinot_tpu_torch.spi.config import CommonConstants
from pinot_tpu_torch.spi.filesystem import MemoryDeepStore
from pinot_tpu_torch.spi.metrics import (
    MetricsRegistry,
    ServerMeter,
    ServerQueryPhase,
)
from pinot_tpu_torch.spi.table import TableType, table_type_from_name

log = logging.getLogger(__name__)


class ServerInstance:
    """One query server. The broker calls ``execute_query`` in process
    (the embedded-cluster mode)."""

    def __init__(self, instance_id: str, store: ClusterStateStore,
                 deep_store: MemoryDeepStore,
                 completion_protocol: Optional[
                     SegmentCompletionProtocol] = None,
                 executor: Optional[ServerQueryExecutor] = None,
                 config=None):
        self.instance_id = instance_id
        self.store = store
        self.deep_store = deep_store
        self.completion_protocol = completion_protocol
        self.executor = executor or ServerQueryExecutor(config=config)
        # runner pool from pinot.server.query.runner.threads; the policy
        # from pinot.server.query.scheduler.policy (default SEWF)
        policy = (config.get(CommonConstants.SCHEDULER_POLICY_KEY,
                             CommonConstants.DEFAULT_SCHEDULER_POLICY)
                  if config is not None
                  else CommonConstants.DEFAULT_SCHEDULER_POLICY)
        self.scheduler = make_scheduler(policy, config=config)
        self.metrics = MetricsRegistry(role="server")
        # segment lifecycle -> residency on the card: adds prefetch,
        # removals evict
        self.data_manager = InstanceDataManager(listener=self)
        self.executor.residency.bind_metrics(self.metrics)
        launcher = getattr(self.executor, "launcher", None)
        if launcher is not None:    # the batch executor's coalescing
            launcher.bind_metrics(self.metrics)
        self.executor.admission.bind_metrics(self.metrics)
        # the decision ledger as the labeled decision_declined_total
        # family, and the process telemetry's histogram and SLO families,
        # on this server's /metrics
        LEDGER.bind_metrics(self.metrics)
        TELEMETRY.configure(config)
        self.metrics.bind_telemetry(TELEMETRY)
        TELEMETRY.recorder.register_provider("scheduler",
                                             self.scheduler_debug)
        self._queue_gauge = f"scheduler.queue_depth.{instance_id}"
        TELEMETRY.track_gauge(self._queue_gauge,
                              lambda: float(self.scheduler.queue_depth()))
        self._started = False
        self._queries_enabled = False
        self._reconcile_lock = threading.RLock()
        self._upsert_managers: Dict[str, Any] = {}  # guarded-by: _reconcile_lock
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------
    def start(self, heartbeat_interval_s: float = 0.0) -> None:
        # a restart keeps the tenant tags an operator set
        prior = self.store.get_instance(self.instance_id)
        self.store.register_instance(
            InstanceInfo(self.instance_id, "SERVER", port=0,
                         tags=(prior.tags if prior is not None
                               else ["DefaultTenant"])))
        # replay the current assignments, then follow changes (the Helix
        # participant registration and state-transition replay)
        self.store.watch("idealstate/", self._on_ideal_state_change)
        self.store.watch("tables/", self._on_table_config_change)
        for path in self.store.children("idealstate"):
            self._reconcile_table(path.split("/", 1)[1])
        self._started = True
        self._queries_enabled = True
        if heartbeat_interval_s > 0:
            # the ephemeral-znode keepalive: the controller's liveness
            # check marks the instance dead when these stop
            self._hb_stop = threading.Event()

            def beat():
                while not self._hb_stop.wait(heartbeat_interval_s):
                    try:
                        self.store.touch_instance(self.instance_id)
                    except Exception:
                        log.exception("[%s] heartbeat failed",
                                      self.instance_id)

            self.store.touch_instance(self.instance_id)
            self._hb_thread = threading.Thread(
                target=beat, daemon=True,
                name=f"heartbeat-{self.instance_id}")
            self._hb_thread.start()

    def shutdown(self) -> None:
        """Disable queries, drain, unregister."""
        self._queries_enabled = False
        if self._hb_stop is not None:
            self._hb_stop.set()
            # join before marking dead: a touch in flight would revive it
            self._hb_thread.join(timeout=5)
        TELEMETRY.untrack_gauge(self._queue_gauge)
        for name, fn in (("scheduler", self.scheduler_debug),
                         ("residency", self.executor.residency.snapshot),
                         ("admission", self.executor.admission.snapshot)):
            TELEMETRY.recorder.unregister_provider(name, fn)
        self.scheduler.shutdown()
        self.data_manager.shutdown()
        self.executor.close()
        self.executor.residency.close()
        self.store.set_instance_alive(self.instance_id, False)

    # -- segment lifecycle -> residency (the data-manager listener) -----------
    def segment_added(self, table: str, segment) -> None:
        """Prefetch hook: stage a newly hosted segment in the background,
        so the table's first query pays no host-to-device copy (the
        prefetch stops at the budget instead of evicting, and skips a
        consuming segment). A sealed segment that replaces a consuming one
        makes the consuming resident's chunks dead weight: they go first
        (a query in flight keeps its snapshot)."""
        if not getattr(segment, "is_mutable", False):
            self.executor.residency.evict(resident_name(segment.segment_name))
        self.executor.residency.prefetch(segment)

    def segment_released(self, table: str, segment) -> None:
        """Release hook: a replaced or removed consuming segment's last
        reader let go, so its resident goes too (a query that acquired it
        before the seal may have staged it again after ``segment_added``
        evicted it)."""
        if getattr(segment, "is_mutable", False):
            self.executor.residency.evict(resident_name(segment.segment_name))

    def segment_removed(self, table: str, segment_name: str) -> None:
        """Eviction hook: an unassigned segment's device arrays go (its
        refcount protects the queries still reading it)."""
        self.executor.evict_segment(segment_name)

    # -- state transitions -----------------------------------------------------
    def _on_ideal_state_change(self, path: str, value) -> None:
        if not self._started:
            return
        table = path.split("/", 1)[1]
        try:
            self._reconcile_table(table)
        except Exception:
            log.exception("[%s] reconcile failed for %s",
                          self.instance_id, table)

    def _on_table_config_change(self, path: str, value) -> None:
        """A deleted table's config: drop what is left of it here (its
        IdealState may have gone while the config still stood)."""
        if self._started and value is None:
            self._on_ideal_state_change(path, value)

    def _reconcile_table(self, table: str) -> None:
        with self._reconcile_lock:
            self._reconcile_table_locked(table)

    def _upsert_manager_for_locked(self, table: str):
        """The upsert manager of an upsert-enabled realtime table, one a
        server; None for another table, or while its config or schema is
        not visible yet (decided again at a later reconcile)."""
        if table in self._upsert_managers:
            return self._upsert_managers[table]
        cfg = self.store.get_table_config(table)
        if cfg is None:
            return None
        schema = self.store.get_schema(cfg.table_name)
        if schema is None:
            return None
        mgr = table_upsert_manager(cfg, schema,
                                   cfg.validation_config.time_column_name)
        self._upsert_managers[table] = mgr
        return mgr

    def _reconcile_table_locked(self, table: str) -> None:
        if self.store.get_table_config(table) is None:
            # deleted: its manager, consumers and upsert keys go with it
            self.data_manager.remove(table)
            self._upsert_managers.pop(table, None)
            return
        ideal = self.store.get_ideal_state(table)
        realtime = table_type_from_name(table) is TableType.REALTIME
        tdm = self.data_manager.get_or_create(
            table, realtime=realtime,
            upsert_manager=(self._upsert_manager_for_locked(table)
                            if realtime else None))
        my_segments = {seg: states[self.instance_id]
                       for seg, states in ideal.items()
                       if self.instance_id in states}
        # drop the segments no longer assigned here
        for seg in tdm.segment_names():
            if seg not in my_segments:
                tdm.remove_segment(seg)
                self.store.report_instance_state(table, seg,
                                                 self.instance_id, OFFLINE)
        for seg, target in my_segments.items():
            if target == ONLINE:
                self._ensure_online(table, tdm, seg)
            elif target == CONSUMING:
                self._ensure_consuming(table, tdm, seg)

    def _ensure_online(self, table: str, tdm, seg: str) -> None:
        realtime = isinstance(tdm, RealtimeTableDataManager)
        if realtime and tdm.consuming_manager(seg) is not None:
            # the flip to ONLINE came before this replica's consumer
            # ended: its terminal callback swaps the seal in
            return
        if tdm.has_segment(seg):
            return
        md = self.store.get_segment_metadata(table, seg)
        if md is None or not md.download_url:
            log.warning("[%s] no download url for %s/%s",
                        self.instance_id, table, seg)
            return
        try:
            segment = self.deep_store.fetch_segment(md.download_url)
        except Exception:
            log.exception("[%s] deep-store fetch failed for %s/%s (%s)",
                          self.instance_id, table, seg, md.download_url)
            return
        if realtime:
            # an upsert table registers the fetched segment's keys
            tdm.on_sealed(seg, segment, partition=md.partition,
                          fetched=True)
        else:
            tdm.add_segment(segment)
        self.store.report_instance_state(table, seg, self.instance_id, ONLINE)

    def _ensure_consuming(self, table: str, tdm, seg: str) -> None:
        if tdm.consuming_manager(seg) is not None or tdm.has_segment(seg):
            return
        cfg = self.store.get_table_config(table)
        schema = (self.store.get_schema(cfg.table_name)
                  if cfg is not None else None)
        md = self.store.get_segment_metadata(table, seg)
        if schema is None or md is None:
            log.warning("[%s] missing config for consuming %s/%s",
                        self.instance_id, table, seg)
            return
        mgr = RealtimeSegmentDataManager(
            seg, cfg, schema, partition=md.partition or 0,
            start_offset=StreamOffset.parse(md.start_offset or "0"),
            protocol=self.completion_protocol,
            instance_id=self.instance_id,
            upsert_manager=tdm.upsert_manager,
            on_terminal=lambda m, t=table, td=tdm: self._on_consumer_done(
                t, td, m))
        tdm.add_consuming(mgr)
        self.store.report_instance_state(table, seg, self.instance_id,
                                         CONSUMING)
        mgr.start()

    def _on_consumer_done(self, table: str, tdm, mgr) -> None:
        """A consumer's terminal state: COMMITTED swaps its own seal in,
        RETAINING (KEEP) seals its own rows at the committed offset,
        DISCARDED fetches the committer's seal, ERROR stays CONSUMING in
        the ExternalView (the segment never comes ONLINE here)."""
        seg = mgr.segment_name
        if tdm.consuming_manager(seg) is not mgr:
            return      # unassigned or replaced meanwhile: do not revive
        try:
            if mgr.state is ConsumerState.COMMITTED:
                tdm.on_sealed(seg, mgr.sealed_segment)
            elif mgr.state is ConsumerState.RETAINING:
                tdm.on_sealed(seg, mgr.build_segment())
            elif mgr.state is ConsumerState.DISCARDED:
                zk = self.store.get_segment_metadata(table, seg)
                if zk is None or not zk.download_url:
                    # the committer's metadata is not visible yet: drop
                    # the consumer, a later reconcile fetches it ONLINE
                    tdm.drop_consumer(seg)
                    tdm.remove_segment(seg)
                    return
                tdm.on_sealed(seg, self.deep_store.fetch_segment(
                    zk.download_url), fetched=True)
            else:
                log.error("[%s] consumer for %s ended in %s",
                          self.instance_id, seg, mgr.state)
                return
            self.store.report_instance_state(table, seg, self.instance_id,
                                             ONLINE)
            # pick up the next CONSUMING sequence now
            self._reconcile_table(table)
        except Exception:
            log.exception("[%s] seal handling failed for %s",
                          self.instance_id, seg)

    # -- query path (InstanceRequestHandler -> scheduler -> executor) ---------
    def execute_query(self, ctx: QueryContext, table: str,
                      segment_names: Optional[List[str]] = None
                      ) -> DataTable:
        if not self._queries_enabled:
            return DataTable.for_exception(
                f"server {self.instance_id} is shut down")
        submit_t = time.perf_counter()
        # the shape key feeds the SEWF policy's per-shape latency EWMAs:
        # same table and SQL text, same expected work
        future = self.scheduler.submit(
            lambda: self._execute(ctx, table, segment_names, submit_t),
            table=table, shape=(table, ctx.sql))
        return future.result()

    def _execute(self, ctx: QueryContext, table: str,
                 segment_names: Optional[List[str]],
                 submit_t: float) -> DataTable:
        wait_ms = (time.perf_counter() - submit_t) * 1e3
        self.metrics.timer(ServerQueryPhase.SCHEDULER_WAIT).update_ms(wait_ms)
        self.metrics.meter(ServerMeter.QUERIES).mark()
        tdm = self.data_manager.get(table)
        if tdm is None:
            self.metrics.meter(ServerMeter.QUERY_EXCEPTIONS).mark()
            return DataTable.for_exception(
                f"table {table} not hosted on {self.instance_id}")
        acquired = tdm.acquire_segments(segment_names)
        t0 = time.perf_counter()
        try:
            segments = [s.segment for s in acquired]
            if not segments:
                self.metrics.meter(ServerMeter.QUERY_EXCEPTIONS).mark()
                return DataTable.for_exception(
                    f"no segments of {table} on {self.instance_id}")
            dt = self.executor.execute_instance(ctx, segments)
            exec_ms = (time.perf_counter() - t0) * 1e3
            # the phase timings travel in the DataTable's stats
            dt.stats.add_phase_ms(ServerQueryPhase.SCHEDULER_WAIT, wait_ms)
            dt.stats.add_phase_ms(ServerQueryPhase.QUERY_EXECUTION, exec_ms)
            if dt.stats.spans:
                # the scheduler wait came before the executor opened the
                # tree: the root's first child, all queue
                attach_root_child(dt.stats, "SchedulerQueue",
                                  wall_ms=wait_ms, queue_ms=wait_ms,
                                  front=True)
            self.metrics.timer(
                ServerQueryPhase.QUERY_EXECUTION).update_ms(exec_ms)
            self.metrics.meter(ServerMeter.DOCS_SCANNED).mark(
                dt.stats.num_docs_scanned)
            self.metrics.meter(ServerMeter.SEGMENTS_PRUNED).mark(
                dt.stats.num_segments_pruned)
            return dt
        except Exception as e:  # query errors travel in the DataTable
            log.debug("[%s] query failed", self.instance_id, exc_info=True)
            self.metrics.meter(ServerMeter.QUERY_EXCEPTIONS).mark()
            return DataTable.for_exception(str(e))
        finally:
            tdm.release_segments(acquired)

    def execute_query_streaming(self, ctx: QueryContext, table: str,
                                segment_names: Optional[List[str]] = None):
        """Selection queries yield one DataTable per kept segment, so the
        broker can stop pulling once it holds LIMIT rows; other shapes
        yield the one combined block."""
        if not self._queries_enabled:
            yield DataTable.for_exception(
                f"server {self.instance_id} is shut down")
            return
        if not ctx.is_selection:
            yield self.execute_query(ctx, table, segment_names)
            return
        tdm = self.data_manager.get(table)
        if tdm is None:
            yield DataTable.for_exception(
                f"table {table} not hosted on {self.instance_id}")
            return
        acquired = tdm.acquire_segments(segment_names)
        try:
            if not acquired:
                yield DataTable.for_exception(
                    f"no segments of {table} on {self.instance_id}")
                return
            # prune once over the acquired set: execute_instance on one
            # segment at a time would keep each prunable one
            kept = prune_segments(
                ctx, [h.segment for h in acquired]) or \
                [acquired[0].segment]
            for segment in kept:
                yield self.executor.execute_instance(ctx, [segment])
        except Exception as e:  # noqa: BLE001 - errors travel in-band
            log.debug("[%s] streaming query failed", self.instance_id,
                      exc_info=True)
            yield DataTable.for_exception(str(e))
        finally:
            tdm.release_segments(acquired)

    # -- admin -----------------------------------------------------------------
    def hosted_tables(self) -> List[str]:
        return self.data_manager.table_names()

    def hosted_segments(self, table: str) -> List[str]:
        tdm = self.data_manager.get(table)
        return tdm.segment_names() if tdm else []

    def evict_staged(self, segment_name: str) -> Dict[str, Any]:
        """Force one staged resident off the card; reports what remains."""
        self.executor.evict_segment(segment_name)
        return {"evicted": segment_name,
                "stagedBytes": self.executor.residency.staged_bytes()}

    def demote_staged(self, name: str) -> Dict[str, Any]:
        """Force one resident to the host-RAM tier: the next query promotes
        it with a plain copy instead of staging it again. Refused
        (``demoted`` False) while a query in flight pins it."""
        residency = self.executor.residency
        ok = residency.demote(name)
        return {"demoted": bool(ok), "name": name,
                "stagedBytes": residency.staged_bytes(),
                "hostBytes": residency.host_bytes()}

    def launch_debug(self) -> Dict[str, Any]:
        """Launch coalescing: requests against launches, coalesced and
        deduped counts, queue waits (disabled for the per-segment
        executor, which has no launcher)."""
        launcher = getattr(self.executor, "launcher", None)
        if launcher is None:
            return {"enabled": False}
        out: Dict[str, Any] = {"enabled": True}
        out.update(launcher.stats_snapshot())
        return out

    def scheduler_debug(self) -> Dict[str, Any]:
        """The scheduler's policy and queue, the admission gate, the launch
        window and the single-flight counters."""
        out: Dict[str, Any] = {"scheduler": self.scheduler.stats_snapshot(),
                               "admission": self.executor.admission
                               .snapshot()}
        launcher = getattr(self.executor, "launcher", None)
        if launcher is not None:
            snap = launcher.stats_snapshot()
            out["launchWindow"] = {
                k: snap[k] for k in
                ("windowWaits", "windowGathered", "windowLastMs")}
        out["kernelFlight"] = self.executor.kernel_flight.snapshot()
        out["queryFlight"] = self.executor.query_flight.snapshot()
        return out

    def memory_debug(self) -> Dict[str, Any]:
        """Byte-accurate residency on the card and in host RAM: per
        resident its bytes and pins, plus the budgets and counters."""
        return self.executor.residency.snapshot()

    def queries_debug(self) -> Dict[str, Any]:
        """The executor's running queries (sql, phase, elapsed, pins
        held), the ring of completed ones and the slow-query log, whose
        entries keep their whole span trees
        (``pinot.server.query.slow.threshold.ms``)."""
        out: Dict[str, Any] = {"instance": self.instance_id}
        out.update(self.executor.queries.snapshot())
        return out

    def telemetry_debug(self) -> Dict[str, Any]:
        """The process telemetry: each (table, phase) histogram with its
        lifetime and sliding quantiles, the gauge rings and the anomaly
        events."""
        return TELEMETRY.snapshot()

    def slo_debug(self) -> Dict[str, Any]:
        """Each table's objectives with their short- and long-window burn
        rates."""
        return TELEMETRY.slo_snapshot()

    def freshness_debug(self) -> Dict[str, Any]:
        """Each realtime table's ingest-to-queryable histogram (a sample
        a row: its append to the first watermark that serves it) and its
        freshness burn where an objective is set."""
        return TELEMETRY.freshness_snapshot()

    def flightrecorder_debug(self) -> Dict[str, Any]:
        """The flight recorder: the frozen bundles, the last one whole,
        the rings' occupancy and the anomaly-event totals."""
        return TELEMETRY.recorder.snapshot()
