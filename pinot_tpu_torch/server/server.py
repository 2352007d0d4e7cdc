"""Server instance: segment hosting and instance-level query execution.

Counterpart of ``pinot_tpu/server/server.py`` (``ServerInstance`` :49):
the server registers itself in the cluster state store, watches the
IdealState, reconciles its assigned segments, reports ExternalView
states, and answers instance query requests through its scheduler into
``ServerQueryExecutor.execute_instance``. It registers the failure
domain ``spi/environment.py`` names (``PINOT_FAILURE_DOMAIN``, JAX
:118-127), which the controller's assignment spreads replicas across.
The transitions: OFFLINE -> ONLINE fetches the segment from the deep
store and hosts it (through ``spi/filesystem.py`` ``fetch_segment`` into
a directory it loads, JAX :279-300: a ``file://`` segment in place, an
``http(s)://`` or ``s3://`` one copied under
``<segment_dir>/<instance>/<table>``, where JAX's replicas share
``<segment_dir>/<table>``; a ``memory://`` one from its cluster's
``MemoryDeepStore`` as an object);
OFFLINE -> CONSUMING starts a consumer thread for the segment's stream
partition at its start offset, negotiating its commit through the
server's completion protocol (the controller's completion FSM in a
cluster); the consumer's end seals the segment (COMMITTED: its own seal;
KEEP: it seals its own rows; DISCARD: it fetches the committer's seal)
and swaps it in under running queries, then picks up the next sequence;
unassigned drops the segment (and stops its consumer). A segment of an
OFFLINE table pushed again under its name with another CRC (a refresh,
such as the minion's convert-to-raw) is fetched again and swapped in
under running queries; the residency manager, the plan cache and the
batches key a segment by its object, so nothing of the old one serves
after the swap (the JAX server keeps the copy it hosts). An upsert table
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
``flightrecorder_debug``; ``pallas_debug`` (JAX :647) the fused scan's
blocklist and preflight verdicts, and ``launch_debug`` beside the
launcher's counters the launches of the queries the server answered
(each query's own counts). A query asked for segments the server no
longer hosts reports how many (``numSegmentsMissing``), so the broker can
route it again.

A server with a ``segment_dir`` has its consumers write their seals
there (``<segment_dir>/<instance>/<table>/<segment>``), and a DISCARD
replica fetches the committer's directory. The reload transition
(``reloadrequests/<table>``, JAX :373-400) runs ``segment/preprocessor.py``
``reload_segment`` on every hosted segment that has a directory: the
missing indexes are added on disk and the segment swapped in again;
``reload_failures`` keeps the failures it logged. ``table_size`` reports
the bytes on disk of each hosted segment (JAX :515), and
``memory_debug`` the files mapped (``nativeMmapBuffers``, JAX :674-680).

The executor defaults to ``ServerQueryExecutor(device="cuda")``; a caller
on the CPU passes ``executor=ServerQueryExecutor(device="cpu")``. Not part
of this module: the REST routes of the debug views
(``transport/rest.py`` ``ServerAdminApi``).
"""

from __future__ import annotations

import copy
import logging
import os
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
from pinot_tpu_torch.engine.results import WIRE_COUNTERS
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
from pinot_tpu_torch.spi.environment import get_environment_provider
from pinot_tpu_torch.spi.filesystem import (
    SCHEME as MEMORY_SCHEME,
    MemoryDeepStore,
    fetch_segment,
)
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
                 config=None, segment_dir: Optional[str] = None):
        self.instance_id = instance_id
        #: where consumers write seals and remote segments land (None:
        #: seals stay in memory)
        self.segment_dir = segment_dir
        #: (table, segment, error) of each reload that failed
        self.reload_failures: List[tuple] = []
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
        # the launches of the queries answered here, by wire name
        self._launches: Dict[str, int] = {}  # guarded-by: _launch_lock
        self._launch_lock = threading.Lock()
        self._upsert_managers: Dict[str, Any] = {}  # guarded-by: _reconcile_lock
        # (table, segment) -> the pushed CRC an OFFLINE segment was fetched
        # at: a push under the name with another CRC is a refresh (a
        # reload changes the served CRC, not the pushed one)
        self._pushed_crc: Dict[tuple, int] = {}  # guarded-by: _reconcile_lock
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------
    def start(self, heartbeat_interval_s: float = 0.0) -> None:
        # a restart keeps the tenant tags an operator set
        prior = self.store.get_instance(self.instance_id)
        self.store.register_instance(
            InstanceInfo(self.instance_id, "SERVER", port=0,
                         tags=(prior.tags if prior is not None
                               else ["DefaultTenant"]),
                         failure_domain=get_environment_provider()
                         .failure_domain()))
        # replay the current assignments, then follow changes (the Helix
        # participant registration and state-transition replay)
        self.store.watch("idealstate/", self._on_ideal_state_change)
        self.store.watch("tables/", self._on_table_config_change)
        self.store.watch("reloadrequests/", self._on_reload_request)
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
            for key in [k for k in self._pushed_crc if k[0] == table]:
                del self._pushed_crc[key]
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
                self._pushed_crc.pop((table, seg), None)
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
        md = self.store.get_segment_metadata(table, seg)
        if tdm.has_segment(seg) and (
                realtime or md is None
                or self._pushed_crc.get((table, seg), md.crc) == md.crc):
            return
        if md is None or not md.download_url:
            log.warning("[%s] no download url for %s/%s",
                        self.instance_id, table, seg)
            return
        try:
            got = self._fetch(md.download_url, table)
        except Exception:
            log.exception("[%s] deep-store fetch failed for %s/%s (%s)",
                          self.instance_id, table, seg, md.download_url)
            return
        if realtime:
            # an upsert table registers the fetched segment's keys
            tdm.on_sealed(seg, got, partition=md.partition, fetched=True)
        else:
            if isinstance(got, str):
                tdm.add_segment_from_dir(got)
            else:
                tdm.add_segment(got)
            self._pushed_crc[(table, seg)] = md.crc
        self.store.report_instance_state(table, seg, self.instance_id, ONLINE)

    def _fetch(self, download_url: str, table: str):
        """A ``memory://`` location's segment object, else the local
        directory ``fetch_segment`` resolves the location to: a local
        segment in place, a remote one copied under
        ``<segment_dir>/<instance>/<table>``."""
        if download_url.startswith(f"{MEMORY_SCHEME}://"):
            return self.deep_store.fetch_segment(download_url)
        return fetch_segment(
            download_url,
            None if self.segment_dir is None else os.path.join(
                self.segment_dir, self.instance_id, table))

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
                t, td, m),
            output_dir=(os.path.join(self.segment_dir, self.instance_id,
                                     table)
                        if self.segment_dir is not None else None))
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
                tdm.on_sealed(seg, self._fetch(zk.download_url, table),
                              fetched=True)
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

    # -- reload (JAX :373-400) --------------------------------------------------
    def _on_reload_request(self, path: str, _value) -> None:
        """Reload every hosted segment of the table that has a directory:
        the indexes its config gained are added on disk and the segment
        swapped in again (consuming segments take the config at their
        seal; a segment held only in memory has nothing to reload)."""
        from pinot_tpu_torch.segment.preprocessor import reload_segment

        table = path.split("/", 1)[-1]
        tdm = self.data_manager.get(table)
        cfg = self.store.get_table_config(table)
        if tdm is None or cfg is None:
            return
        acquired = tdm.acquire_segments(None)
        try:
            for holder in acquired:
                seg = holder.segment
                if getattr(seg, "is_mutable", False) \
                        or getattr(seg, "segment_dir", None) is None:
                    continue
                try:
                    added = reload_segment(tdm, seg, cfg.indexing_config)
                    if added:
                        log.info("[%s] reloaded %s/%s: %s", self.instance_id,
                                 table, seg.segment_name, added)
                except Exception as e:
                    log.exception("[%s] reload failed for %s/%s",
                                  self.instance_id, table, seg.segment_name)
                    self.reload_failures.append(
                        (table, seg.segment_name, repr(e)))
        finally:
            tdm.release_segments(acquired)

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
        # a routed segment dropped here since the broker's route (a merge's
        # input deleted after its swap): the broker routes the query again
        missing = (0 if segment_names is None
                   else len(segment_names) - len(acquired))
        t0 = time.perf_counter()
        try:
            segments = [s.segment for s in acquired]
            if not segments:
                self.metrics.meter(ServerMeter.QUERY_EXCEPTIONS).mark()
                dt = DataTable.for_exception(
                    f"no segments of {table} on {self.instance_id}")
                dt.stats.num_segments_missing = missing
                return dt
            dt = self.executor.execute_instance(ctx, segments)
            self._count_launches(dt.stats)
            if missing:
                # on a copy: a query flight hands one table to its riders
                dt = copy.copy(dt)
                dt.stats = copy.copy(dt.stats)
                dt.stats.num_segments_missing = missing
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
                dt = self.executor.execute_instance(ctx, [segment])
                self._count_launches(dt.stats)
                yield dt
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

    def table_size(self, table: str) -> Dict[str, Any]:
        """The bytes on disk of each hosted segment of ``table`` that has
        a directory (JAX :515); a segment gone mid-walk is left out."""
        tdm = self.data_manager.get(table)
        if tdm is None:
            return {"tableName": table, "segments": {}, "totalBytes": 0}
        sizes: Dict[str, int] = {}
        for name in tdm.segment_names():
            acquired = tdm.acquire_segments([name])
            if not acquired:
                continue
            try:
                seg_dir = getattr(acquired[0].segment, "segment_dir", None)
                if seg_dir and os.path.isdir(seg_dir):
                    sizes[name] = sum(
                        os.path.getsize(os.path.join(root, f))
                        for root, _dirs, files in os.walk(seg_dir)
                        for f in files)
            finally:
                tdm.release_segments(acquired)
        return {"tableName": table, "segments": sizes,
                "totalBytes": sum(sizes.values())}

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

    def _count_launches(self, stats) -> None:
        with self._launch_lock:
            for name, wire in WIRE_COUNTERS:
                n = getattr(stats, name)
                if n:
                    self._launches[wire] = self._launches.get(wire, 0) + n

    def launch_debug(self) -> Dict[str, Any]:
        """Launch coalescing: requests against launches, coalesced and
        deduped counts, queue waits (``enabled`` False for the
        per-segment executor, which has no launcher); and the kernel
        launches of the queries this server answered (``launches``, the
        port's: each query's own counts summed, a shared launch once for
        each query it served)."""
        with self._launch_lock:
            launches = dict(self._launches)
        launcher = getattr(self.executor, "launcher", None)
        out: Dict[str, Any] = {"enabled": launcher is not None}
        if launcher is not None:
            out.update(launcher.stats_snapshot())
        out["launches"] = launches
        return out

    def pallas_debug(self) -> Dict[str, Any]:
        """``GET /debug/pallas`` (JAX :647-667): the fused scan's per-shape
        blocklist (each spec with the reason it declines with) and the
        last preflight verdict table attached to the executor
        (``tools/preflight.py attach_verdicts``)."""
        bl = self.executor._pallas_blocked
        out: Dict[str, Any] = {"blocklist": bl.snapshot(),
                               "blockedShapes": len(bl)}
        if bl.path:
            out["blocklistPath"] = bl.path
        verdicts = self.executor.preflight_verdicts
        out["preflight"] = verdicts if verdicts is not None else {
            "run": False}
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
        resident its bytes and pins, plus the budgets and counters, and
        the segment files mapped in this process (``nativeMmapBuffers``)."""
        from pinot_tpu_torch import native

        out = dict(self.executor.residency.snapshot())
        out["nativeMmapBuffers"] = native.mmap_buffer_count()
        return out

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
