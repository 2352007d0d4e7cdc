"""Server query executor: per-segment device rungs, decode, merge, reduce.

Counterpart of ``pinot_tpu/engine/executor.py`` (``ServerQueryExecutor``,
``_try_pallas`` / ``_run_kernel`` at :939/:1020, ``decode_scalar_result``
at :1093, ``decode_grouped_result`` at :1127). A query first loses the
segments its filter provably excludes (``engine/pruner.py``; at least one
is kept). Then, routed as the JAX executor routes it (:462-466, :681-694):

- ``SELECT DISTINCT`` (or GROUP BY without aggregations) goes to the host
  engine (``engine/host_engine.py``), recorded as
  ``plan:device_kernel->host_engine:distinct_host_only``;
- an ordered selection goes to the device top-k
  (``engine/selection_device.py``), or, where it declines, to the host
  engine, recorded as ``selection:device_topk->host_engine:<code>`` with
  the code ``selection_not_device_eligible``; an unordered selection goes
  to the host engine, with no decision;
- an aggregation or group-by, per segment: a filter-less COUNT(*) / MIN /
  MAX / MINMAXRANGE is answered from the segment's metadata; a query one
  of the segment's star-trees fits is served from the cheapest such
  tree's pre-aggregated records (JAX ``_try_star_tree`` :748-799): its
  node slice on the device (``engine/startree_device.py``), recorded as
  ``startree:scan->startree_device:tree<i>``, or, where the node plan
  raises ``PlanError``, the host walker (``engine/startree_exec.py``),
  recorded as ``startree:startree_device->startree_host:<code>`` and
  ``startree:scan->startree:tree<i>``; a segment with trees none of which
  fits records ``startree:startree->scan:<code>``, and
  ``OPTION(useStarTree=false)`` opts out with no decision; a consuming
  segment (``segment/mutable.py``) is then served by its own rung
  (``engine/mutable_staging.py``, group-by rung ``mutable_device``, JAX
  :654-660 and :868-875), which plans a watermark snapshot afresh every
  query and shares no run, or declines to the host engine with its
  ``mutable:`` code (HLL, an empty segment); otherwise a
  selective AND-ed filter the segment's indexes resolve is served by the
  index rung's docId gather (``engine/index_exec.py``, JAX :660-667 and
  :875-882), with its outcome recorded under the ``index`` point;
  otherwise plan -> the fused scan (probe first when the group space
  exceeds MAX_SCAN_GROUPS); a plan it declines, with the decline recorded
  under the JAX package's keys, goes to the general rung
  (``engine/kernels.py``) on the same device -> decode. A ``PlanError``
  from planning or from decode (more live groups than the compact cap)
  sends the segment to the host engine, recorded as
  ``plan:device_kernel->host_engine:<code>`` (the group-by rung is then
  ``host``);

then merge, the ``num_groups_limit`` trim, and reduce.
``use_fused_scan=False`` (JAX: ``use_pallas=False``) sends every plan to
the general rung.

Residency (``engine/residency.py``, JAX :483-528): every query opens a
lease after pruning (``_begin_lease``). Admission may grant a sliced
lease, recorded as ``residency:resident_device->sliced_device:
working_set_over_budget_sliceable``: the segments then run one at a time,
each released (unpinned, demoted to the host tier past the budget)
before the next stages. It may refuse the device, recorded as
``residency:device->host_engine:<reason>``: the query then runs on the
host engine (the metadata answer and a fitting star-tree's host walker
still serve), as the JAX executor's spill does. That is the one route to
the host engine besides those of the plans themselves; it is taken by
admission only, never on a failure, and nothing runs on the CPU unless
the executor was built with ``device="cpu"``. The lease pins every
resident the query stages until ``end_query``, which sets
``QueryStats.staging``. Identical concurrent launches (the same cached
plan on the same staged segment, or the same compiled query on the same
staged star-tree) share one run through ``kernel_flight``; a plan with
the upsert valid-doc leaf never does. The plan cache is locked, so
threads may share one executor. ``_execute_aggregation`` and
``_execute_group_by`` are the points a subclass overrides to combine
segments otherwise (``pinot_tpu_torch.parallel.ShardedQueryExecutor``,
whose batch path serves every plan on the fused scan or the jnp combine).

The instance surface (JAX :163-260, :400-429, :572-640):

- ``execute`` and ``execute_instance`` pass the admission gate
  (``server/admission.py``, keys ``pinot.server.query.admission.*``)
  first: past its bounds a query is rejected with a typed, retriable
  ``QueryRejectedError`` before any lease is taken;
- identical concurrent ``execute`` calls (the same compiled context over
  the same segment objects) share one run (``query_flight``); a
  consuming or upsert-managed segment never shares, since its rows move
  between two such calls;
- a query's segments run on the executor's persistent worker pool
  (``server/scheduler.py`` ``WorkerPool``, ``pinot.server.query.worker
  .threads``; the default is 1 where JAX's is min(cpu count, 8): the
  port's per-segment work is host Python, and threads contend for the
  GIL), each task with a private
  ``QueryStats`` that carries the query's lease and is merged in segment
  order; a sliced lease, one segment, or one thread runs them in turn;
  ``close`` stops the pool (it is built again at the next fan-out);
- ``execute_instance`` returns the server's mergeable answer, a
  ``common/datatable.py`` ``DataTable``, which the broker reduces
  (``broker/reduce.py``): DISTINCT rows (HAVING left to the broker), an
  unordered selection trimmed to ``offset + limit``, an ordered one with
  its order-by columns that are not selected as hidden trailing columns
  and ``sorted_rows``, the group-by's states trimmed to
  ``num_groups_limit``, or the scalar states.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.common.singleflight import SingleFlight
from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine import (
    fused_scan,
    host_engine,
    index_exec,
    kernels,
    mutable_staging,
    startree_device,
    startree_exec,
)
from pinot_tpu_torch.engine.aggregates import (
    AggDef,
    agg_value_expr,
    resolve_agg,
)
from pinot_tpu_torch.engine.errors import PlanError, QueryError
from pinot_tpu_torch.engine.host_eval import VIRTUAL_COLUMNS
from pinot_tpu_torch.engine.plan import SegmentPlan, plan_segment
from pinot_tpu_torch.engine.pruner import prune_segments
from pinot_tpu_torch.engine.residency import AUTO, QueryLease, ResidencyManager
from pinot_tpu_torch.engine.results import (
    AggResult,
    GroupByResult,
    QueryStats,
    ResultTable,
    record_decision,
    reduce_aggregation,
    reduce_group_by,
)
from pinot_tpu_torch.engine.selection_device import (
    SelectionCache,
    device_selection,
)
from pinot_tpu_torch.engine.staging import StagedSegment
from pinot_tpu_torch.query.context import QueryContext, filter_fingerprint
from pinot_tpu_torch.query.expressions import Identifier
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.segment.mutable import is_mutable
from pinot_tpu_torch.server.admission import AdmissionGate
from pinot_tpu_torch.server.scheduler import WorkerPool
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration
from pinot_tpu_torch.utils.hll import HyperLogLog

# plans kept per executor, least recently used evicted first (the JAX
# executor's plan cache): a repeated query plans and uploads its params once
PLAN_CACHE_CAP = 256
# merged groups kept before the reduce (Pinot's numGroupsLimit default)
DEFAULT_NUM_GROUPS_LIMIT = 100_000

# QueryStats field -> the launch counter it reads, for a query's run
_LAUNCH_COUNTERS = (
    ("scan_launches", fused_scan.SCAN_COUNTER),
    ("probe_launches", fused_scan.PROBE_COUNTER),
    ("general_launches", kernels.RUNG_COUNTER),
    ("index_launches", index_exec.INDEX_COUNTER),
    ("startree_launches", startree_device.STARTREE_COUNTER),
)


class ServerQueryExecutor:
    """One per server; owns the residency of one device."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 use_fused_scan: bool = True,
                 num_groups_limit: int = DEFAULT_NUM_GROUPS_LIMIT,
                 hbm_budget_bytes=None, host_budget_bytes=None,
                 config=None):
        self.device = resolve_device(device)
        self.use_fused_scan = use_fused_scan
        self.num_groups_limit = num_groups_limit
        self.config = config
        # None: from the config keys, then the card's memory / the host's
        # available memory; <= 0: uncapped (JAX :96-117)
        self.residency = ResidencyManager(
            budget_bytes=AUTO if hbm_budget_bytes is None
            else hbm_budget_bytes,
            host_budget_bytes=(AUTO if host_budget_bytes is None
                               else host_budget_bytes),
            config=config, device=self.device)
        # (sql, filter fingerprint, segment name, upsert-managed) ->
        # (weak reference to the segment, its plan), least recently used
        # first
        self._plans: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._plans_lock = threading.Lock()
        self.kernels = kernels.KernelCache()
        self.selection_cache = SelectionCache()
        self.kernel_flight = SingleFlight()
        cfg = config if config is not None else PinotConfiguration()
        # segment fan-out width; the pool is built at the first fan-out
        # and lives until close()
        self.worker_threads = max(1, cfg.get_int(
            CommonConstants.WORKER_THREADS_KEY,
            CommonConstants.DEFAULT_WORKER_THREADS))
        self._segment_pool: Optional[WorkerPool] = None
        self._segment_pool_lock = threading.Lock()
        # bounded slots and queue in front of execution
        self.admission = AdmissionGate.from_config(cfg)
        # identical concurrent execute() calls share one run
        self.query_flight = SingleFlight()

    def stage(self, segment: ImmutableSegment,
              stats: Optional[QueryStats] = None) -> StagedSegment:
        """The segment's resident, pinned by the lease of ``stats``."""
        return self.residency.stage(segment, stats.lease if stats is not None
                                    else None)

    def evict_segment(self, segment_name: str) -> None:
        """Drop a segment's arrays from both tiers (unassigned or
        reloaded)."""
        self.residency.evict(segment_name)

    def execute(self, ctx: QueryContext, segments: List[ImmutableSegment]
                ) -> Tuple[ResultTable, QueryStats]:
        """The query's final table and stats. Admission is per caller (a
        request that rides another's run still holds its slot until the
        shared run ends); identical concurrent calls share one run and get
        the same (table, stats)."""
        ticket = self.admission.admit(ctx.table_name or "")
        try:
            out, _ = self.query_flight.do(
                self._query_flight_key(ctx, segments),
                lambda: self._run_query(ctx, segments, self._execute_pruned))
            return out
        finally:
            self.admission.release(ticket)

    def execute_instance(self, ctx: QueryContext,
                         segments: List[ImmutableSegment]) -> DataTable:
        """The server's mergeable answer (JAX :250-260): a DataTable the
        broker reduces with the other servers' (``broker/reduce.py``)."""
        ticket = self.admission.admit(ctx.table_name or "")
        try:
            # the table carries the query's stats, counters included
            return self._run_query(ctx, segments, self._instance_pruned)[0]
        finally:
            self.admission.release(ticket)

    @staticmethod
    def _query_flight_key(ctx: QueryContext,
                          segments: List[ImmutableSegment]
                          ) -> Optional[Tuple]:
        """None: not shareable. Keyed on the identity of the compiled
        context and of every segment (JAX :418-429), so a reloaded segment
        or a context compiled again never joins a stale run; consuming and
        upsert-managed segments never share."""
        for s in segments:
            if s.valid_doc_ids is not None or is_mutable(s):
                return None
        return (id(ctx), tuple(id(s) for s in segments))

    def _counters(self) -> Tuple:
        """(QueryStats field, counter) of every kernel and rung a query's
        run counts."""
        return _LAUNCH_COUNTERS

    def _run_query(self, ctx: QueryContext,
                   segments: List[ImmutableSegment], body: Callable
                   ) -> Tuple[Any, QueryStats]:
        """Validate, prune, open the lease, ``body(ctx, kept, stats)``,
        end the lease; the stats count the launches made meanwhile."""
        if not segments:
            raise QueryError(f"no segments for table {ctx.table_name!r}")
        known = set(segments[0].metadata.columns) | set(VIRTUAL_COLUMNS)
        for c in ctx.referenced_columns():
            if c not in known:
                raise QueryError(f"unknown column {c!r} in table "
                                 f"{ctx.table_name!r}")
        stats = QueryStats(num_segments_queried=len(segments))
        segments = self._prune(ctx, segments, stats)
        counters = self._counters()
        before = [c.launches for _, c in counters]
        self._begin_lease(ctx, segments, stats)
        try:
            out = body(ctx, segments, stats)
        finally:
            self.residency.end_query(stats.lease, stats)
            stats.lease = None
        for (name, c), n0 in zip(counters, before):
            setattr(stats, name, c.launches - n0)
        return out, stats

    def _begin_lease(self, ctx: QueryContext,
                     segments: List[ImmutableSegment],
                     stats: QueryStats) -> QueryLease:
        """Admission for the kept segments (JAX ``_begin_lease``): only an
        aggregation or group-by can slice; a selection or DISTINCT fits or
        goes to the host engine."""
        sliceable = not ctx.distinct and not ctx.is_selection
        lease = self.residency.begin_query(segments,
                                           ctx.referenced_columns(),
                                           sliceable=sliceable)
        if not lease.device_allowed:
            record_decision(stats, "residency", "host_engine", "device",
                            lease.admit_reason)
        elif lease.sliced:
            record_decision(stats, "residency", "sliced_device",
                            "resident_device", lease.admit_reason)
        stats.lease = lease
        return lease

    @staticmethod
    def _device_admitted(stats: QueryStats) -> bool:
        """False when admission sent the query to the host engine."""
        return stats.lease is None or stats.lease.device_allowed

    def _map_segments(self, fn: Callable, segments: List[ImmutableSegment],
                      stats: QueryStats) -> List[Any]:
        """``fn(segment, stats)`` per segment, results in segment order
        (JAX :572-633). Under a sliced lease each segment is a slice,
        released before the next stages, so they run in turn; so do one
        segment and one thread. Otherwise the worker pool runs them, each
        with a private QueryStats (QueryStats is not thread-safe) that
        carries the query's lease: without it a task would read an
        admission that sent the query to the host engine as a device one.
        The private stats merge in segment order."""
        lease = stats.lease
        if lease is not None and lease.sliced:
            parts = []
            for seg in segments:
                parts.append(fn(seg, stats))
                self.residency.release_slice(lease)
            return parts
        if self.worker_threads <= 1 or len(segments) <= 1:
            return [fn(seg, stats) for seg in segments]
        locals_ = [QueryStats(lease=lease) for _ in segments]
        parts = self._worker_pool().map(fn, segments, locals_)
        for st in locals_:
            stats.merge(st)
        return parts

    def _worker_pool(self) -> WorkerPool:
        pool = self._segment_pool
        if pool is None:
            with self._segment_pool_lock:
                pool = self._segment_pool
                if pool is None:
                    pool = WorkerPool(self.worker_threads, name="pqw")
                    self._segment_pool = pool
        return pool

    def close(self) -> None:
        """Stop the worker pool (server shutdown); the executor stays
        usable, its pool built again at the next fan-out."""
        with self._segment_pool_lock:
            pool, self._segment_pool = self._segment_pool, None
        if pool is not None:
            pool.stop()

    def _execute_pruned(self, ctx: QueryContext,
                        segments: List[ImmutableSegment],
                        stats: QueryStats) -> ResultTable:
        if ctx.distinct:
            record_decision(stats, "plan", "host_engine", "device_kernel",
                            "distinct_host_only")
            return host_engine.execute_distinct(ctx, segments, stats)
        if ctx.is_selection:
            return self._selection(ctx, segments, stats)
        aggs = [resolve_agg(f) for f in ctx.aggregations]
        if not ctx.is_group_by:
            merged = self._execute_aggregation(ctx, aggs, segments, stats)
            return reduce_aggregation(ctx, aggs, merged)
        merged = self._execute_group_by(ctx, aggs, segments, stats)
        if merged.trim(self.num_groups_limit):
            stats.num_groups_limit_reached = True
        return reduce_group_by(ctx, aggs, merged,
                               _schema_types(segments[0]))

    def _instance_pruned(self, ctx: QueryContext,
                         segments: List[ImmutableSegment],
                         stats: QueryStats) -> DataTable:
        """The kept segments' mergeable answer (JAX
        ``_execute_instance_traced`` :328-398)."""
        if ctx.distinct:
            # HAVING is the broker's (it sees the global distinct set);
            # ORDER BY stays here, so each server ships its true top rows
            if ctx.having is not None:
                sub = dataclasses.replace(ctx, order_by=[], having=None,
                                          limit=self.num_groups_limit,
                                          offset=0)
            else:
                sub = dataclasses.replace(ctx, having=None,
                                          limit=ctx.offset + ctx.limit,
                                          offset=0)
            record_decision(stats, "plan", "host_engine", "device_kernel",
                            "distinct_host_only")
            table = host_engine.execute_distinct(sub, segments, stats)
            if len(table.rows) >= self.num_groups_limit:
                stats.num_groups_limit_reached = True
            return DataTable.for_distinct(table.schema, table.rows, stats)
        if ctx.is_selection:
            if not ctx.order_by:
                sub = dataclasses.replace(ctx, limit=ctx.offset + ctx.limit,
                                          offset=0)
                table = host_engine.execute_selection(sub, segments, stats)
                return DataTable.for_selection(table.schema, table.rows,
                                               stats)
            # the order-by expressions not selected ride as hidden
            # trailing columns, so the broker merge-sorts without the
            # segments; the rows ship already in query order
            present = {str(e) for e in ctx.select_expressions}
            hidden = [ob.expr for ob in ctx.order_by
                      if str(ob.expr) not in present]
            sub = dataclasses.replace(
                ctx,
                select_expressions=list(ctx.select_expressions) + hidden,
                aliases=list(ctx.aliases) + [None] * len(hidden),
                limit=ctx.offset + ctx.limit, offset=0)
            table = self._selection(sub, segments, stats)
            return DataTable.for_selection(table.schema, table.rows, stats,
                                           num_hidden=len(hidden),
                                           sorted_rows=True)
        aggs = [resolve_agg(f) for f in ctx.aggregations]
        if ctx.is_group_by:
            merged = self._execute_group_by(ctx, aggs, segments, stats)
            if merged.trim(self.num_groups_limit):
                stats.num_groups_limit_reached = True
            return DataTable.for_group_by(merged.groups,
                                          _schema_types(segments[0]), stats)
        merged = self._execute_aggregation(ctx, aggs, segments, stats)
        return DataTable.for_aggregation(merged.states, stats)

    def _selection(self, ctx: QueryContext, segments: List[ImmutableSegment],
                   stats: QueryStats) -> ResultTable:
        """An ordered selection on the device top-k where it is eligible,
        else (and every unordered selection) on the host engine."""
        if ctx.order_by and self._device_admitted(stats):
            table = device_selection(ctx, segments, self, stats)
            if table is not None:
                return table
            record_decision(stats, "selection", "host_engine", "device_topk",
                            "selection_not_device_eligible")
        return host_engine.execute_selection(ctx, segments, stats)

    @staticmethod
    def _prune(ctx: QueryContext, segments: List[ImmutableSegment],
               stats: QueryStats) -> List[ImmutableSegment]:
        """The segments the filter may match, at least one (the reduce
        needs a result to shape); the pruned segments' docs count in
        ``total_docs``, the time in ``phase_ms["SEGMENT_PRUNING"]``."""
        t0 = time.perf_counter()
        kept = prune_segments(ctx, segments, stats)
        stats.add_phase_ms("SEGMENT_PRUNING",
                           (time.perf_counter() - t0) * 1e3)
        if not kept:
            kept = segments[:1]
            stats.num_segments_pruned -= 1
        names = {s.segment_name for s in kept}
        stats.total_docs += sum(s.num_docs for s in segments
                                if s.segment_name not in names)
        return kept

    def _execute_aggregation(self, ctx: QueryContext, aggs: List[AggDef],
                             segments: List[ImmutableSegment],
                             stats: QueryStats) -> AggResult:
        merged: Optional[AggResult] = None
        for part in self._map_segments(
                lambda seg, st: (_metadata_answer(ctx, aggs, seg, st)
                                 or self._segment_aggregation(ctx, aggs, seg,
                                                              st)),
                segments, stats):
            if merged is None:
                merged = part
            else:
                merged.merge(part, aggs)
        return merged

    def _segment_aggregation(self, ctx: QueryContext, aggs: List[AggDef],
                             seg: ImmutableSegment,
                             stats: QueryStats) -> AggResult:
        st = self._try_star_tree(ctx, aggs, seg, stats)
        if st is not None:
            return st[0]
        if self._device_admitted(stats) and is_mutable(seg):
            part = mutable_staging.serve_aggregation(self, ctx, aggs, seg,
                                                     stats)
            if part is not None:
                return part
        elif self._device_admitted(stats):
            part = index_exec.try_index_rung(self, ctx, aggs, seg, stats,
                                             grouped=False)
            if part is not None:
                return part
            try:
                scan = self._scan_segment(ctx, seg, stats)
                return decode_scalar_result(scan.plan, seg, scan.tree)
            except PlanError as e:
                record_decision(stats, "plan", "host_engine",
                                "device_kernel", e.reason_code)
        return host_engine.host_aggregate_segment(ctx, aggs, seg, stats)

    def _execute_group_by(self, ctx: QueryContext, aggs: List[AggDef],
                          segments: List[ImmutableSegment],
                          stats: QueryStats) -> GroupByResult:
        merged = GroupByResult()
        for part in self._map_segments(
                lambda seg, st: self._segment_group_by(ctx, aggs, seg, st),
                segments, stats):
            merged.merge(part, aggs)
        return merged

    def _segment_group_by(self, ctx: QueryContext, aggs: List[AggDef],
                          seg: ImmutableSegment,
                          stats: QueryStats) -> GroupByResult:
        st = self._try_star_tree(ctx, aggs, seg, stats)
        if st is not None:
            stats.record_rung(st[1])
            return st[0]
        if self._device_admitted(stats) and is_mutable(seg):
            part = mutable_staging.serve_group_by(self, ctx, aggs, seg,
                                                  stats)
            if part is not None:
                stats.record_rung("mutable_device")
                return part
        elif self._device_admitted(stats):
            part = index_exec.try_index_rung(self, ctx, aggs, seg, stats,
                                             grouped=True)
            if part is not None:
                return part
            try:
                scan = self._scan_segment(ctx, seg, stats)
                part = decode_grouped_result(scan.plan, seg, scan.tree)
                stats.record_rung(kernels.grouped_rung(scan.plan.spec,
                                                       scan.tree))
                return part
            except PlanError as e:
                record_decision(stats, "plan", "host_engine",
                                "device_kernel", e.reason_code)
        stats.record_rung("host")
        return host_engine.host_group_by_segment(ctx, aggs, seg, stats)

    def _star_tree_pick(self, ctx: QueryContext, aggs: List[AggDef],
                        seg: ImmutableSegment, on_decline=None
                        ) -> Optional[startree_exec.StarTreePick]:
        """The cheapest fitting tree of the segment, or None; also None,
        with no decline, under ``OPTION(useStarTree=false)`` (JAX
        :696-708)."""
        if str(ctx.options.get("useStarTree", "true")).lower() == "false":
            return None
        return startree_exec.pick_star_tree(ctx, aggs, seg,
                                            on_decline=on_decline)

    def _try_star_tree(self, ctx: QueryContext, aggs: List[AggDef],
                       seg: ImmutableSegment, stats: QueryStats
                       ) -> Optional[Tuple[Any, str]]:
        """(result, rung) from the segment's star-tree: rung
        ``startree_device`` for the node slice on the device, ``startree``
        for the host walker; or None, the scan rungs serving (no tree
        fits, or a predicate that does not translate)."""
        def declined(reason: str) -> None:
            record_decision(stats, "startree", "scan", "startree", reason)

        pick = self._star_tree_pick(ctx, aggs, seg, on_decline=declined)
        if pick is None:
            return None
        tree, tree_index, preds = pick
        matches = startree_exec.resolve_matches(seg, preds,
                                                on_decline=declined)
        if matches is None:
            return None
        res = None
        if self._device_admitted(stats):
            try:
                res = startree_device.execute_star_tree_device(
                    self, ctx, aggs, seg, tree, matches, stats, tree_index)
                rung = "startree_device"
            except PlanError as e:
                # the node plan is past the device's limits
                record_decision(stats, "startree", "startree_host",
                                "startree_device", e.reason_code)
        if res is None:
            res = startree_exec.execute_with_matches(ctx, aggs, seg, tree,
                                                     matches, stats)
            rung = "startree"
        record_decision(stats, "startree", rung, "scan", f"tree{tree_index}")
        stats.startree_tree_index = tree_index
        return res, rung

    def _plan_for(self, ctx: QueryContext, seg: ImmutableSegment
                  ) -> SegmentPlan:
        """plan_segment, cached per (sql, filter fingerprint, segment,
        whether it carries a valid-doc bitmap: one attached later must not
        be served the plan without the validdocs leaf); a reloaded segment
        (same name, new object) plans again. The entry holds its segment
        by weak reference, so the cache keeps no unloaded segment alive
        (JAX :901-919)."""
        if ctx.sql is None:
            return plan_segment(ctx, seg)
        key = (ctx.sql, filter_fingerprint(ctx), seg.segment_name,
               seg.valid_doc_ids is not None)
        with self._plans_lock:
            hit = self._plans.get(key)
            if hit is not None and hit[0]() is seg:
                self._plans.move_to_end(key)
                return hit[1]
        plan = plan_segment(ctx, seg)
        with self._plans_lock:
            # a concurrent planner of the same key may have won: serve its
            # plan, so identical queries share one flight key
            hit = self._plans.get(key)
            if hit is not None and hit[0]() is seg:
                return hit[1]
            self._plans[key] = (weakref.ref(seg), plan)
            if len(self._plans) > PLAN_CACHE_CAP:
                self._plans.popitem(last=False)
        return plan

    def _scan_segment(self, ctx: QueryContext, seg: ImmutableSegment,
                      stats: QueryStats) -> fused_scan.SegmentScan:
        """The fused scan, or the general rung where it declines (or is
        off); the decision is recorded as the JAX executor records it. A
        plan neither serves raises ``PlanError``."""
        plan = self._plan_for(ctx, seg)
        staged = self.stage(seg, stats)

        def launch():
            """-> (scan or the PlanError the general rung raised, the fused
            scan's declines)."""
            reasons: List[str] = []
            scan = None
            if self.use_fused_scan:
                scan = fused_scan.run_segment(plan, staged,
                                              on_decline=reasons.append)
            else:
                reasons.append("pallas_disabled_on_backend")
            if scan is None:
                try:
                    scan = self._run_general(plan, staged)
                except PlanError as e:
                    scan = e
            return scan, reasons

        # identical concurrent queries (the same cached plan on the same
        # resident) share one launch and copy; a valid-doc snapshot is
        # taken per call, so an upsert plan never shares (JAX :225, :1054)
        upsert = bool(plan.params) and plan.params[0] is None
        (scan, reasons), _ = self.kernel_flight.do(
            None if upsert else ("scan", id(plan), id(staged)), launch)
        for r in reasons:
            record_decision(stats, "pallas", "jnp_kernel", "pallas_kernel", r)
        if isinstance(scan, PlanError):
            raise scan
        stats.num_segments_processed += 1
        stats.total_docs += seg.num_docs
        stats.num_docs_scanned += scan.matched
        stats.num_segments_matched += 1 if scan.matched else 0
        return scan

    def _run_general(self, plan: SegmentPlan, staged: StagedSegment
                     ) -> fused_scan.SegmentScan:
        """The plan on the general rung: one call, one copy to the host.
        An upsert plan's first param is the placeholder of the valid-doc
        snapshot, filled here for this call."""
        cols = {name: staged.column(name).tree() for name in plan.columns}
        kernel = self.kernels.get(plan.spec)
        params = kernels.device_params(plan, self.device)
        if plan.params and plan.params[0] is None:    # validdocs placeholder
            params = (staged.valid_mask(),) + params[1:]
        packed = kernel(cols, params, staged.num_docs, self.device)
        tree = kernels.unpack_outputs(packed.cpu().numpy(), plan.spec)
        matched = int(tree["num_matched"] if "num_matched" in tree
                      else np.asarray(tree["presence"]).sum())
        return fused_scan.SegmentScan(tree=tree, plan=plan, matched=matched)


def _schema_types(segment: ImmutableSegment) -> Dict[str, str]:
    """Column -> type label, virtual columns included (the group-by's
    key types)."""
    types = {n: cm.data_type.label
             for n, cm in segment.metadata.columns.items()}
    types.update(VIRTUAL_COLUMNS)
    return types


def _metadata_answer(ctx: QueryContext, aggs: List[AggDef],
                     seg: ImmutableSegment, stats: QueryStats
                     ) -> Optional[AggResult]:
    """A filter-less query of COUNT(*) and MIN / MAX / MINMAXRANGE of
    numeric columns without nulls, answered from the segment's metadata
    with no scan (the JAX executor's ``_metadata_fast_path``); None for any
    other query, an upsert segment (its metadata counts invalid docs) or
    a consuming one (its live dictionary's min/max may hold a value whose
    row is not published yet; JAX :808-812)."""
    if ctx.filter is not None or ctx.is_group_by \
            or seg.valid_doc_ids is not None or is_mutable(seg):
        return None
    states: List[Any] = []
    for agg, fn in zip(aggs, ctx.aggregations):
        vexpr = agg_value_expr(fn)
        if agg.base == "count" and not agg.mv and vexpr is None:
            states.append(seg.num_docs)
            continue
        if (agg.base in ("min", "max", "minmaxrange") and not agg.mv
                and isinstance(vexpr, Identifier)):
            cm = seg.metadata.columns.get(vexpr.name)
            if (cm is not None and cm.data_type.is_numeric
                    and not cm.has_nulls and cm.min_value is not None):
                lo, hi = float(cm.min_value), float(cm.max_value)
                states.append(lo if agg.base == "min" else
                              hi if agg.base == "max" else (lo, hi))
                continue
        return None
    stats.num_segments_processed += 1
    stats.num_segments_matched += 1
    stats.total_docs += seg.num_docs
    return AggResult(states)


def decode_scalar_result(plan: SegmentPlan, provider: Any,
                         out: Dict[str, Any]) -> AggResult:
    """``provider`` is anything with ``data_source(col).dictionary``: a
    segment or a segment batch."""
    return AggResult([_decode_scalar_state(aspec, out[f"agg{i}"], provider)
                      for i, aspec in enumerate(plan.spec[1])])


def _decode_scalar_state(aspec: Tuple, raw: Any, provider: Any) -> Any:
    base = aspec[0]
    if base == "distinctcount":
        ids = np.nonzero(np.asarray(raw))[0]
        d = provider.data_source(aspec[1]).dictionary
        return frozenset(d.get_values(ids))
    if base == "distinctcounthll":
        regs = np.asarray(raw).astype(np.uint8)
        return HyperLogLog(aspec[2], regs).serialize()
    if base == "count":
        return int(raw)
    if base in ("sum", "min", "max"):
        return float(raw)
    if base == "avg":
        return (float(raw[0]), int(raw[1]))
    if base == "minmaxrange":
        return (float(raw[0]), float(raw[1]))
    raise AssertionError(base)


def decode_grouped_result(plan: SegmentPlan, provider: Any,
                          out: Dict[str, Any]) -> GroupByResult:
    """Composed keys -> per-column dictIds (or expression values) ->
    values, with the planner's own strides and bases."""
    presence = np.asarray(out["presence"])
    gidx = np.nonzero(presence)[0]
    result = GroupByResult()
    if gidx.size == 0:
        return result
    strides = plan.group_strides.astype(np.int64)
    bases = plan.group_bases or [0] * len(plan.group_cards)
    key_cols: List[List[Any]] = []
    for i, ((strat, payload), card) in enumerate(zip(plan.group_defs,
                                                      plan.group_cards)):
        dids = (gidx // strides[i]) % card
        if strat == "gdict":
            d = provider.data_source(payload).dictionary
            key_cols.append(d.get_values(dids + int(bases[i])))
        elif strat == "graw":   # value space: base is the column's min
            key_cols.append([int(x) + int(bases[i]) for x in dids])
        else:  # gexpr: the def carries the expression's lower bound
            key_cols.append([int(x) + int(payload) for x in dids])
    keys = list(zip(*key_cols))

    states_per_agg: List[List[Any]] = []
    for i, aspec in enumerate(plan.spec[1]):
        raw = out[f"agg{i}"]
        base = aspec[0]
        if base == "count":
            states_per_agg.append([int(v) for v in np.asarray(raw)[gidx]])
        elif base in ("sum", "min", "max"):
            states_per_agg.append([float(v) for v in np.asarray(raw)[gidx]])
        elif base == "avg":
            s = np.asarray(raw[0])[gidx]
            c = np.asarray(raw[1])[gidx]
            states_per_agg.append([(float(a), int(b)) for a, b in zip(s, c)])
        elif base == "minmaxrange":
            lo = np.asarray(raw[0])[gidx]
            hi = np.asarray(raw[1])[gidx]
            states_per_agg.append([(float(a), float(b))
                                   for a, b in zip(lo, hi)])
        elif base == "distinctcounthll":
            log2m = aspec[2]
            regs = np.asarray(raw).reshape(-1, 1 << log2m)[gidx]
            states_per_agg.append(
                [HyperLogLog(log2m, r.astype(np.uint8)).serialize()
                 for r in regs])
        else:
            raise AssertionError(base)
    n_aggs = len(plan.agg_defs)
    for gi, key in enumerate(keys):
        result.groups[key] = [states_per_agg[ai][gi] for ai in range(n_aggs)]
    return result


__all__ = ["ServerQueryExecutor", "decode_scalar_result",
           "decode_grouped_result"]
