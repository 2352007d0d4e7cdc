"""Broker request handler: the SQL front door and the scatter / gather.

Counterpart of ``pinot_tpu/broker/broker.py`` (``BrokerRequestHandler``,
the reference's BaseBrokerRequestHandler): compile the SQL, resolve the
table, answer EXPLAIN, strip gapfill, admit against the table's quota,
rewrite IN_SUBQUERY, route (replica choice, time and partition pruning,
dead servers), scatter per-server instance requests, gather their
DataTables in completion order (each folds into the reduce as it lands)
with per-server timeouts, reduce with ``BrokerReduceService`` and answer
a ``BrokerResponse``. Concurrent identical queries share one run
(``handle_sql``'s single flight, keyed on the normalized SQL, the
principal and the store's version; never for ``now()``).

A server that is not connected, times out or answers only with an error
leaves a partial result: its error travels as an exception DataTable,
the server is not counted as responded, the response carries a 427 and a
``gather:full_result->partial_result:<reason>`` decision
(``GATHER_DECISION_REASONS``).

A hybrid table (an offline and a realtime table under one name) splits
at the time boundary (``_split_hybrid``): the offline side answers
``time <= boundary`` and the realtime side ``time > boundary``, where the
boundary is the offline side's largest segment end time less one
(``routing.TimeBoundaryManager``); each side's filter gains that range
leaf, and the executors' caches key on the filter's fingerprint, so the
two sides of one SQL text never share a plan. Every outcome is a
``hybrid:`` decision: ``hybrid_single_table``, ``hybrid_no_time_column``,
``hybrid_no_boundary``, ``hybrid_time_split``.

Tracing and telemetry (JAX :115-122, :190-214, :246-250, :418-444,
:788): every front-door outcome lands in the table's windowed ``broker``
latency histogram and its SLO error counters; a traced query's response
carries ``traceInfo``, the broker's root (``Admission``, ``Compile``,
``Routing``, ``ScatterGather`` with each server's tree under it, tagged
with its instance, and ``Reduce`` with the arrival folds) and the flat
entries. A gathered DataTable is copied before its trace is tagged, so a
table shared in process keeps its own. ``telemetry_snapshot``,
``slo_snapshot``, ``flightrecorder_snapshot`` and ``freshness_snapshot``
are the process telemetry's views.

``device`` is where the reduce merges (default ``"cuda"``; raises without
a card).
"""

from __future__ import annotations

import copy
import threading
import time

from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import as_completed
from dataclasses import replace
from typing import Dict, List, Optional, Tuple, Union

import torch

from pinot_tpu_torch.broker.gapfill import apply_gapfill, extract_gapfill
from pinot_tpu_torch.broker.quota import QueryQuotaManager
from pinot_tpu_torch.broker.reduce import BrokerReduceService
from pinot_tpu_torch.broker.routing import RoutingManager
from pinot_tpu_torch.common.datatable import DataTable
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.common.singleflight import SingleFlight
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.common.tracing import build_broker_root, record_decision
from pinot_tpu_torch.controller.state import ClusterStateStore
from pinot_tpu_torch.engine.errors import QueryError, QueryRejectedError
from pinot_tpu_torch.engine.results import (
    DataSchema,
    QueryStats,
    ResultTable,
)
from pinot_tpu_torch.query import SqlParseError, compile_query
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.explain import EXPLAIN_COLUMNS, explain_rows
from pinot_tpu_torch.query.expressions import (
    FilterNode,
    FilterOp,
    Function,
    Identifier,
    Literal,
    Predicate,
    PredicateType,
)
from pinot_tpu_torch.server.admission import AdmissionGate
from pinot_tpu_torch.server.scheduler import _DaemonPool
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration
from pinot_tpu_torch.spi.metrics import (
    BrokerMeter,
    BrokerQueryPhase,
    MetricsRegistry,
)
from pinot_tpu_torch.spi.table import TableType, table_name_with_type


# the reference's QueryException codes
SQL_PARSING_ERROR = 150
TABLE_DOES_NOT_EXIST_ERROR = 190
SERVER_NOT_RESPONDING_ERROR = 427
QUERY_EXECUTION_ERROR = 200
ACCESS_DENIED_ERROR = 180
TOO_MANY_REQUESTS_ERROR = 429

# the threads that call the servers of a query
SCATTER_WORKERS = 16

# the codes the gather point records when a scattered-to server produces
# no usable DataTable (JAX pinot_tpu/common/tracing.py:431
# GATHER_DECISION_REASONS)
GATHER_DECISION_REASONS = frozenset({
    "server_not_connected",
    "server_timeout",
    "server_error",
})


class AccessDeniedError(QueryError):
    """Access control denied a subquery; carried through the QueryError
    handling so the outer response keeps error code 180."""


class BrokerRequestHandler:
    """The broker's front door."""

    def __init__(self, store: ClusterStateStore,
                 query_timeout_s: float = 30.0,
                 device_reduce: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda"):
        if device_reduce is None:
            # the operator's key (pinot.broker.reduce.device.enabled); an
            # explicit argument wins over the environment
            device_reduce = PinotConfiguration().get_bool(
                CommonConstants.BROKER_DEVICE_REDUCE_KEY,
                CommonConstants.DEFAULT_BROKER_DEVICE_REDUCE)
        self.store = store
        self.routing = RoutingManager(store)
        self.reduce_service = BrokerReduceService(
            device_reduce=device_reduce, device=device)
        self._servers: Dict[str, object] = {}
        self._pool = _DaemonPool(SCATTER_WORKERS, "scatter")
        self.query_timeout_s = query_timeout_s
        self.metrics = MetricsRegistry(role="broker")
        self._subq_local = threading.local()
        self.quota = QueryQuotaManager(
            store,
            num_brokers_fn=lambda: max(
                len(store.instances("BROKER", only_alive=True)), 1))
        # one admission gate for the front door: the per-table QPS quota
        # rides it (reason "quota"); configure() can bound the broker's
        # concurrency (the servers' gates bound execution below)
        self.admission = AdmissionGate(max_concurrent=-1, quota=self.quota,
                                       name="broker-admission")
        # concurrent identical queries share one compile / scatter /
        # gather / reduce, before any fan-out
        self._flights = SingleFlight()
        self._leading = threading.local()
        # the process telemetry: its families on this registry's /metrics,
        # this broker's scheduling state in flight-recorder bundles
        TELEMETRY.configure()
        self.metrics.bind_telemetry(TELEMETRY)
        TELEMETRY.recorder.register_provider("brokerScheduler",
                                             self.scheduler_snapshot)

    # -- transport registry --------------------------------------------------
    def register_server(self, instance_id: str, server) -> None:
        """``server`` has ``execute_query(ctx, table, segments) ->
        DataTable`` (a ServerInstance)."""
        self._servers[instance_id] = server

    # -- the front door ------------------------------------------------------
    def handle_sql(self, sql: str, principal=None,
                   access_control=None) -> BrokerResponse:
        """Concurrent identical queries (same normalized SQL, principal and
        cluster-state version) share one run: one leader compiles,
        authorizes, scatters, gathers and reduces, and every duplicate gets
        the same BrokerResponse. A store mutation (a push, a config) bumps
        the version, so a later arrival never joins a run whose answer
        predates it. Time-dependent SQL (``now()``) never shares."""
        key = self._flight_key(sql, principal, access_control)
        led = getattr(self._leading, "keys", None)
        if led is None:
            led = self._leading.keys = set()
        if key is None or key in led:
            # not shareable, or a subquery on the leader's own thread
            # (joining its own flight would deadlock)
            return self._handle_sql(sql, principal, access_control)

        def lead():
            led.add(key)
            try:
                return self._handle_sql(sql, principal, access_control)
            finally:
                led.discard(key)

        resp, coalesced = self._flights.do(key, lead)
        if coalesced:
            self.metrics.meter(BrokerMeter.QUERIES).mark()
            self.metrics.meter(BrokerMeter.QUERIES_COALESCED).mark()
        return resp

    def _flight_key(self, sql: str, principal, access_control):
        """None: do not share. The key carries the store's version: any
        mutation ends joinability (a whole-store counter, trading a few
        missed shares for no staleness)."""
        if not isinstance(sql, str):
            return None
        norm = " ".join(sql.split())
        if not norm or "now(" in norm.lower():
            return None     # time-dependent: two calls are not one work
        pkey = getattr(principal, "name", None) if principal is not None \
            else None
        return (norm, pkey,
                id(access_control) if access_control is not None else None,
                self.store.version)

    def scheduler_snapshot(self) -> Dict[str, object]:
        """The single-flight counters and the front-door admission gate."""
        return {"singleFlight": self._flights.snapshot(),
                "admission": self.admission.snapshot()}

    # -- the process telemetry's views ----------------------------------------
    def telemetry_snapshot(self) -> Dict[str, object]:
        """Each (table, phase) histogram with its sliding and lifetime
        quantiles, and the gauge rings."""
        return TELEMETRY.snapshot()

    def slo_snapshot(self) -> Dict[str, object]:
        """Each table's objectives and burn rates."""
        return TELEMETRY.slo_snapshot()

    def flightrecorder_snapshot(self) -> Dict[str, object]:
        """The flight recorder's bundles and rings."""
        return TELEMETRY.recorder.snapshot()

    def freshness_snapshot(self) -> Dict[str, object]:
        """Each realtime table's ingest-to-queryable histogram and burn."""
        return TELEMETRY.freshness_snapshot()

    def _handle_sql(self, sql: str, principal=None,
                    access_control=None) -> BrokerResponse:
        """``access_control`` / ``principal`` authorize the parsed query's
        table; subquery rewrites re-enter with the same principal."""
        start = time.perf_counter()
        self.metrics.meter(BrokerMeter.QUERIES).mark()
        response = BrokerResponse()
        tel_table: List[str] = [""]     # set after the compile

        def phase(name: str, t0: float) -> float:
            """Record a broker phase (BrokerQueryPhase)."""
            now = time.perf_counter()
            ms = (now - t0) * 1e3
            response.phase_times_ms[name] = \
                response.phase_times_ms.get(name, 0.0) + ms
            self.metrics.timer(name).update_ms(ms)
            return now

        def finish(resp: BrokerResponse) -> BrokerResponse:
            # one exceptions tick a failed query, whatever the failure
            if resp.has_exceptions:
                self.metrics.meter(BrokerMeter.EXCEPTIONS).mark()
            # every outcome: the table's windowed latency and SLO counters
            TELEMETRY.note_broker_query(
                tel_table[0], (time.perf_counter() - start) * 1e3,
                resp.has_exceptions)
            return resp

        try:
            ctx = compile_query(sql)
        except SqlParseError as e:
            response.add_exception(SQL_PARSING_ERROR, str(e))
            return finish(response)
        tel_table[0] = ctx.table_name or ""
        phase(BrokerQueryPhase.COMPILATION, start)

        if access_control is not None:
            if not access_control.has_access(principal, ctx.table_name,
                                             "READ"):
                response.add_exception(
                    ACCESS_DENIED_ERROR,
                    f"Permission denied for table {ctx.table_name!r}")
                return finish(response)

        try:
            physical = self._resolve_tables(ctx.table_name)
        except QueryError as e:
            response.add_exception(TABLE_DOES_NOT_EXIST_ERROR, str(e))
            return finish(response)

        if ctx.explain:
            # the logical operator tree, no execution; after the table
            # resolution, so explaining a missing table errors like the
            # query would
            names, types = EXPLAIN_COLUMNS
            response.result_table = ResultTable(DataSchema(names, types),
                                                explain_rows(ctx))
            response.time_used_ms = (time.perf_counter() - start) * 1e3
            return finish(response)

        try:
            # servers run the plain bucket group-by; the reduce fills the
            # gaps
            ctx, gapfill_spec = extract_gapfill(ctx)
        except QueryError as e:
            response.add_exception(QUERY_EXECUTION_ERROR, str(e))
            return finish(response)

        # admission first: the table's quota and the broker's bound ride
        # one gate, so a rejected request starts no subquery; the tickets
        # release in the finally below
        tickets: List[object] = []
        try:
            for table in physical:
                tickets.append(self.admission.admit(table))
        except QueryRejectedError as e:
            for t_adm in tickets:
                self.admission.release(t_adm)
            self.metrics.meter(BrokerMeter.QUERIES_REJECTED).mark()
            response.add_exception(
                TOO_MANY_REQUESTS_ERROR,
                f"{e} (retriable; queueDepth={e.queue_depth})")
            return finish(response)
        admit_wait_ms = sum(t_adm.wait_ms for t_adm in tickets)
        try:
            return self._scatter_reduce(ctx, physical, gapfill_spec,
                                        response, phase, finish, start,
                                        principal, access_control,
                                        admit_wait_ms)
        finally:
            for t_adm in tickets:
                self.admission.release(t_adm)

    def _scatter_reduce(self, ctx, physical, gapfill_spec, response,
                        phase, finish, start, principal, access_control,
                        admit_wait_ms: float = 0.0) -> BrokerResponse:
        """After admission: subquery rewrite -> routing -> scatter / gather
        -> reduce. ``admit_wait_ms``, the front door's admission wait, is
        the broker root's ``Admission`` child on a traced query."""
        try:
            ctx = self._rewrite_subqueries(ctx, principal=principal,
                                           access_control=access_control)
        except AccessDeniedError as e:
            response.add_exception(ACCESS_DENIED_ERROR, str(e))
            return finish(response)
        except QueryError as e:
            response.add_exception(QUERY_EXECUTION_ERROR, str(e))
            return finish(response)

        tables: List[DataTable] = []
        servers_queried = set()
        servers_responded = set()
        # the broker's routing and gather decisions merge into the reduced
        # stats: the response says why each server was or was not asked
        broker_stats = QueryStats()
        # every gathered DataTable folds into the merge as it lands; the
        # finish below runs the final trim / HAVING / post-aggregation
        acc = self.reduce_service.accumulator(ctx)
        for table, sub_ctx in self._split_hybrid(ctx, physical,
                                                 stats=broker_stats):
            t = time.perf_counter()
            route = self.routing.route(table, sub_ctx, stats=broker_stats)
            routing, unavailable = route.routing, route.unavailable
            t = phase(BrokerQueryPhase.ROUTING, t)
            if unavailable:
                self.metrics.meter(BrokerMeter.NO_SERVING_HOST).mark(
                    len(unavailable))
                response.add_exception(
                    SERVER_NOT_RESPONDING_ERROR,
                    f"{len(unavailable)} segments of {table} unavailable: "
                    f"{unavailable[:5]}")
            if not routing:
                continue
            if self._use_streaming(sub_ctx, routing):
                gathered, queried, responded = \
                    self._scatter_gather_streaming(table, sub_ctx, routing,
                                                   broker_stats, acc)
            else:
                gathered, queried, responded = self._scatter_gather(
                    table, sub_ctx, routing, broker_stats, acc)
            phase(BrokerQueryPhase.SCATTER_GATHER, t)
            tables.extend(gathered)
            servers_queried |= queried
            servers_responded |= responded

        response.num_servers_queried = len(servers_queried)
        response.num_servers_responded = len(servers_responded)
        broker_stats.num_servers_queried = len(servers_queried)
        broker_stats.num_servers_responded = len(servers_responded)
        if not tables:
            # an existing but empty table answers with an empty result
            response.stats = broker_stats
            response.time_used_ms = (time.perf_counter() - start) * 1e3
            return finish(response)

        t = time.perf_counter()
        try:
            table, stats, server_errors = acc.finish()
            if gapfill_spec is not None:
                table = apply_gapfill(ctx, table, gapfill_spec)
            response.result_table = table
            # the scatter accounting rides the stats, so a partial result
            # is loud wherever the stats travel
            stats.merge(broker_stats)
            response.stats = stats
            traced = stats if (stats.trace or stats.spans) else None
            for msg in server_errors:
                # a partial result: the table stands, the caller sees it
                response.add_exception(SERVER_NOT_RESPONDING_ERROR, msg)
        except QueryError as e:
            traced = None
            response.stats = broker_stats
            response.add_exception(QUERY_EXECUTION_ERROR, str(e))
        phase(BrokerQueryPhase.REDUCE, t)
        response.time_used_ms = (time.perf_counter() - start) * 1e3
        if traced is not None:
            # after the REDUCE timer, so the root's children cover the
            # broker's whole wall time
            root = build_broker_root(
                response.phase_times_ms, traced.spans,
                response.time_used_ms, admission_wait_ms=admit_wait_ms,
                reduce_folds=acc.fold_spans)
            response.trace_info = {"entries": traced.trace,
                                   "spans": [root]}
        return finish(response)

    # -- IN_SUBQUERY (the IdSet semijoin) ----------------------------------------
    MAX_SUBQUERY_DEPTH = 3

    def _rewrite_subqueries(self, ctx: QueryContext, principal=None,
                            access_control=None) -> QueryContext:
        """``inSubquery(col, '<sql>')`` predicates: run the inner query
        first (typically ``SELECT idset(col) FROM ...``), then rewrite to
        ``inIdSet(col, <serialized set>)`` so servers evaluate a plain
        membership transform."""
        if ctx.filter is None:
            return ctx

        def walk(node: FilterNode) -> FilterNode:
            if node.predicate is not None:
                p = node.predicate
                lhs = p.lhs
                if (isinstance(lhs, Function)
                        and lhs.name in ("insubquery", "in_subquery")):
                    if len(lhs.args) != 2 \
                            or not isinstance(lhs.args[1], Literal):
                        raise QueryError(
                            "inSubquery(column, 'sql literal') expected")
                    inner_sql = str(lhs.args[1].value)
                    tl = self._subq_local
                    tl.depth = getattr(tl, "depth", 0) + 1
                    try:
                        if tl.depth > self.MAX_SUBQUERY_DEPTH:
                            raise QueryError("IN_SUBQUERY nesting too deep")
                        # inner queries carry the OUTER principal: a
                        # table-scoped caller must not semijoin/probe
                        # other tables through the rewrite
                        inner = self.handle_sql(
                            inner_sql, principal=principal,
                            access_control=access_control)
                    finally:
                        tl.depth -= 1
                    if any(e.get("errorCode") == ACCESS_DENIED_ERROR
                           for e in inner.exceptions):
                        # the denial must keep its identity end to end so
                        # the REST layer returns 403, same as a direct query
                        raise AccessDeniedError(
                            f"IN_SUBQUERY inner query denied: "
                            f"{inner.exceptions[0].get('message')}")
                    if inner.has_exceptions or inner.result_table is None \
                            or not inner.result_table.rows:
                        raise QueryError(
                            f"IN_SUBQUERY inner query failed: "
                            f"{inner.exceptions[:1] or 'empty result'}")
                    if (len(inner.result_table.rows) != 1
                            or len(inner.result_table.rows[0]) != 1):
                        raise QueryError(
                            "IN_SUBQUERY inner query must return exactly "
                            "one IDSET() value (no GROUP BY)")
                    idset = inner.result_table.rows[0][0]
                    if not isinstance(idset, str):
                        raise QueryError(
                            "IN_SUBQUERY inner query must produce IDSET()")
                    new_lhs = Function("inidset",
                                       (lhs.args[0], Literal(idset)))
                    return FilterNode.pred(replace(p, lhs=new_lhs))
                return node
            kids = tuple(walk(c) for c in node.children)
            if all(a is b for a, b in zip(kids, node.children)):
                return node  # untouched subtree: no rebuild on the hot path
            return FilterNode(node.op, children=kids, predicate=None)

        new_filter = walk(ctx.filter)
        if new_filter is ctx.filter:
            return ctx
        return replace(ctx, filter=new_filter)

    def _resolve_tables(self, raw_name: str) -> List[str]:
        """``myTable`` -> its physical tables; explicit ``_OFFLINE`` /
        ``_REALTIME`` names pass through."""
        known = set(self.store.table_names())
        if raw_name in known:
            return [raw_name]
        out = [table_name_with_type(raw_name, t)
               for t in (TableType.OFFLINE, TableType.REALTIME)
               if table_name_with_type(raw_name, t) in known]
        if not out:
            raise QueryError(f"table {raw_name!r} does not exist")
        return out

    def _split_hybrid(self, ctx: QueryContext, physical: List[str],
                      stats: Optional[QueryStats] = None
                      ) -> List[Tuple[str, QueryContext]]:
        """The physical tables to ask, each with its filter: a hybrid
        table splits at the time boundary; every outcome is recorded."""
        if len(physical) < 2:
            record_decision(stats, "hybrid", "direct", "time_split",
                            "hybrid_single_table")
            return [(physical[0], ctx)]
        offline = next(t for t in physical if t.endswith("_OFFLINE"))
        realtime = next(t for t in physical if t.endswith("_REALTIME"))
        cfg = self.store.get_table_config(offline)
        tc = cfg.validation_config.time_column_name if cfg else None
        if tc is None:
            # no time column: the split's range cannot be written
            record_decision(stats, "hybrid", "realtime_all", "time_split",
                            "hybrid_no_time_column")
            return [(realtime, ctx)]
        boundary = self.routing.time_boundary.get_boundary(offline)
        if boundary is None:
            # no offline segment yet: the realtime side serves everything
            record_decision(stats, "hybrid", "realtime_all", "time_split",
                            "hybrid_no_boundary")
            return [(realtime, ctx)]
        record_decision(stats, "hybrid", "time_split", "realtime_all",
                        "hybrid_time_split")
        off_pred = FilterNode.pred(Predicate(
            PredicateType.RANGE, Identifier(tc), upper=boundary,
            upper_inclusive=True))
        rt_pred = FilterNode.pred(Predicate(
            PredicateType.RANGE, Identifier(tc), lower=boundary,
            lower_inclusive=False))
        return [(offline, replace(ctx, filter=_and(ctx.filter, off_pred))),
                (realtime, replace(ctx, filter=_and(ctx.filter, rt_pred)))]

    # -- streaming scatter/gather: selection-only queries pull per-segment
    # blocks from all servers at once and stop the moment offset + limit
    # rows arrived
    def _scatter_gather_streaming(self, table: str, ctx: QueryContext,
                                  routing: Dict[str, List[str]],
                                  broker_stats: Optional[QueryStats] = None,
                                  acc=None):
        need = ctx.offset + ctx.limit
        queried, responded = set(), set()
        enough = threading.Event()
        lock = threading.Lock()
        have = [0]

        def pull(server, segments) -> List[DataTable]:
            out: List[DataTable] = []
            for block in server.execute_query_streaming(ctx, table,
                                                        segments):
                out.append(block)
                if not block.exceptions:
                    with lock:
                        have[0] += block.num_rows()
                        if have[0] >= need:
                            enough.set()
                if enough.is_set():
                    break
            return out

        futures = {}
        for instance_id, segments in routing.items():
            queried.add(instance_id)
            server = self._servers.get(instance_id)
            if server is None:
                futures[instance_id] = None
                continue
            futures[instance_id] = self._pool.submit(
                lambda srv=server, segs=segments: pull(srv, segs))

        gathered: List[DataTable] = []

        def took(dt: DataTable, instance_id: str) -> None:
            gathered.append(dt)
            if acc is not None:
                acc.add(dt, instance=instance_id)

        deadline = time.monotonic() + self.query_timeout_s
        for instance_id, fut in self._as_arrivals(futures, deadline):
            if fut is None:
                took(DataTable.for_exception(
                    f"server {instance_id} is not connected"), instance_id)
                record_decision(broker_stats, "gather", "partial_result",
                                "full_result", "server_not_connected")
                continue
            try:
                if isinstance(fut, FutureTimeout):
                    raise fut
                ok = False
                for dt in fut.result(timeout=0.001):
                    dt = _tag_trace(dt, instance_id)
                    took(dt, instance_id)
                    ok = ok or not dt.exceptions
                # responded = returned at least one USABLE block; a server
                # that only errored is down for accounting purposes
                if ok:
                    responded.add(instance_id)
                else:
                    record_decision(broker_stats, "gather", "partial_result",
                                    "full_result", "server_error")
            except FutureTimeout:
                enough.set()  # stop the straggler's pull loop
                took(DataTable.for_exception(
                    f"server {instance_id} timed out after "
                    f"{self.query_timeout_s}s"), instance_id)
                record_decision(broker_stats, "gather", "partial_result",
                                "full_result", "server_timeout")
            except Exception as e:  # noqa: BLE001
                took(DataTable.for_exception(
                    f"server {instance_id} failed: {e!r}"), instance_id)
                record_decision(broker_stats, "gather", "partial_result",
                                "full_result", "server_error")
        return gathered, queried, responded

    @staticmethod
    def _as_arrivals(futures: Dict[str, object], deadline: float):
        """Yield ``(instance_id, future)`` in completion order (reduce as
        arrivals: a fast server's table folds while the stragglers still
        run). Not-connected entries (None) yield first; a future still
        pending at the deadline yields a ``FutureTimeout`` in its
        place."""
        pending = {}
        for instance_id, fut in futures.items():
            if fut is None:
                yield instance_id, None
            else:
                pending[fut] = instance_id
        if not pending:
            return
        try:
            for fut in as_completed(
                    pending, timeout=max(deadline - time.monotonic(),
                                         0.001)):
                yield pending.pop(fut), fut
        except FutureTimeout as e:
            for fut, instance_id in pending.items():
                yield instance_id, (fut if fut.done() else e)

    def _use_streaming(self, ctx: QueryContext,
                       routing: Dict[str, List[str]]) -> bool:
        return (ctx.is_selection and not ctx.order_by
                and not ctx.distinct
                and all(hasattr(self._servers.get(i), "execute_query_streaming")
                        for i in routing))

    # -- scatter/gather ------------------------------------------------------------
    def _scatter_gather(self, table: str, ctx: QueryContext,
                        routing: Dict[str, List[str]],
                        broker_stats: Optional[QueryStats] = None,
                        acc=None):
        """Per-server failure handling: a down / not-connected / timed-out
        server yields a partial result — its error travels as an exception
        DataTable, it is NOT counted as responded, and the reason lands on
        the query's decisions — never a hung or silently wrong answer.

        Tables are processed in COMPLETION order and folded into ``acc``
        (the reduce accumulator) as they land — the broker reduces the
        fast servers' answers while the stragglers are still running."""
        queried, responded = set(), set()
        futures = {}
        for instance_id, segments in routing.items():
            server = self._servers.get(instance_id)
            queried.add(instance_id)
            if server is None:
                futures[instance_id] = None
                continue
            futures[instance_id] = self._pool.submit(
                lambda srv=server, segs=segments:
                srv.execute_query(ctx, table, segs))
        gathered: List[DataTable] = []

        def took(dt: DataTable, instance_id: str) -> None:
            gathered.append(dt)
            if acc is not None:
                acc.add(dt, instance=instance_id)

        deadline = time.monotonic() + self.query_timeout_s
        for instance_id, fut in self._as_arrivals(futures, deadline):
            if fut is None:
                took(DataTable.for_exception(
                    f"server {instance_id} is not connected"), instance_id)
                record_decision(broker_stats, "gather", "partial_result",
                                "full_result", "server_not_connected")
                continue
            try:
                if isinstance(fut, FutureTimeout):
                    raise fut
                dt = _tag_trace(fut.result(timeout=0.001), instance_id)
                took(dt, instance_id)
                # responded = came back with a USABLE DataTable; a server
                # that answered with only an error (shut down mid-scatter,
                # table not hosted) is accounted as a gather failure
                if dt.exceptions:
                    record_decision(broker_stats, "gather", "partial_result",
                                    "full_result", "server_error")
                else:
                    responded.add(instance_id)
            except FutureTimeout:
                took(DataTable.for_exception(
                    f"server {instance_id} timed out after "
                    f"{self.query_timeout_s}s"), instance_id)
                record_decision(broker_stats, "gather", "partial_result",
                                "full_result", "server_timeout")
            except Exception as e:
                took(DataTable.for_exception(
                    f"server {instance_id} failed: {e!r}"), instance_id)
                record_decision(broker_stats, "gather", "partial_result",
                                "full_result", "server_error")
        return gathered, queried, responded

    def shutdown(self) -> None:
        self._pool.stop()


def _and(a: Optional[FilterNode], b: FilterNode) -> FilterNode:
    if a is None:
        return b
    return FilterNode(FilterOp.AND, children=(a, b))


def _tag_trace(dt: DataTable, instance_id: str) -> DataTable:
    """A traced table's flat entries and span roots tagged with their
    server before the reduce merges them (JAX :788): after the broker's
    root adopts every server's tree, the tag is the only trace of its
    origin. The tags go on a copy of the table and of its trace, so a
    table shared in process is left as it was."""
    st = dt.stats
    if not (st.trace or st.spans):
        return dt
    st = copy.copy(st)
    st.trace = [e if "instance" in e else {**e, "instance": instance_id}
                for e in st.trace]
    st.spans = [r if "instance" in r else {**r, "instance": instance_id}
                for r in st.spans]
    dt = copy.copy(dt)
    dt.stats = st
    return dt
