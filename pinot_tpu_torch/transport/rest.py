"""HTTP/REST APIs: the controller's admin routes, the broker's query
front door, and each server's admin and debug routes.

Counterpart of ``pinot_tpu/transport/rest.py``: every route on the same
path with the same JSON body (``_Api`` :34 with its 401 / 403 scoping,
``ControllerApi`` :170, ``BrokerApi`` :431 with its ``/debug/*`` views,
``serve_cluster`` :516, ``ServerAdminApi`` :530 with every ``/debug/*``
route, ``/debug/pallas`` and the evict / demote POSTs), on the standard
library's threading HTTP server. The port's schemas and table configs
travel as JAX's JSON dicts; a state-store node that holds one is shown as
its dict (``/zk/get``). A query's kernels launch in the servers' runner
threads, which bind each query's ``QueryStats`` (its launch counts), never
in a handler thread.

Re-design of the reference's Jersey resources — controller
(``pinot-controller/.../api/resources/*``: tables, schemas, segments,
rebalance), broker (``pinot-broker/.../api/resources/PinotClientRequest``:
``POST /query/sql``), server health — on the stdlib threading HTTP server
(the control plane is not a throughput surface; the data plane is gRPC).
Endpoint paths and JSON shapes follow the reference so its clients carry
over.
"""

from __future__ import annotations

import json
import logging
import re
import threading

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from pinot_tpu_torch.common.netserver import listen
from pinot_tpu_torch.controller.state import InstanceInfo, to_wire
from pinot_tpu_torch.spi.auth import READ, WRITE, AllowAllAccessControl
from pinot_tpu_torch.spi.data import Schema
from pinot_tpu_torch.spi.filesystem import file_url
from pinot_tpu_torch.spi.table import TableConfig, raw_table_name

log = logging.getLogger(__name__)

# (method, pattern, handler, table_scope): table_scope=False marks routes
# whose first path capture is NOT a table name (instance ids, task types,
# zk node paths) so authorization runs cluster-scoped (table=None) instead
# of granting/denying against the wrong scope
Route = Tuple[str, re.Pattern, Callable, bool]


class _Api:
    """Tiny method+path router on ThreadingHTTPServer.

    ``access_control`` guards every route (ref: the AccessControlFactory
    hook in BaseBrokerStarter / controller admin app): unauthenticated
    requests get 401, authenticated-but-unauthorized get 403. Health
    endpoints stay open (liveness probes don't carry credentials)."""

    OPEN_PATHS = ("/health",)
    # POSTs that are semantically reads (authorized with READ, not WRITE)
    READ_POSTS = ("/query/sql", "/state/get", "/state/poll")

    def __init__(self, port: int = 0, access_control=None):
        self._routes: List[Route] = []
        self.access_control = access_control or AllowAllAccessControl()
        self._principal_local = threading.local()
        api = self

        class Handler(BaseHTTPRequestHandler):
            # quiet default request logging
            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _dispatch(self, method: str):
                try:
                    path_only = self.path.split("?", 1)[0]
                    principal = api.access_control.authenticate(self.headers)
                    if principal is None \
                            and path_only not in api.OPEN_PATHS:
                        self.send_response(401)
                        self.send_header("WWW-Authenticate",
                                         'Basic realm="pinot"')
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    api._principal_local.value = principal
                    body = None
                    n = int(self.headers.get("Content-Length") or 0)
                    if n:
                        body = json.loads(self.rfile.read(n).decode("utf-8"))
                    for m, pat, fn, table_scope in api._routes:
                        if m != method:
                            continue
                        match = pat.fullmatch(self.path.split("?", 1)[0])
                        if match:
                            if path_only not in api.OPEN_PATHS:
                                # method-level authorization: mutations need
                                # WRITE, scoped to the table the route acts
                                # on — path captures name it for /tables/x,
                                # /segments/x, /schemas/x; body-borne
                                # mutations (POST /tables, /segments,
                                # /schemas) name it in the payload (ref:
                                # per-table auth on the segment/table
                                # controller resources)
                                access = READ if (method == "GET" or path_only
                                                  in api.READ_POSTS) else WRITE
                                table = (match.group(1)
                                         if pat.groups and table_scope
                                         else None)
                                if table is None and isinstance(body, dict):
                                    # route-aware: the auth scope must be
                                    # the SAME name the handler mutates —
                                    # schemas routes act on schemaName,
                                    # table/segment routes on tableName (a
                                    # mixed body must not authorize one
                                    # name and mutate another)
                                    table = (body.get("schemaName")
                                             if path_only.startswith(
                                                 "/schemas")
                                             else body.get("tableName"))
                                if not api.access_control.has_access(
                                        principal, table, access):
                                    self.send_error(403, "permission denied")
                                    return
                            code, payload = fn(match, body)
                            if isinstance(payload, str):
                                # text endpoints (/metrics prometheus, /ui)
                                raw = payload.encode("utf-8")
                                ctype = ("text/html; charset=utf-8"
                                         if payload.startswith("<!doctype")
                                         else "text/plain; version=0.0.4")
                            else:
                                raw = json.dumps(payload).encode("utf-8")
                                ctype = "application/json"
                            self.send_response(code)
                            self.send_header("Content-Type", ctype)
                            self.send_header("Content-Length", str(len(raw)))
                            self.end_headers()
                            self.wfile.write(raw)
                            return
                    self.send_error(404, "no such endpoint")
                except Exception as e:  # noqa: BLE001 — HTTP boundary
                    log.exception("request failed: %s %s", method, self.path)
                    try:
                        self.send_error(500, str(e)[:200])
                    except Exception:
                        pass

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        # a backlog for concurrent clients (JAX's routers keep the
        # standard library's 5), a port-0 server on a fresh port
        self._httpd = listen(ThreadingHTTPServer, ("0.0.0.0", port),
                             Handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    def route(self, method: str, pattern: str, fn: Callable,
              table_scope: bool = True) -> None:
        self._routes.append((method, re.compile(pattern), fn, table_scope))

    def current_principal(self):
        """The principal of the request being dispatched on THIS thread."""
        return getattr(self._principal_local, "value", None)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="rest-api")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class ControllerApi(_Api):
    """Ref: controller api/resources (45 Jersey resources, reduced to the
    operative set: schemas, tables, segments, state, rebalance, health)."""

    def __init__(self, controller, port: int = 0, access_control=None):
        super().__init__(port, access_control=access_control)
        c = controller
        store = controller.store

        self.route("GET", r"/health",
                   lambda m, b: (200, {"status": "OK"}))
        self.route("GET", r"/metrics",
                   lambda m, b: (200, c.metrics.export_prometheus()))
        # schemas (ref: PinotSchemaRestletResource)
        self.route("POST", r"/schemas",
                   lambda m, b: (200, self._add_schema(c, b)))
        self.route("GET", r"/schemas",
                   lambda m, b: (200, store.schema_names()))
        self.route("GET", r"/schemas/([^/]+)",
                   lambda m, b: self._get_schema(store, m.group(1)))
        # tables (ref: PinotTableRestletResource)
        self.route("POST", r"/tables",
                   lambda m, b: (200, self._add_table(c, b)))
        self.route("PUT", r"/tables/([^/]+)",
                   lambda m, b: self._update_table(c, m.group(1), b))
        self.route("GET", r"/tables",
                   lambda m, b: (200, {"tables": store.table_names()}))
        self.route("DELETE", r"/tables/([^/]+)",
                   lambda m, b: (200, self._delete_table(c, m.group(1))))
        self.route("GET", r"/tables/([^/]+)/idealstate",
                   lambda m, b: (200, store.get_ideal_state(m.group(1))))
        self.route("GET", r"/tables/([^/]+)/externalview",
                   lambda m, b: (200, store.get_external_view(m.group(1))))
        self.route("POST", r"/tables/([^/]+)/rebalance",
                   lambda m, b: (200, {"steps": c.rebalance_table(
                       m.group(1), dry_run=bool((b or {}).get("dryRun")))}))
        # segments (ref: PinotSegmentUploadDownloadRestletResource:102 —
        # local-path upload; multi-host file upload arrives with deep store)
        self.route("POST", r"/segments",
                   lambda m, b: (200, self._add_segment(c, b)))
        # ref: PinotSegmentRestletResource POST /segments/{table}/reload
        self.route("POST", r"/segments/([^/]+)/reload",
                   lambda m, b: (200, self._reload(c, m.group(1))))
        self.route("GET", r"/segments/([^/]+)",
                   lambda m, b: (200, store.segment_names(m.group(1))))
        self.route("GET", r"/instances",
                   lambda m, b: (200, {"instances": [
                       i.to_dict() for i in store.instances()]}))
        # lineage (ref: startReplaceSegments/endReplaceSegments REST);
        # protocol conflicts are 409, unknown entries 404, outputs not served
        # before the swap's timeout 504 (reverted) — a retrying
        # client must distinguish them from server faults
        self.route("POST", r"/segments/([^/]+)/startReplaceSegments",
                   lambda m, b: self._start_replace(c, m, b))
        self.route("POST", r"/segments/([^/]+)/endReplaceSegments/([^/]+)",
                   lambda m, b: self._lineage_flip(
                       c.end_replace_segments, m))
        self.route("POST", r"/segments/([^/]+)/revertReplaceSegments/([^/]+)",
                   lambda m, b: self._lineage_flip(
                       c.revert_replace_segments, m))
        # recommender (ref: RecommenderDriver via PinotTableRestletResource)
        self.route("POST", r"/tables/([^/]+)/recommender",
                   lambda m, b: self._recommend(store, m.group(1), b))
        # tenants (ref: PinotTenantRestletResource): tenants are instance
        # tag groups; SERVER/BROKER membership comes from instance tags
        self.route("GET", r"/tenants",
                   lambda m, b: (200, self._tenants(store)))
        # the capture is a tenant (instance tag group), not a table
        self.route("GET", r"/tenants/([^/]+)",
                   lambda m, b: (200, self._tenant(store, m.group(1))),
                   table_scope=False)
        # the capture is an INSTANCE id, not a table — cluster-scoped auth
        self.route("PUT", r"/instances/([^/]+)/updateTags",
                   lambda m, b: self._update_tags(c, m.group(1), b),
                   table_scope=False)
        # minion tasks (ref: PinotTaskRestletResource); the capture is a
        # task TYPE, not a table — cluster-scoped auth
        self.route("GET", r"/tasks/tasktypes",
                   lambda m, b: (200, self._task_types()))
        self.route("GET", r"/tasks/([^/]+)/state",
                   lambda m, b: (200, {
                       t.task_id: t.status
                       for t in c.task_manager.list_tasks()
                       if t.task_type == m.group(1)}),
                   table_scope=False)
        self.route("POST", r"/tasks/schedule",
                   lambda m, b: (200, {"generated":
                                       c.task_manager.generate_tasks()}))
        # state-store browse (ref: ZookeeperResource /zk/ls + /zk/get; the
        # node path rides IN the URL path after the verb — never a table)
        self.route("GET", r"/zk/ls(?:/(.*))?",
                   lambda m, b: (200, store.children(m.group(1))
                                 if m.group(1)
                                 else sorted(store.snapshot_data()[1])),
                   table_scope=False)
        self.route("GET", r"/zk/get/(.+)",
                   lambda m, b: self._zk_get(store, m.group(1)),
                   table_scope=False)
        # minimal cluster status UI (ref: the controller's bundled web app)
        self.route("GET", r"/ui",
                   lambda m, b: (200, self._render_ui(store)))

    @staticmethod
    def _task_types() -> List[str]:
        """REGISTERED task types (ref: PinotTaskRestletResource
        listTaskTypes reads the registry, not materialized task records)."""
        from pinot_tpu_torch.controller.tasks import _GENERATORS

        return sorted(_GENERATORS)

    @staticmethod
    def _tenants(store) -> Dict[str, Any]:
        """All tags grouped by role (ref: PinotTenantRestletResource
        getAllTenants)."""
        server, broker = set(), set()
        for i in store.instances():
            target = (server if i.instance_type.upper().startswith("SERVER")
                      else broker if
                      i.instance_type.upper().startswith("BROKER") else None)
            if target is not None:
                target.update(i.tags)
        return {"SERVER_TENANTS": sorted(server),
                "BROKER_TENANTS": sorted(broker)}

    @staticmethod
    def _tenant(store, name: str) -> Dict[str, Any]:
        return {"tenantName": name,
                "instances": sorted(i.instance_id for i in store.instances()
                                    if name in i.tags)}

    @staticmethod
    def _update_tags(c, instance_id: str, body):
        tags = (body or {}).get("tags")
        if not isinstance(tags, list) or not all(
                isinstance(t, str) for t in tags):
            return 400, {"error": "body must carry {'tags': [str, ...]}"}
        try:
            c.update_instance_tags(instance_id, tags)
        except KeyError as e:
            return 404, {"error": str(e)}
        return 200, {"status": f"Updated tags of {instance_id}"}

    @staticmethod
    def _zk_get(store, path: str):
        v = store.get(path)
        return (404, {"error": f"no node at {path!r}"}) if v is None \
            else (200, {"path": path, "value": to_wire(v)})

    @staticmethod
    def _start_replace(c, m, b):
        try:
            eid = c.start_replace_segments(
                m.group(1), (b or {}).get("segmentsFrom", []),
                (b or {}).get("segmentsTo", []))
        except ValueError as e:  # overlapping in-progress replacement
            return 409, {"error": str(e)}
        return 200, {"segmentLineageEntryId": eid}

    @staticmethod
    def _lineage_flip(fn, m):
        try:
            fn(m.group(1), m.group(2))
        except KeyError as e:
            return 404, {"error": str(e)}
        except ValueError as e:  # wrong state for the transition
            return 409, {"error": str(e)}
        except TimeoutError as e:  # outputs not served in time: reverted
            return 504, {"error": str(e)}
        return 200, {"status": "done"}

    @staticmethod
    def _recommend(store, table: str, body):
        from pinot_tpu_torch.controller.recommender import recommend

        schema = store.get_schema(raw_table_name(table))
        if schema is None:
            return 404, {"error": f"no schema for table {table}"}
        return 200, recommend(schema, (body or {}).get("queries", []),
                              qps=float((body or {}).get("qps", 0)))

    @staticmethod
    def _render_ui(store) -> str:
        """One self-contained HTML status page (tables / segments /
        instances) — the operational core of the reference's React app."""
        from html import escape

        rows = []
        for t in store.table_names():
            ideal = store.get_ideal_state(t)
            ev = store.get_external_view(t)
            rows.append(f"<tr><td>{escape(t)}</td><td>{len(ideal)}</td>"
                        f"<td>{len(ev)}</td></tr>")
        inst = [f"<tr><td>{escape(i.instance_id)}</td>"
                f"<td>{escape(i.instance_type)}</td>"
                f"<td>{'up' if i.alive else 'DOWN'}</td>"
                f"<td>{escape(', '.join(i.tags))}</td></tr>"
                for i in store.instances()]
        return ("<!doctype html><title>pinot-tpu</title>"
                "<style>body{font-family:sans-serif;margin:2em}"
                "table{border-collapse:collapse;margin:1em 0}"
                "td,th{border:1px solid #ccc;padding:4px 10px}</style>"
                "<h1>pinot-tpu cluster</h1>"
                "<h2>Tables</h2><table><tr><th>table</th><th>segments "
                "(ideal)</th><th>segments (serving)</th></tr>"
                + "".join(rows) + "</table>"
                "<h2>Instances</h2><table><tr><th>id</th><th>type</th>"
                "<th>state</th><th>tags</th></tr>"
                + "".join(inst) + "</table>")

    @staticmethod
    def _add_schema(c, body) -> Dict[str, Any]:
        schema = Schema.from_dict(body)
        c.add_schema(schema)
        return {"status": f"{schema.schema_name} successfully added"}

    @staticmethod
    def _get_schema(store, name):
        s = store.get_schema(name)
        return (404, {"error": f"schema {name} not found"}) if s is None \
            else (200, s.to_dict())

    @staticmethod
    def _add_table(c, body) -> Dict[str, Any]:
        cfg = TableConfig.from_dict(body)
        c.add_table(cfg)
        return {"status": f"Table {cfg.table_name_with_type} successfully "
                          "added"}

    @staticmethod
    def _delete_table(c, name) -> Dict[str, Any]:
        c.delete_table(name)
        return {"status": f"Table deleted {name}"}

    @staticmethod
    def _update_table(c, url_name: str, body):
        cfg = TableConfig.from_dict(body)
        # URL and body must agree (ref: PinotTableRestletResource rejects
        # the mismatch) — a stale body must not overwrite another table
        if url_name not in (cfg.table_name, cfg.table_name_with_type):
            return (400, {"error": f"table name {url_name!r} in the URL "
                                   f"does not match the body "
                                   f"({cfg.table_name_with_type})"})
        c.update_table(cfg)
        return (200, {"status": f"Table config updated for "
                                f"{cfg.table_name_with_type}"})

    @staticmethod
    def _reload(c, table) -> Dict[str, Any]:
        c.reload_table(table)
        return {"status": f"Submitted reload for table: {table}"}

    @staticmethod
    def _add_segment(c, body) -> Dict[str, Any]:
        from pinot_tpu_torch.segment.immutable import load_segment

        table = body["tableName"]
        seg_dir = body["segmentDir"]
        md = load_segment(seg_dir).metadata
        c.add_segment(table, md, file_url(seg_dir))
        return {"status": f"Successfully uploaded segment: "
                          f"{md.segment_name} of table: {table}"}


class BrokerApi(_Api):
    """Ref: broker api/resources PinotClientRequest — POST /query/sql."""

    def __init__(self, broker, port: int = 0, access_control=None):
        super().__init__(port, access_control=access_control)

        def query(m, body):
            from pinot_tpu_torch.broker.broker import ACCESS_DENIED_ERROR

            sql = (body or {}).get("sql", "")
            # per-table authorization happens INSIDE the broker on the
            # parsed query (and on every IN_SUBQUERY inner query) — a raw
            # regex over the SQL is spoofable via string literals
            resp = broker.handle_sql(sql,
                                     principal=self.current_principal(),
                                     access_control=self.access_control)
            denied = any(e.get("errorCode") == ACCESS_DENIED_ERROR
                         for e in resp.exceptions)
            return (403 if denied else 200), resp.to_dict()

        self.route("POST", r"/query/sql", query)
        self.route("GET", r"/health", lambda m, b: (200, {"status": "OK"}))
        self._broker = broker
        self.route("GET", r"/metrics",
                   lambda m, b: (200, broker.metrics.export_prometheus()))
        def debug_routing(m, b):
            """The routing snapshot + scatter accounting for one table:
            which servers would be scattered to, what's unavailable, and
            the segment counts behind the prune ratio (the ops view of
            the partition/time metadata pushed into the routing table)."""
            res = broker.routing.route(m.group(1))
            return 200, {
                "routing": dict(res.routing),
                "unavailable": list(res.unavailable),
                "segmentsTotal": res.segments_total,
                "segmentsRouted": res.segments_routed,
                "timePruned": res.time_pruned,
                "partitionPruned": res.partition_pruned,
                "serversRouted": res.servers_routed,
            }

        self.route("GET", r"/debug/routing/([^/]+)", debug_routing)
        # single-flight coalescing + front-door admission counters
        # (broker half of the scheduler-tier ops view)
        self.route("GET", r"/debug/scheduler",
                   lambda m, b: (200, broker.scheduler_snapshot()))
        # continuous telemetry: windowed (table, phase) histograms with
        # sliding p50/p95/p99 + gauge-history rings
        self.route("GET", r"/debug/telemetry",
                   lambda m, b: (200, broker.telemetry_snapshot()))
        # per-table SLO objectives + multi-window burn rates
        self.route("GET", r"/debug/slo",
                   lambda m, b: (200, broker.slo_snapshot()))
        # ingest-to-queryable freshness histograms + objective burn
        self.route("GET", r"/debug/freshness",
                   lambda m, b: (200, broker.freshness_snapshot()))
        # the flight recorder's bundle index + last post-mortem bundle
        self.route("GET", r"/debug/flightrecorder",
                   lambda m, b: (200, broker.flightrecorder_snapshot()))

    def start(self) -> None:
        super().start()
        # advertise this broker in cluster state so dynamic broker
        # selectors can discover it (ref: brokers register their query
        # endpoint in ZK; DynamicBrokerSelector watches that list)
        store = getattr(self._broker, "store", None)
        if store is not None:
            self._instance_id = f"Broker_localhost_{self.port}"
            store.register_instance(InstanceInfo(
                self._instance_id, "BROKER",
                host="localhost", port=self.port))

    def stop(self) -> None:
        # deregister LOUDLY: an ephemeral-port restart would otherwise
        # accumulate alive=True ghosts that selectors dial and the query
        # quota divides by (the ZK ephemeral-znode-expiry analogue)
        store = getattr(self._broker, "store", None)
        iid = getattr(self, "_instance_id", None)
        if store is not None and iid is not None:
            store.set_instance_alive(iid, False)
        super().stop()


def serve_cluster(cluster, controller_port: int = 0, broker_port: int = 0,
                  access_control=None):
    """Expose an EmbeddedCluster over REST: controller admin + broker query
    endpoints (ref: QuickstartRunner wiring the role REST apps). Returns
    the started APIs; call ``.stop()`` on each to tear down."""
    apis = [ControllerApi(cluster.controller, port=controller_port,
                          access_control=access_control),
            BrokerApi(cluster.broker, port=broker_port,
                      access_control=access_control)]
    for api in apis:
        api.start()
    return apis


class ServerAdminApi(_Api):
    """Ref: server api/resources TablesResource (health + hosted state)."""

    def __init__(self, server_instance, port: int = 0,
                 access_control=None):
        super().__init__(port, access_control=access_control)
        s = server_instance
        self.route("GET", r"/health", lambda m, b: (200, {"status": "OK"}))
        self.route("GET", r"/metrics",
                   lambda m, b: (200, s.metrics.export_prometheus()))
        self.route("GET", r"/tables",
                   lambda m, b: (200, {"tables": s.hosted_tables()}))
        self.route("GET", r"/tables/([^/]+)/segments",
                   lambda m, b: (200, {m.group(1):
                                       s.hosted_segments(m.group(1))}))
        # ref: TableSizeResource / MmapDebugResource
        self.route("GET", r"/tables/([^/]+)/size",
                   lambda m, b: (200, s.table_size(m.group(1))))
        self.route("GET", r"/debug/memory",
                   lambda m, b: (200, s.memory_debug()))
        # launch-coalescing counters (requests vs device launches, batch
        # sizes, queue waits) — the QPS-scaling ops view
        self.route("GET", r"/debug/launches",
                   lambda m, b: (200, s.launch_debug()))
        # scheduler-tier snapshot: dispatch policy + queue depth, admission
        # bounds/rejections, adaptive launch window, kernel single-flight
        self.route("GET", r"/debug/scheduler",
                   lambda m, b: (200, s.scheduler_debug()))
        # query lifecycle registry: running queries (id/sql/phase/elapsed/
        # pins), completed ring buffer, and the slow-query log with
        # retained span trees (pinot.server.query.slow.threshold.ms)
        self.route("GET", r"/debug/queries",
                   lambda m, b: (200, s.queries_debug()))
        # continuous telemetry: sliding-percentile (table, phase) latency
        # histograms + the gauge-history rings behind the instant gauges
        self.route("GET", r"/debug/telemetry",
                   lambda m, b: (200, s.telemetry_debug()))
        # per-table SLO burn rates (objectives from pinot.broker.slo.*)
        self.route("GET", r"/debug/slo",
                   lambda m, b: (200, s.slo_debug()))
        # per-table ingest-to-queryable freshness (realtime tables)
        self.route("GET", r"/debug/freshness",
                   lambda m, b: (200, s.freshness_debug()))
        # anomaly-triggered flight recorder: post-mortem bundle index +
        # the last frozen bundle (span roots, decision deltas, snapshots)
        self.route("GET", r"/debug/flightrecorder",
                   lambda m, b: (200, s.flightrecorder_debug()))
        # per-shape pallas blocklist (runtime failures + preflight-seeded
        # predictions, each with its decline reason) + the last kernel
        # preflight verdict table (tools/preflight.py)
        self.route("GET", r"/debug/pallas",
                   lambda m, b: (200, s.pallas_debug()))
        # ops hook for the HBM budget knob: force-drop one resident's
        # device arrays (in-flight queries keep theirs via python refs;
        # the next query re-stages)
        self.route("POST", r"/debug/memory/evict/([^/]+)",
                   lambda m, b: (200, s.evict_staged(m.group(1))))
        # tiered-residency sibling: force-demote one resident to the
        # host-RAM tier (next query promotes with a plain H2D instead of
        # a rebuild); /debug/memory reports both tiers' byte accounting
        self.route("POST", r"/debug/memory/demote/([^/]+)",
                   lambda m, b: (200, s.demote_staged(m.group(1))))
