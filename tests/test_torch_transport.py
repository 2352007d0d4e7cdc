"""The port's wire against the JAX package's, over real sockets.

Both packages' ``EmbeddedCluster`` (2 servers, segments on disk) hold the
same rows under the same segment names, each behind its own front doors;
every request goes to both, and the answers are compared: tests/
test_transport.py's REST and gRPC cases, tests/test_client_trace.py's
client cases, the debug routes of tests/test_admission.py:431,
tests/test_telemetry.py:436,513 and tests/test_metrics.py:97, and the
route tables themselves (every path of JAX's routers on the port's).
Rows, counts and keys are exact (the table has integer metrics only).
gRPC crosses packages: a JAX stub queries a port server and a port stub a
JAX server, the request bytes equal for the same compiled query.

Every HTTP call and gRPC stub has a timeout; every front stops in a
``finally`` or a fixture's teardown.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu import client as jclient  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.spi import data as jdata  # noqa: E402
from pinot_tpu.spi import table as jtable  # noqa: E402
from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster  # noqa: E402
from pinot_tpu.transport import grpc_transport as jgrpc  # noqa: E402
from pinot_tpu.transport import rest as jrest  # noqa: E402
from pinot_tpu_torch import client as tclient  # noqa: E402
from pinot_tpu_torch.common.telemetry import TELEMETRY  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.spi import data as tdata  # noqa: E402
from pinot_tpu_torch.spi import table as ttable  # noqa: E402
from pinot_tpu_torch.tools.cluster import EmbeddedCluster  # noqa: E402
from pinot_tpu_torch.transport import grpc_transport as tgrpc  # noqa: E402
from pinot_tpu_torch.transport import rest as trest  # noqa: E402

N = 3000
TABLE = "tx_sales_OFFLINE"
TIMEOUT = 20


def _schema(mod):
    return mod.Schema("tx_sales", [
        mod.FieldSpec("region", mod.DataType.STRING),
        mod.FieldSpec("qty", mod.DataType.LONG, mod.FieldType.METRIC)])


def _frame(seed):
    rng = np.random.default_rng(seed)
    return {"region": np.array(["east", "west", "north"])[
                rng.integers(0, 3, N)],
            "qty": rng.integers(1, 100, N).astype(np.int64)}


def _http(method, url, body=None, raw=False):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        text = resp.read().decode()
        return (resp, text) if raw else json.loads(text)


def _status(method, url, body=None):
    try:
        _http(method, url, body)
        return 200
    except urllib.error.HTTPError as e:
        return e.code


# timings, and what the packages record in their own ways: residency
# counters (each package's layout) and path decisions (tests/
# test_torch_trace.py holds those)
_TIMING = {"timeUsedMs", "phaseTimesMs", "traceInfo", "staging",
           "decisions"}


def _answer(resp):
    """A broker response without its timings and the keys recorded in
    each package's own way."""
    return {k: v for k, v in resp.items() if k not in _TIMING}


class Side:
    """One package's cluster with its controller and broker front doors."""

    def __init__(self, cluster, rest, tables, schema_mod):
        self.cluster, self.rest = cluster, rest
        self.ctrl_api = rest.ControllerApi(cluster.controller, port=0)
        self.brk_api = rest.BrokerApi(cluster.broker, port=0)
        self.ctrl_api.start()
        self.brk_api.start()
        self.ctrl = f"http://localhost:{self.ctrl_api.port}"
        self.brk = f"http://localhost:{self.brk_api.port}"
        self.tables, self.schema_mod = tables, schema_mod

    def load(self, segments=2):
        schema = _schema(self.schema_mod)
        self.cluster.create_table(self.tables.TableConfig("tx_sales"),
                                  schema)
        for i in range(segments):
            self.cluster.ingest_rows(TABLE, schema, _frame(i),
                                     segment_name=f"tx_{i}")
        assert self.cluster.wait_for_ev_converged(TABLE)
        return self

    def stop(self):
        for api in (self.ctrl_api, self.brk_api):
            api.stop()
        self.cluster.shutdown()


def _pair(tmp_path, load=True):
    j = Side(JCluster(num_servers=2, data_dir=str(tmp_path / "j")),
             jrest, jtable, jdata)
    t = Side(EmbeddedCluster(num_servers=2, device="cpu",
                             data_dir=str(tmp_path / "t")),
             trest, ttable, tdata)
    if load:
        j.load()
        t.load()
    return j, t


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    j, t = _pair(tmp_path_factory.mktemp("pair"))
    yield j, t
    j.stop()
    t.stop()
    TELEMETRY.reset()


@pytest.fixture()
def fresh(tmp_path):
    j, t = _pair(tmp_path, load=False)
    yield j, t
    j.stop()
    t.stop()
    TELEMETRY.reset()


def _expected_sum():
    exp = {}
    for i in range(2):
        f = _frame(i)
        for r, q in zip(f["region"], f["qty"]):
            exp[r] = exp.get(r, 0) + int(q)
    return exp


# -- the route tables ----------------------------------------------------------

def test_routes_are_jaxs(pair):
    """Every method and path of JAX's routers, in order and with the same
    table scoping, on the port's."""

    def table(api):
        return [(m, p.pattern, scope) for m, p, _fn, scope in api._routes]

    j, t = pair
    assert table(t.ctrl_api) == table(j.ctrl_api)
    assert table(t.brk_api) == table(j.brk_api)
    apis = [side.rest.ServerAdminApi(side.cluster.servers["server_0"],
                                     port=0) for side in pair]
    try:
        assert table(apis[1]) == table(apis[0])
    finally:
        for api in apis:
            api._httpd.server_close()


# -- REST: the controller ----------------------------------------------------

def test_controller_admin_roundtrip(fresh):
    for side in fresh:
        assert _http("GET", f"{side.ctrl}/health") == {"status": "OK"}
    bodies = []
    for side in fresh:
        out = [_http("POST", f"{side.ctrl}/schemas",
                     _schema(jdata).to_dict()),
               _http("GET", f"{side.ctrl}/schemas"),
               _http("GET", f"{side.ctrl}/schemas/tx_sales"),
               _http("POST", f"{side.ctrl}/tables",
                     jtable.TableConfig("tx_sales").to_dict()),
               _http("GET", f"{side.ctrl}/tables"),
               _http("GET", f"{side.ctrl}/zk/get/tables/{TABLE}"),
               _status("GET", f"{side.ctrl}/schemas/nope"),
               _status("PUT", f"{side.ctrl}/tables/other",
                       jtable.TableConfig("tx_sales").to_dict())]
        bodies.append(out)
    assert bodies[0] == bodies[1]
    assert bodies[1][5]["value"]["tableName"] == TABLE
    assert bodies[1][6] == 404 and bodies[1][7] == 400


def test_segment_upload_and_state(fresh, tmp_path):
    from pinot_tpu.segment import SegmentBuilder as JBuilder
    from pinot_tpu_torch.segment import SegmentBuilder as TBuilder

    got = []
    for side, builder, dmod in ((fresh[0], JBuilder, jdata),
                                (fresh[1], TBuilder, tdata)):
        _http("POST", f"{side.ctrl}/schemas", _schema(dmod).to_dict())
        _http("POST", f"{side.ctrl}/tables",
              jtable.TableConfig("tx_sales").to_dict())
        out = str(tmp_path / f"built_{dmod.__name__}")
        builder(_schema(dmod), "tx_up_0").build(_frame(9), out)
        up = _http("POST", f"{side.ctrl}/segments",
                   {"tableName": TABLE, "segmentDir": f"{out}/tx_up_0"})
        assert side.cluster.wait_for_ev_converged(TABLE)
        got.append([up, _http("GET", f"{side.ctrl}/segments/{TABLE}"),
                    _http("GET", f"{side.ctrl}/tables/{TABLE}/idealstate"),
                    _http("GET",
                          f"{side.ctrl}/tables/{TABLE}/externalview"),
                    _http("POST", f"{side.brk}/query/sql",
                          {"sql": "SELECT count(*) FROM tx_sales"})
                    ["resultTable"]])
    assert got[0] == got[1]
    assert got[1][4]["rows"] == [[N]]


def test_reload_rebalance_instances_tenants_tasks(pair):
    outs = []
    for side in pair:
        c = side.ctrl
        outs.append([
            _http("POST", f"{c}/segments/{TABLE}/reload"),
            _http("POST", f"{c}/tables/{TABLE}/rebalance", {"dryRun": True}),
            sorted(i["instanceId"] for i in
                   _http("GET", f"{c}/instances")["instances"]
                   if i["type"] == "SERVER"),
            _http("GET", f"{c}/tenants"),
            [i for i in _http("GET", f"{c}/tenants/DefaultTenant")
             ["instances"] if not i.startswith("Broker_")],
            # every task type, SegmentGenerationAndPush among them
            _http("GET", f"{c}/tasks/tasktypes"),
            _http("GET", f"{c}/tasks/MergeRollupTask/state"),
            _http("GET", f"{c}/zk/ls/tables"),
            _status("GET", f"{c}/zk/get/nope"),
            _status("PUT", f"{c}/instances/server_0/updateTags", {}),
            _http("PUT", f"{c}/instances/server_0/updateTags",
                  {"tags": ["DefaultTenant", "hot"]}),
            _status("PUT", f"{c}/instances/nope/updateTags",
                    {"tags": ["x"]})])
    assert outs[0] == outs[1]


def test_recommender_and_ui(pair):
    bodies = []
    for side in pair:
        out = _http("POST", f"{side.ctrl}/tables/tx_sales/recommender",
                    {"queries": ["SELECT count(*) FROM tx_sales "
                                 "WHERE region = 'east'"] * 5
                     + ["SELECT region, sum(qty) FROM tx_sales "
                        "GROUP BY region"] * 3, "qps": 200})
        resp, html = _http("GET", f"{side.ctrl}/ui", raw=True)
        assert resp.headers["Content-Type"].startswith("text/html")
        assert TABLE in html
        bodies.append(out)
    assert bodies[0] == bodies[1]
    assert bodies[1]["recommendations"]["sortedColumn"] == ["region"]


def test_lineage_endpoints(fresh, tmp_path):
    """Start / end replace over REST hide the input from the broker's
    routing in both packages. An output that is never served: JAX flips
    the entry at once; the port waits for it and reverts at its timeout
    (504), so the input keeps answering."""
    j, t = fresh
    j.load()
    t.load()
    t.cluster.controller.replace_timeout_s = 0.3
    states = []
    for side in (j, t):
        out = _http("POST",
                    f"{side.ctrl}/segments/{TABLE}/startReplaceSegments",
                    {"segmentsFrom": ["tx_0"], "segmentsTo": ["merged_0"]})
        eid = out["segmentLineageEntryId"]
        states.append(_status(
            "POST", f"{side.ctrl}/segments/{TABLE}/endReplaceSegments/{eid}"))
        states.append(_status(
            "POST", f"{side.ctrl}/segments/{TABLE}/endReplaceSegments/nope"))
        routed = _http("GET", f"{side.brk}/debug/routing/{TABLE}")
        states.append(sorted(sum(routed["routing"].values(), [])))
    assert states == [200, 404, ["tx_1"], 504, 404, ["tx_0", "tx_1"]]
    assert [e["state"] for e in t.cluster.store.get(
        f"lineage/{TABLE}")] == ["REVERTED"]
    # a served output: the swap completes, the input leaves the routes
    from pinot_tpu_torch.segment import SegmentBuilder

    out = str(tmp_path / "merged")
    SegmentBuilder(_schema(tdata), "merged_1").build(_frame(0), out)
    eid = _http("POST", f"{t.ctrl}/segments/{TABLE}/startReplaceSegments",
                {"segmentsFrom": ["tx_0"],
                 "segmentsTo": ["merged_1"]})["segmentLineageEntryId"]
    _http("POST", f"{t.ctrl}/segments",
          {"tableName": TABLE, "segmentDir": f"{out}/merged_1"})
    _http("POST", f"{t.ctrl}/segments/{TABLE}/endReplaceSegments/{eid}")
    routed = _http("GET", f"{t.brk}/debug/routing/{TABLE}")
    assert sorted(sum(routed["routing"].values(), [])) == [
        "merged_1", "tx_1"]
    assert t.cluster.query_rows("SELECT count(*) FROM tx_sales") == [
        [2 * N]]


# -- REST: the broker --------------------------------------------------------

def test_broker_query_over_http(pair):
    answers = []
    for side in pair:
        answers.append([_answer(_http("POST", f"{side.brk}/query/sql",
                                      {"sql": sql}))
                        for sql in ("SELECT count(*), sum(qty) FROM tx_sales",
                                    "SELECT region, sum(qty) FROM tx_sales "
                                    "GROUP BY region ORDER BY region",
                                    "SELECT count(*) FROM no_such_table",
                                    "SELECT nope FROM tx_sales",
                                    "SELEC broken")])
    assert answers[0] == answers[1]
    rows = answers[1][1]["resultTable"]["rows"]
    assert {r[0]: r[1] for r in rows} == _expected_sum()
    assert answers[1][2]["exceptions"] and answers[1][4]["exceptions"]


def test_broker_access_control(tmp_path):
    """Basic auth on both packages' brokers: 401 without credentials, 403
    for a principal scoped to another table, 200 in scope."""
    import base64

    from pinot_tpu.spi import auth as jauth
    from pinot_tpu_torch.spi import auth as tauth

    codes = []
    for mod_auth, cluster, rest, tabmod, dmod in (
            (jauth, JCluster(num_servers=1, data_dir=str(tmp_path / "j")),
             jrest, jtable, jdata),
            (tauth, EmbeddedCluster(num_servers=1, device="cpu",
                                    data_dir=str(tmp_path / "t")),
             trest, ttable, tdata)):
        ac = mod_auth.access_control_from_config({
            "type": "basic", "principals": [
                {"username": "u", "password": "p", "tables": ["other"]},
                {"username": "a", "password": "p"}]})
        api = rest.BrokerApi(cluster.broker, port=0, access_control=ac)
        api.start()
        try:
            cluster.create_table(tabmod.TableConfig("tx_sales"),
                                 _schema(dmod))
            url = f"http://localhost:{api.port}/query/sql"
            for user in (None, "u", "a"):
                req = urllib.request.Request(
                    url, data=json.dumps(
                        {"sql": "SELECT count(*) FROM tx_sales"}).encode(),
                    headers={"Content-Type": "application/json"})
                if user:
                    req.add_header("Authorization", "Basic " + base64.
                                   b64encode(f"{user}:p".encode()).decode())
                try:
                    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                        codes.append(r.status)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
        finally:
            api.stop()
            cluster.shutdown()
    assert codes == [401, 403, 200] * 2


def test_broker_debug_routes_serve_json(pair):
    """Every GET /debug/* route of the broker answers JSON in both
    packages with the same keys (tests/test_telemetry.py:513)."""
    for side in pair:
        _http("POST", f"{side.brk}/query/sql",
              {"sql": "SELECT count(*) FROM tx_sales"})
    keys = []
    for side in pair:
        got = {}
        for path in ("/debug/scheduler", "/debug/telemetry", "/debug/slo",
                     "/debug/freshness", "/debug/flightrecorder",
                     f"/debug/routing/{TABLE}"):
            body = _http("GET", side.brk + path)
            assert isinstance(body, dict), path
            got[path] = sorted(body)
        keys.append(got)
    assert keys[0] == keys[1]


def test_metrics_over_rest(pair):
    for side in pair:
        server = side.cluster.servers["server_0"]
        sapi = side.rest.ServerAdminApi(server, port=0)
        sapi.start()
        try:
            for port, needle in ((side.ctrl_api.port,
                                  "pinot_controller_tables"),
                                 (side.brk_api.port,
                                  "pinot_broker_queries_total"),
                                 (sapi.port, "pinot_server_queries_total")):
                resp, body = _http(
                    "GET", f"http://localhost:{port}/metrics", raw=True)
                assert resp.headers["Content-Type"].startswith("text/plain")
                assert needle in body, body[:300]
        finally:
            sapi.stop()


# -- REST: the servers -------------------------------------------------------

def test_server_admin_routes(pair):
    outs = []
    for side in pair:
        side.cluster.query_rows("SELECT region, sum(qty) FROM tx_sales "
                                "GROUP BY region")
        server = side.cluster.servers["server_0"]
        api = side.rest.ServerAdminApi(server, port=0)
        api.start()
        try:
            base = f"http://localhost:{api.port}"
            size = _http("GET", f"{base}/tables/{TABLE}/size")
            mem = _http("GET", f"{base}/debug/memory")
            outs.append([
                _http("GET", f"{base}/health"),
                _http("GET", f"{base}/tables"),
                _http("GET", f"{base}/tables/{TABLE}/segments"),
                sorted(size), sorted(size["segments"]),
                [size["segments"][s] > 0 for s in sorted(size["segments"])],
                {"stagedSegments", "nativeMmapBuffers", "stagedBytes",
                 "budgetBytes", "hostTier"} <= set(mem),
                _http("POST", f"{base}/debug/memory/evict/not_staged"),
                _http("POST", f"{base}/debug/memory/demote/not_staged")
                ["demoted"]])
            if side is pair[1]:
                # the route's bytes are the residency manager's
                assert mem["stagedBytes"] == \
                    server.executor.residency.staged_bytes()
                staged = list(mem["stagedSegments"])
                assert staged
                out = _http("POST",
                            f"{base}/debug/memory/demote/{staged[0]}")
                if out["demoted"]:
                    mem2 = _http("GET", f"{base}/debug/memory")
                    assert staged[0] in mem2["hostTier"]["entries"]
        finally:
            api.stop()
    assert outs[0][:6] == outs[1][:6]
    assert outs[1][6] and outs[0][8] is False and outs[1][8] is False
    assert outs[1][7]["evicted"] == "not_staged"


def test_server_debug_routes_serve_json(pair):
    """Every GET /debug/* route of a server answers JSON in both packages
    (tests/test_telemetry.py:513); the scheduler route's body is the
    server's own view (tests/test_admission.py:431)."""
    for side in pair:
        side.cluster.query_rows("SELECT count(*) FROM tx_sales")
    for side in pair:
        server = side.cluster.servers["server_0"]
        api = side.rest.ServerAdminApi(server, port=0)
        api.start()
        try:
            base = f"http://localhost:{api.port}"
            paths = [p.pattern for m, p, _f, _s in api._routes
                     if m == "GET" and p.pattern.startswith("/debug/")]
            assert len(paths) == 9, paths
            for path in paths:
                assert isinstance(_http("GET", base + path), dict), path
            sched = _http("GET", f"{base}/debug/scheduler")
            assert sched["scheduler"]["policy"] == "SewfScheduler"
            assert {"leaders", "hits", "inflight"} == \
                set(sched["kernelFlight"])
        finally:
            api.stop()


def test_launch_counts_over_rest(tmp_path):
    """A query's launch counts through the REST front door equal the same
    query's in process, and the servers' /debug/launches sum them (the
    fused scan's plain version counts no launch on the CPU: its wrapper
    is counted here as the launch-count tests do)."""
    from pinot_tpu_torch.engine import fused_scan

    t = Side(EmbeddedCluster(num_servers=2, device="cpu",
                             data_dir=str(tmp_path / "t")),
             trest, ttable, tdata).load(segments=4)
    sapis = [trest.ServerAdminApi(s, port=0)
             for s in t.cluster.servers.values()]
    real = fused_scan.fused_scan_plain

    def counted(*a, **k):
        fused_scan.SCAN_COUNTER.add()
        return real(*a, **k)

    fused_scan.fused_scan_plain = counted
    try:
        for api in sapis:
            api.start()
        sql = "SELECT region, sum(qty) FROM tx_sales GROUP BY region"
        inproc = t.cluster.query(sql).stats.scan_launches
        over = _http("POST", f"{t.brk}/query/sql", {"sql": sql})
        assert inproc == over["scanLaunches"] == 4
        total = sum(_http("GET", f"http://localhost:{a.port}/debug/launches")
                    ["launches"].get("scanLaunches", 0) for a in sapis)
        assert total == 2 * inproc
    finally:
        fused_scan.fused_scan_plain = real
        for api in sapis:
            api.stop()
        t.stop()
        TELEMETRY.reset()


def test_cli_post_query(pair, capsys):
    from pinot_tpu.tools.admin import main as jmain
    from pinot_tpu_torch.tools.admin import main as tmain

    outs = []
    for side, main in zip(pair, (jmain, tmain)):
        port = side.brk_api.port
        assert main(["PostQuery", "-query", "SELECT count(*) FROM tx_sales",
                     "-brokerPort", str(port), "-timeout", "20"]) == 0
        outs.append(_answer(json.loads(capsys.readouterr().out.strip())))
    assert outs[0] == outs[1] and outs[1]["resultTable"]["rows"] == [[2 * N]]


def test_cli_parser_has_no_ingestion_job():
    from pinot_tpu_torch.tools.admin import build_parser

    sub = next(a for a in build_parser()._actions
               if a.dest == "command")
    # the batch job is ported: LaunchDataIngestionJob is JAX's command
    assert set(sub.choices) == {"LaunchDataIngestionJob", "PostQuery",
                                "Quickstart", "StartCluster", "StartServer"}


# -- the client --------------------------------------------------------------

def test_client_connect_and_query(pair):
    outs = []
    for side, cl in zip(pair, (jclient, tclient)):
        conn = cl.connect([side.brk.split("//")[1]], timeout_s=TIMEOUT)
        res = conn.execute("SELECT count(*), sum(qty) FROM tx_sales")
        rs = res.get_result_set()
        grp = conn.execute("SELECT region, count(*) FROM tx_sales "
                           "GROUP BY region ORDER BY region").result_set
        with pytest.raises(cl.PinotClientError):
            conn.execute("SELECT count(*) FROM nope")
        lax = cl.connect([side.brk], fail_on_exceptions=False,
                         timeout_s=TIMEOUT)
        outs.append([rs.column_names, rs.get_long(0, 0),
                     rs.get_long(0, 1), res.stats["numServersQueried"],
                     [row[0] for row in grp], grp.get_string(1, 0),
                     lax.execute("SELECT count(*) FROM nope").exceptions])
    assert outs[0] == outs[1] and outs[1][1] == 2 * N


def test_client_unreachable_failover_and_discovery(pair):
    j, t = pair
    with pytest.raises(tclient.PinotClientError, match="unreachable"):
        tclient.connect(["localhost:1"], timeout_s=2.0, retries=2,
                        backoff_s=0.01).execute("SELECT 1 FROM t")
    conn = tclient.connect(["localhost:1", t.brk], retries=4,
                           backoff_s=0.01, timeout_s=TIMEOUT)
    assert conn.execute("SELECT count(*) FROM tx_sales") \
        .get_result_set().get_long(0, 0) == 2 * N
    # the broker front door registered itself: the controller lists it
    conn = tclient.connect_with_controller(t.ctrl, timeout_s=TIMEOUT)
    assert conn.execute("SELECT count(*) FROM tx_sales") \
        .get_result_set().get_long(0, 0) == 2 * N
    # a JAX client against the port's front doors, and the other way
    assert jclient.connect_with_controller(t.ctrl).execute(
        "SELECT count(*) FROM tx_sales").get_result_set().get_long(0, 0) \
        == 2 * N
    assert tclient.connect([j.brk]).execute(
        "SELECT count(*) FROM tx_sales").get_result_set().get_long(0, 0) \
        == 2 * N


def test_client_trace_option(pair):
    _, t = pair
    conn = tclient.connect([t.brk], timeout_s=TIMEOUT)
    res = conn.execute("SELECT region, sum(qty) FROM tx_sales "
                       "GROUP BY region OPTION(trace=true)")
    entries = res.raw["traceInfo"]["entries"]
    assert entries and all("operator" in e and "ms" in e for e in entries)
    assert {e["instance"] for e in entries} <= {"server_0", "server_1"}
    assert res.raw["traceInfo"]["spans"][0]["name"] == "BrokerQuery"
    assert "traceInfo" not in conn.execute(
        "SELECT count(*) FROM tx_sales").raw


# -- gRPC ----------------------------------------------------------------------

@pytest.fixture()
def grpc_pair(tmp_path):
    """Both packages' clusters whose brokers reach their servers only
    through gRPC stubs."""
    j, t = _pair(tmp_path, load=False)
    fronts = []
    for side, mod in ((j, jgrpc), (t, tgrpc)):
        for iid, server in side.cluster.servers.items():
            g = mod.GrpcQueryServer(server, port=0)
            g.start()
            stub = mod.GrpcServerStub(f"localhost:{g.port}",
                                      timeout_s=TIMEOUT)
            side.cluster.broker.register_server(iid, stub)
            fronts.append((side, iid, g, stub))
    try:
        yield j, t, fronts
    finally:
        for _side, _iid, g, stub in fronts:
            stub.close()
            g.stop(grace=0.5)
        j.stop()
        t.stop()
        TELEMETRY.reset()


def test_grpc_scatter_gather_equals_jax(grpc_pair):
    j, t, fronts = grpc_pair
    j.load(3)
    t.load(3)
    sqls = ["SELECT count(*), sum(qty) FROM tx_sales",
            "SELECT region, sum(qty), min(qty), max(qty) FROM tx_sales "
            "GROUP BY region ORDER BY region",
            "SELECT region, qty FROM tx_sales WHERE qty > 97 "
            "ORDER BY region, qty LIMIT 7",
            "SELECT qty FROM tx_sales LIMIT 5"]
    over = [t.cluster.query_rows(sql) for sql in sqls]
    assert over[:3] == [j.cluster.query_rows(sql) for sql in sqls[:3]]
    assert len(over[3]) == 5
    assert over[0] == [[3 * N, sum(int(q) for i in range(3)
                                   for q in _frame(i)["qty"])]]
    # the same rows in process
    for _side, iid, _g, _stub in fronts:
        if _side is t:
            t.cluster.broker.register_server(iid, t.cluster.servers[iid])
    assert [t.cluster.query_rows(sql) for sql in sqls[:3]] == over[:3]
    resp = t.cluster.query("SELECT nope FROM tx_sales")
    assert resp.has_exceptions


def test_grpc_server_kill_partial_results(grpc_pair):
    _j, t, fronts = grpc_pair
    t.load(4)
    full = t.cluster.query("SELECT count(*) FROM tx_sales")
    assert not full.has_exceptions
    victim = next(g for side, iid, g, _s in fronts
                  if side is t and iid == "server_1")
    victim.stop(grace=0)
    resp = t.cluster.query("SELECT count(*) FROM tx_sales")
    assert resp.has_exceptions
    if resp.result_table is not None:
        assert resp.result_table.rows[0][0] < full.result_table.rows[0][0]


def test_grpc_across_packages(grpc_pair):
    """A JAX stub queries a port server and a port stub a JAX server: the
    request bytes are JAX's and each side decodes the other's DataTable to
    the same rows."""
    j, t, fronts = grpc_pair
    j.load(2)
    t.load(2)
    for sql in ("SELECT region, sum(qty) FROM tx_sales GROUP BY region",
                "SELECT count(*) FROM tx_sales WHERE region = 'east'"):
        jctx, tctx = j_compile(sql), t_compile(sql)
        assert tgrpc._encode_request(tctx, TABLE, ["tx_0"]) == \
            jgrpc._encode_request(jctx, TABLE, ["tx_0"])
    port_front = next(g for side, iid, g, _s in fronts
                      if side is t and iid == "server_0")
    jax_front = next(g for side, iid, g, _s in fronts
                     if side is j and iid == "server_0")
    segs = sorted(t.cluster.servers["server_0"].hosted_segments(TABLE))
    assert segs == sorted(j.cluster.servers["server_0"]
                          .hosted_segments(TABLE))
    sql = "SELECT region, sum(qty), count(*) FROM tx_sales GROUP BY region"
    jstub = jgrpc.GrpcServerStub(f"localhost:{port_front.port}",
                                 timeout_s=TIMEOUT)
    tstub = tgrpc.GrpcServerStub(f"localhost:{jax_front.port}",
                                 timeout_s=TIMEOUT)
    try:
        from_port = jstub.execute_query(j_compile(sql), TABLE, segs)
        from_jax = tstub.execute_query(t_compile(sql), TABLE, segs)
        assert not from_port.exceptions and not from_jax.exceptions
        assert sorted(map(tuple, from_port.group_by_groups())) == sorted(
            map(tuple, from_jax.group_by_groups()))
        streamed = list(tstub.execute_query_streaming(
            t_compile("SELECT region FROM tx_sales LIMIT 3"), TABLE, segs))
        assert streamed and not any(b.exceptions for b in streamed)
    finally:
        jstub.close()
        tstub.close()


def test_grpc_streaming_blocks(grpc_pair):
    _j, t, fronts = grpc_pair
    t.load(2)
    g = next(g for side, iid, g, _s in fronts if side is t)
    stub = tgrpc.GrpcServerStub(f"localhost:{g.port}", timeout_s=TIMEOUT)
    server = next(s for iid, s in t.cluster.servers.items())
    segs = sorted(server.hosted_segments(TABLE))
    try:
        ctx = t_compile("SELECT region, qty FROM tx_sales LIMIT 100000")
        blocks = list(stub.execute_query_streaming(ctx, TABLE, segs))
        assert len(blocks) == len(segs)
        assert sum(b.num_rows() for b in blocks) == N * len(segs)
        agg = list(stub.execute_query_streaming(
            t_compile("SELECT count(*) FROM tx_sales"), TABLE, segs))
        assert len(agg) == 1 and not agg[0].exceptions
    finally:
        stub.close()


def test_grpc_stub_connection_refused():
    stub = tgrpc.GrpcServerStub("localhost:1", timeout_s=2.0)
    try:
        dt = stub.execute_query(t_compile("SELECT count(*) FROM t"),
                                "t_OFFLINE", ["s0"])
        assert dt.exceptions and "failed" in dt.exceptions[0]
    finally:
        stub.close()


def test_decoded_context_keys_the_plan_cache():
    """The server gives a decoded context its canonical JSON as ``sql``:
    two requests of one query share a plan-cache key."""
    ctx = t_compile("SELECT region, sum(qty) FROM tx_sales GROUP BY region")
    raw = tgrpc._encode_request(ctx, TABLE, None)
    a, table, segs = tgrpc._decode_request(raw)
    b, _t, _s = tgrpc._decode_request(raw)
    assert a.sql == b.sql and a.sql.startswith("{")
    assert (table, segs) == (TABLE, None)
    assert json.loads(a.sql) == json.loads(raw)["context"]
