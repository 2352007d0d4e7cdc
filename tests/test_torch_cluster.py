"""The port's embedded cluster (``pinot_tpu_torch/tools/cluster.py``: the
controller, 3 servers with their schedulers, routing and the broker
request handler) against the JAX ``EmbeddedCluster`` (oracle:
tests/test_cluster.py ``TestOfflineCluster`` and
``test_in_subquery_semijoin``).

Both clusters run tests/test_cluster.py's sales table (3 servers,
replication 2, 4 uneven segments): equal IdealStates, equal rows (float
aggregates within rel 1e-5, the tolerance of tests/test_torch_executor.py:
both packages stage DOUBLE columns as f32 and sum in their own order),
equal error codes and server counts, equal broker
decisions; a lost server answered in full by the replicas; IN_SUBQUERY at
the oracle's size with JAX's decision keys; EXPLAIN rows; a few SSB
flights on JAX-built segments carried across. Also: two replicas that
share one segment object stage and evict their own copies, an exception
DataTable from one server is a partial result and never a clean one, and
chip_smoke's phase 16 at a small size. The port runs on the CPU; every
wait on a cluster is bounded.
"""

import numpy as np
import pytest

import chip_smoke
import tests.test_cluster as tc_oracle
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.query.explain import explain_rows as j_explain_rows
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi import table as jtable
from pinot_tpu.tools import ssb as j_ssb
from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.engine.pruner import prune_segments
from pinot_tpu_torch.engine.results import WIRE_COUNTERS
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable
from pinot_tpu_torch.tools import ssb as t_ssb
from pinot_tpu_torch.tools.cluster import EmbeddedCluster
from tests.test_torch_executor import carry

N = tc_oracle.N
TABLE = "sales_OFFLINE"
BOUNDS = [0, 700, 1500, 2100, N]
BROKER_KEYS = ("routing:", "hybrid:", "gather:")


def _port_schema():
    return tdata.Schema("sales", [
        tdata.FieldSpec("region", tdata.DataType.STRING),
        tdata.FieldSpec("kind", tdata.DataType.STRING),
        tdata.FieldSpec("qty", tdata.DataType.LONG, tdata.FieldType.METRIC),
        tdata.FieldSpec("price", tdata.DataType.DOUBLE,
                        tdata.FieldType.METRIC),
        tdata.FieldSpec("ts", tdata.DataType.LONG,
                        tdata.FieldType.DATE_TIME)])


def _sales(jdir, servers=3):
    """The sales table in a JAX and a port cluster."""
    df = tc_oracle.make_df()
    jc = JCluster(num_servers=servers, data_dir=jdir)
    jc.create_table(jtable.TableConfig(
        "sales", jtable.TableType.OFFLINE,
        validation_config=jtable.SegmentsValidationConfig(
            time_column_name="ts", replication=2)), tc_oracle.make_schema())
    pc = EmbeddedCluster(num_servers=servers, device="cpu")
    pc.create_table(ttable.TableConfig(
        "sales", ttable.TableType.OFFLINE,
        validation_config=ttable.SegmentsValidationConfig(
            time_column_name="ts", replication=2)), _port_schema())
    for i in range(4):
        part = df.iloc[BOUNDS[i]:BOUNDS[i + 1]]
        cols = {c: part[c].tolist() for c in df.columns}
        jc.ingest_rows(TABLE, tc_oracle.make_schema(), cols,
                       segment_name=f"sales_{i}")
        pc.ingest_rows(TABLE, _port_schema(), cols,
                       segment_name=f"sales_{i}")
    assert jc.wait_for_ev_converged(TABLE, timeout_s=60)
    assert pc.wait_for_ev_converged(TABLE, timeout_s=60)
    return jc, pc, df


@pytest.fixture(scope="module")
def sales(tmp_path_factory):
    jc, pc, df = _sales(str(tmp_path_factory.mktemp("jsales")))
    yield jc, pc, df
    jc.shutdown()
    pc.shutdown()


def _rows_equal(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert len(g) == len(w), what
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-5), (what, g, w)
            else:
                assert a == b and type(a) is type(b), (what, g, w)


def _same(jc, pc, sql):
    j, t = jc.query(sql), pc.query(sql)
    assert not t.exceptions and not j.exceptions, (t.exceptions,
                                                   j.exceptions)
    assert t.result_table.schema.column_names == \
        j.result_table.schema.column_names
    _rows_equal(t.result_table.rows, j.result_table.rows, sql)
    assert (t.num_servers_queried, t.num_servers_responded) == \
        (j.num_servers_queried, j.num_servers_responded), sql
    assert t.num_servers_responded == t.num_servers_queried
    assert {k: v for k, v in t.stats.decisions.items()
            if k.startswith(BROKER_KEYS)} == \
        {k: v for k, v in j.stats.decisions.items()
         if k.startswith(BROKER_KEYS)}, sql
    return j, t


def test_ideal_states_equal(sales):
    jc, pc, _ = sales
    assert pc.store.get_ideal_state(TABLE) == jc.store.get_ideal_state(TABLE)
    assert pc.store.get_external_view(TABLE) == \
        jc.store.get_external_view(TABLE)
    hosted = {sid: s.hosted_segments(TABLE) for sid, s in pc.servers.items()}
    assert hosted == {sid: s.hosted_segments(TABLE)
                      for sid, s in jc.servers.items()}
    assert sum(len(v) for v in hosted.values()) == 8
    assert pc.hosting_servers(TABLE) == jc.hosting_servers(TABLE)


SALES_SQL = [
    "SELECT count(*), sum(qty), avg(price) FROM sales WHERE region = 'east'",
    "SELECT region, kind, sum(qty) FROM sales "
    "GROUP BY region, kind ORDER BY region, kind LIMIT 50",
    "SELECT region, qty FROM sales ORDER BY qty DESC, region LIMIT 10",
    "SELECT region FROM sales ORDER BY ts LIMIT 5",          # hidden column
    "SELECT DISTINCT region, kind FROM sales ORDER BY region, kind LIMIT 50",
    "SELECT count(*) FROM sales",
    "SELECT kind, max(price), min(qty) FROM sales WHERE qty > 20 "
    "GROUP BY kind ORDER BY kind",
]


@pytest.mark.parametrize("sql", SALES_SQL)
def test_sales_rows_equal(sales, sql):
    jc, pc, _ = sales
    _same(jc, pc, sql)


def test_time_pruning(sales):
    jc, pc, df = sales
    ts_cut = int(df.ts.quantile(0.2))
    j, t = _same(jc, pc, f"SELECT count(*) FROM sales WHERE ts <= {ts_cut}")
    assert t.result_table.rows[0][0] == (df.ts <= ts_cut).sum()
    # a bound below every segment's range prunes them all: no server is
    # asked, and the answer is empty in both
    sql = "SELECT count(*) FROM sales WHERE ts < 5"
    j, t = jc.query(sql), pc.query(sql)
    assert t.result_table is None and j.result_table is None
    assert not t.exceptions and not j.exceptions
    assert t.num_servers_queried == j.num_servers_queried == 0
    assert t.stats.decisions == j.stats.decisions == {
        "hybrid:time_split->direct:hybrid_single_table": 1,
        "routing:all_servers->pruned:time_prune": 1}


def test_oracle_values(sales):
    _, pc, df = sales
    rows = pc.query_rows("SELECT count(*), sum(qty), avg(price) FROM sales "
                         "WHERE region = 'east'")
    want = df[df.region == "east"]
    assert rows[0][0] == len(want)
    assert rows[0][1] == pytest.approx(float(want.qty.sum()))
    assert rows[0][2] == pytest.approx(float(want.price.mean()))


@pytest.mark.parametrize("sql", ["SELECT count(*) FROM nope",
                                 "SELECT count(*) FROM",
                                 "EXPLAIN PLAN FOR SELECT x FROM nope"])
def test_error_codes_equal(sales, sql):
    jc, pc, _ = sales
    j, t = jc.query(sql), pc.query(sql)
    assert [e["errorCode"] for e in t.exceptions] == \
        [e["errorCode"] for e in j.exceptions]
    assert t.exceptions


@pytest.mark.parametrize("request_id", range(1, 7))
def test_transport_lost_equal_accounting(sales, request_id):
    """tests/test_cluster.py's server loss (one server's transport
    unregistered) at a fixed request id in both clusters: the same servers
    asked, and where routing picks the unconnected one the same partial
    answer (427, ``server_not_connected``), never a clean one."""
    jc, pc, _ = sales
    out = []
    for c in (jc, pc):
        victim = sorted(c.servers)[0]
        c.broker._servers.pop(victim)
        c.broker.routing._request_id = 100 + request_id
        try:
            out.append(c.query("SELECT count(*) FROM sales"))
        finally:
            c.broker.register_server(victim, c.servers[victim])
    j, t = out
    assert (t.num_servers_queried, t.num_servers_responded) == \
        (j.num_servers_queried, j.num_servers_responded)
    assert [e["errorCode"] for e in t.exceptions] == \
        [e["errorCode"] for e in j.exceptions]
    assert t.result_table.rows == j.result_table.rows
    if t.exceptions:
        assert t.to_dict()["partialResult"] is True
        assert t.stats.decisions[
            "gather:full_result->partial_result:server_not_connected"] == 1
        assert t.result_table.rows[0][0] < N
    else:
        assert t.result_table.rows == [[N]]


@pytest.mark.parametrize("victim", [0, 1, 2])
def test_server_lost_full_answer(tmp_path, victim):
    """A server stopped: routing avoids the dead instance, the replicas
    answer every query in full, in both clusters alike."""
    jc, pc, _ = _sales(str(tmp_path / "j"))
    try:
        stopped = sorted(pc.servers)[victim]
        for c in (jc, pc):
            c.stop_server(stopped)
        assert not pc.store.get_instance(stopped).alive
        for sql in SALES_SQL:
            j, t = _same(jc, pc, sql)
            assert t.num_servers_queried <= 2
            assert stopped not in pc.broker.routing.route(TABLE).routing
    finally:
        jc.shutdown()
        pc.shutdown()


def test_clusters_keep_their_own_segments():
    """Each cluster owns its deep store: two clusters in one process that
    push the same table and segment names answer from their own data, and
    shutdown drops the segments."""
    schema = tdata.Schema("kv", [
        tdata.FieldSpec("v", tdata.DataType.LONG, tdata.FieldType.METRIC)])
    clusters = [EmbeddedCluster(device="cpu") for _ in range(2)]
    try:
        for i, c in enumerate(clusters):
            c.create_table(ttable.TableConfig("kv"), schema)
            c.ingest_rows("kv_OFFLINE", schema,
                          {"v": np.full(10, i + 1, np.int64)}, "kv_0")
            assert c.wait_for_ev_converged("kv_OFFLINE", timeout_s=30)
        assert [c.query_rows("SELECT sum(v) FROM kv") for c in clusters] \
            == [[[10.0]], [[20.0]]]
    finally:
        for c in clusters:
            c.shutdown()
    assert [len(c.controller.deep_store) for c in clusters] == [0, 0]


# -- IN_SUBQUERY and EXPLAIN -------------------------------------------------------

def _semijoin(tmp_path):
    users = {"uid": list(range(100)),
             "vip": ["y" if i % 10 == 0 else "n" for i in range(100)]}
    rng = np.random.default_rng(7)
    events = {"uid": rng.integers(0, 100, 2000).tolist(),
              "amount": rng.integers(1, 50, 2000).tolist()}

    def schemas(data):
        return (data.Schema("users2", [
            data.FieldSpec("uid", data.DataType.LONG),
            data.FieldSpec("vip", data.DataType.STRING)]),
            data.Schema("events2", [
                data.FieldSpec("uid", data.DataType.LONG),
                data.FieldSpec("amount", data.DataType.LONG,
                               data.FieldType.METRIC)]))

    jc = JCluster(data_dir=str(tmp_path / "c"))
    ju, je = schemas(jdata)
    jc.create_table(jtable.TableConfig(table_name="users2"), ju)
    jc.create_table(jtable.TableConfig(table_name="events2"), je)
    JBuilder(ju, "u0").build(users, str(tmp_path))
    JBuilder(je, "e0").build(events, str(tmp_path))
    jc.upload_segment_dir("users2_OFFLINE", str(tmp_path / "u0"))
    jc.upload_segment_dir("events2_OFFLINE", str(tmp_path / "e0"))
    pc = EmbeddedCluster(device="cpu")
    tu, te = schemas(tdata)
    pc.create_table(ttable.TableConfig(table_name="users2"), tu)
    pc.create_table(ttable.TableConfig(table_name="events2"), te)
    pc.ingest_rows("users2_OFFLINE", tu, users, "u0")
    pc.ingest_rows("events2_OFFLINE", te, events, "e0")
    for c in (jc, pc):
        for t in ("users2_OFFLINE", "events2_OFFLINE"):
            assert c.wait_for_ev_converged(t, timeout_s=30)
    return jc, pc, users, events


# chip_smoke's phase 16e holds the port to these decisions on the card,
# where it cannot run JAX: the JAX cluster's are checked equal here
SEMIJOIN_SQL = chip_smoke.SEMIJOIN_SQL
SEMIJOIN_DECISIONS = chip_smoke.SEMIJOIN_DECISIONS


def test_in_subquery_semijoin(tmp_path):
    jc, pc, users, events = _semijoin(tmp_path)
    try:
        j, t = jc.query(SEMIJOIN_SQL), pc.query(SEMIJOIN_SQL)
        assert not t.exceptions, t.exceptions
        vips = {i for i in range(100) if i % 10 == 0}
        expect = sum(a for uid, a in zip(events["uid"], events["amount"])
                     if uid in vips)
        assert t.result_table.rows == j.result_table.rows == [[expect]]
        assert t.stats.decisions == j.stats.decisions == SEMIJOIN_DECISIONS
        assert t.num_servers_responded == t.num_servers_queried == 1
        bad = pc.query("SELECT sum(amount) FROM events2 WHERE "
                       "inSubquery(uid, 'SELECT uid FROM users2') = 1")
        jbad = jc.query("SELECT sum(amount) FROM events2 WHERE "
                        "inSubquery(uid, 'SELECT uid FROM users2') = 1")
        assert [e["errorCode"] for e in bad.exceptions] == \
            [e["errorCode"] for e in jbad.exceptions] == [200]
    finally:
        jc.shutdown()
        pc.shutdown()


EXPLAIN_SQL = SALES_SQL + [
    "SELECT region FROM sales WHERE NOT (qty > 3 OR kind = 'a') LIMIT 4",
    "SELECT count(*) FROM sales WHERE region IN ('east', 'west') "
    "AND ts BETWEEN 1 AND 9 HAVING count(*) > 2",
]


@pytest.mark.parametrize("sql", EXPLAIN_SQL)
def test_explain_rows_equal(sales, sql):
    jc, pc, _ = sales
    t = pc.query("EXPLAIN PLAN FOR " + sql)
    assert not t.exceptions
    assert t.result_table.schema.column_names == [
        "Operator", "Operator_Id", "Parent_Id"]
    assert t.result_table.rows == j_explain_rows(j_compile(sql))
    assert t.result_table.rows == jc.query(
        "EXPLAIN PLAN FOR " + sql).result_table.rows
    assert t.num_servers_queried == 0


# -- SSB flights through both clusters --------------------------------------------

SSB_FLIGHTS = ["Q1.1", "Q1.2", "Q2.1", "Q3.2", "Q3.4", "Q4.3"]


@pytest.fixture(scope="module")
def ssb_clusters(tmp_path_factory):
    out = tmp_path_factory.mktemp("ssb_cluster")
    jsegs = j_ssb.build_segments(0, str(out / "segs"), num_segments=4,
                                 rows=8000, star_tree=False, workers=1)
    jc = JCluster(num_servers=2, data_dir=str(out / "j"))
    pc = EmbeddedCluster(num_servers=2, device="cpu")
    jc.create_table(jtable.TableConfig(
        "ssb_lineorder", validation_config=jtable.SegmentsValidationConfig(
            time_column_name="d_yearmonthnum")), j_ssb.ssb_schema())
    tsegs = carry(jsegs, "ssb_lineorder")
    pc.create_table(ttable.TableConfig(
        "ssb_lineorder", validation_config=ttable.SegmentsValidationConfig(
            time_column_name="d_yearmonthnum")), tsegs[0].metadata.schema)
    for j, t in zip(jsegs, tsegs):
        jc.upload_segment_dir("ssb_lineorder_OFFLINE", j.segment_dir)
        pc.upload_segment("ssb_lineorder_OFFLINE", t)
    for c in (jc, pc):
        assert c.wait_for_ev_converged("ssb_lineorder_OFFLINE", timeout_s=60)
    yield jc, pc
    jc.shutdown()
    pc.shutdown()


@pytest.mark.parametrize("qid", SSB_FLIGHTS)
def test_ssb_flights_equal(ssb_clusters, qid):
    """The rows equal; the port prunes by the table's time column (the
    JAX controller records no time range for SSB, whose schema calls
    d_yearmonthnum a dimension), so its server counts may be fewer."""
    jc, pc = ssb_clusters
    sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
    j, t = jc.query(sql), pc.query(sql)
    assert not t.exceptions and not j.exceptions
    _rows_equal(t.result_table.rows, j.result_table.rows, qid)
    assert t.num_servers_responded == t.num_servers_queried >= 1
    assert t.num_servers_queried <= j.num_servers_queried


# -- replicas sharing one segment object --------------------------------------------

def test_replicas_stage_and_evict_their_own_copies(sales):
    """``memory://`` hands both replicas one segment object; each server
    stages its own copy on its device, and one server's eviction leaves
    the other's columns staged."""
    _, pc, _ = sales
    ideal = pc.store.get_ideal_state(TABLE)
    seg, owners = next((s, sorted(m)) for s, m in sorted(ideal.items()))
    a, b = (pc.servers[o] for o in owners)
    objs = [s.data_manager.get(TABLE).acquire_segments([seg]) for s in (a, b)]
    try:
        assert objs[0][0].segment is objs[1][0].segment
    finally:
        a.data_manager.get(TABLE).release_segments(objs[0])
        b.data_manager.get(TABLE).release_segments(objs[1])
    for s in (a, b):
        s.executor.residency.drain_prefetch()
    ra, rb = a.executor.residency, b.executor.residency
    before = rb.resident_nbytes(seg)
    assert ra.resident_nbytes(seg) > 0 and before > 0
    assert ra.residents()[0][1] is not rb.residents()[0][1]
    out = a.evict_staged(seg)
    assert ra.resident_nbytes(seg) == 0 and out["evicted"] == seg
    assert rb.resident_nbytes(seg) == before
    staged = [c for c in rb.residents() if c[0] == seg][0][1]
    assert staged.nbytes() == before
    resp = pc.query("SELECT count(*), sum(qty) FROM sales")
    assert not resp.exceptions and resp.result_table.rows[0][0] == N


# -- an in-band server error is a partial result ------------------------------------

def test_exception_datatable_is_partial_never_clean(sales, monkeypatch):
    """A server whose execution raises answers with an exception
    DataTable; the broker reports a partial result (427, responded <
    queried, ``server_error``), never a clean one."""
    _, pc, _ = sales
    sql = "SELECT region, sum(qty) FROM sales GROUP BY region ORDER BY region"
    full = pc.query(sql)
    rm = pc.broker.routing
    # the servers the next query routes to (request ids count up by one)
    nxt = rm.route(TABLE, request_id=rm._request_id + 1).routing
    victim = pc.servers[sorted(nxt)[0]]

    def boom(ctx, segments):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(victim.executor, "execute_instance", boom)
    # new SQL text: the front door's single flight cannot hand back the
    # answer from before the failure
    resp = pc.query(sql + " LIMIT 11")
    assert any("kernel failed to launch" in e["message"]
               for e in resp.exceptions)
    assert all(e["errorCode"] == 427 for e in resp.exceptions)
    assert resp.num_servers_queried == len(nxt)
    assert resp.num_servers_responded == len(nxt) - 1
    assert resp.to_dict()["partialResult"] is True
    assert resp.stats.decisions[
        "gather:full_result->partial_result:server_error"] == 1
    assert resp.result_table.rows != full.result_table.rows


# -- chip_smoke's phase 16 at a small size ----------------------------------------

def test_chip_smoke_phase_16_small():
    """Phase 16 on the CPU: SSB at 48 k rows in 8 segments over 4
    servers at replication 2, every check of the phase held (the plain
    version counts no launch)."""
    segs, frames = t_ssb.build_segments(0, num_segments=8, seed=3,
                                        rows=48_000)
    ctxs = {q: t_compile(t + " LIMIT 100000")
            for q, t in t_ssb.QUERIES.items()}
    ex = ServerQueryExecutor(device="cpu")
    variants = dict(t_ssb.COALESCE_QUERIES)
    main = {"segs": segs, "ctxs": ctxs,
            "wants": {q: t_ssb.merge_answers(
                [t_ssb.numpy_answer(f, q) for f in frames]) for q in ctxs},
            "results": {q: ex.execute(c, segs)[0] for q, c in ctxs.items()},
            "kept": {q: len(prune_segments(c, segs))
                     for q, c in ctxs.items()},
            "per_flight": {q: {"p50_ms": 0.0} for q in ctxs},
            "variant_texts": variants,
            "variant_wants": {v: t_ssb.merge_answers(
                [t_ssb.numpy_answer(f, v) for f in frames])
                for v in variants}}
    run = chip_smoke.phase_front_door(main, reps=1, device="cpu", rounds=1)
    assert run["flights"]["Q1.2"]["servers_queried"] == 1
    assert run["flights"]["Q3.4"]["servers_queried"] == 1
    assert all(v > 0 for v in run["staged_bytes"].values())
    assert run["concurrency"]["single_flight"]["coalesced"] >= 1
    assert set(run["concurrency"]) == {
        "runners8_clients1", "runners8_clients8", "runners1_clients1",
        "runners1_clients8", "single_flight"}
    assert run["quota"]["rejected_429"] > 0
    assert run["explain_rows"] == j_explain_rows(j_compile(
        j_ssb.QUERIES["Q2.1"] + " LIMIT 100000"))
    assert run["server_lost"]["stopped"] == "server_1"


# -- the server's admin calls and metrics --------------------------------------------

def test_server_admin_calls_and_metrics(sales):
    """``hosted_tables``, ``scheduler_debug``, ``memory_debug``,
    ``launch_debug`` and ``demote_staged`` on a serving server, and the
    meters the server, its residency, its admission gate and the broker
    marked while the fixture's queries ran."""
    _, pc, _ = sales
    pc.query("SELECT count(*), sum(qty) FROM sales WHERE qty > 3")
    sid = sorted(pc.servers)[0]
    srv = pc.servers[sid]
    assert srv.hosted_tables() == [TABLE]
    dbg = srv.scheduler_debug()
    assert dbg["scheduler"]["policy"] == "SewfScheduler"
    assert dbg["scheduler"]["workers"] == 8
    assert dbg["admission"]["enabled"] in (True, False)
    assert set(dbg["queryFlight"]) == {"leaders", "hits", "inflight"}
    # a per-segment executor has no launcher; beside it, the launches of
    # the queries the server answered, by their wire names
    dbg = srv.launch_debug()
    assert set(dbg) == {"enabled", "launches"} and not dbg["enabled"]
    assert set(dbg["launches"]) <= {w for _n, w in WIRE_COUNTERS}
    mem = srv.memory_debug()
    seg = srv.hosted_segments(TABLE)[0]
    assert mem["stagedBytes"] > 0 and seg in mem["stagedSegments"]
    out = srv.demote_staged(seg)
    assert out["demoted"] and out["hostBytes"] > 0
    resp = pc.query("SELECT count(*) FROM sales WHERE qty > 4")
    assert not resp.exceptions
    text = srv.metrics.export_prometheus()
    for name in ("pinot_server_queries_total",
                 "pinot_server_staging_staged_bytes",
                 "pinot_server_admission_admitted_total",
                 "pinot_server_QUERY_EXECUTION_ms_count"):
        assert name in text, name
    meters = srv.metrics.to_dict()["meters"]
    assert meters["queries_total"] >= 1
    assert meters["staging_demotions_total"] >= 1
    assert pc.broker.metrics.to_dict()["timers"]["REDUCE"]["count"] >= 1
