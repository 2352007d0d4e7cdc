"""The port's broker routing (``pinot_tpu_torch/broker/routing.py``) against
the JAX ``RoutingManager`` (oracle: tests/test_cluster_routing.py and
tests/test_routing_replica.py).

Both packages' state stores are filled with the same contents; every case
checks that the two route the same segments to the same servers with the
same prune counts and record the same routing decisions. Also: the three
selectors, the dead set refreshed by a liveness change, no store read on
a warmed route, and the timed-out gather of a small port cluster on the
CPU, held on an event rather than a sleep so it cannot flake. Every wait
on a cluster is bounded (the convergence wait, the events, the broker's
query timeout).
"""

import threading

import pytest

from pinot_tpu.broker import routing as jrouting
from pinot_tpu.controller import state as jstate
from pinot_tpu.engine.results import QueryStats as JStats
from pinot_tpu.query import compile_query as jcompile
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi import table as jtable
from pinot_tpu_torch.broker import routing as trouting
from pinot_tpu_torch.controller import state as tstate
from pinot_tpu_torch.engine.results import QueryStats as TStats
from pinot_tpu_torch.query import compile_query as tcompile
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable

TABLE = "part_OFFLINE"

JAX = (jrouting, jstate, JStats, jcompile, jdata, jtable)
PORT = (trouting, tstate, TStats, tcompile, tdata, ttable)


def _store(pkg, num_segments=4, num_partitions=4, fn_name="Modulo",
           pruner=True, time_ranges=None, replicas=1, selector="balanced"):
    """Segment i owns partition i (mod num_partitions) of column 'k', served
    by ``replicas`` servers starting at s<i>."""
    routing, state, _, _, data, table = pkg
    store = state.ClusterStateStore()
    store.add_schema(data.Schema("part", [data.FieldSpec("k",
                                                         data.DataType.INT)]))
    store.add_table_config(table.TableConfig(
        "part",
        validation_config=table.SegmentsValidationConfig(
            time_column_name="ts" if time_ranges else None),
        routing_config=table.RoutingConfig(
            instance_selector_type=selector,
            segment_pruner_types=["partition"] if pruner else [])))
    for i in range(num_segments):
        store.register_instance(state.InstanceInfo(f"s{i}", "SERVER"))
    if selector != "balanced":
        store.set_instance_partitions(TABLE, [["s0", "s1"], ["s2", "s3"]])
    for i in range(num_segments):
        md = state.SegmentZKMetadata(
            segment_name=f"seg_{i}", table_name=TABLE,
            partition_metadata={"k": {
                "functionName": fn_name, "numPartitions": num_partitions,
                "partitions": [i % num_partitions]}})
        if time_ranges:
            md.start_time, md.end_time = time_ranges[i]
        store.set_segment_metadata(md)
        for r in range(replicas):
            store.report_instance_state(
                TABLE, f"seg_{i}", f"s{(i + r) % num_segments}",
                state.ONLINE)
    return store


def _route(pkg, store, rm, sql, request_id=None):
    routing, _, stats_cls, compile_query, _, _ = pkg
    stats = stats_cls()
    ctx = compile_query(sql) if sql is not None else None
    res = rm.route(TABLE, ctx, request_id=request_id, stats=stats)
    return ({s: sorted(v) for s, v in res.routing.items()},
            sorted(res.unavailable),
            (res.segments_total, res.segments_routed, res.time_pruned,
             res.partition_pruned, res.servers_unpruned,
             res.servers_routed),
            dict(stats.decisions))


def _both(sqls, request_ids=(None,), mutate=None, **kw):
    """[(JAX route, port route)] for every (sql, request id)."""
    out = []
    runs = []
    for pkg in (JAX, PORT):
        store = _store(pkg, **kw)
        rm = pkg[0].RoutingManager(store)
        if mutate is not None:
            mutate(pkg, store)
        runs.append([_route(pkg, store, rm, sql, rid)
                     for sql in sqls for rid in request_ids])
    for j, t in zip(*runs):
        out.append((j, t))
    return out


PARTITION_SQL = [
    "SELECT count(*) FROM part WHERE k = 6",                      # eq
    "SELECT count(*) FROM part WHERE k IN (1, 2)",                # IN
    "SELECT count(*) FROM part WHERE k BETWEEN 4 AND 5",          # range
    "SELECT count(*) FROM part WHERE k BETWEEN 0 AND 100000",     # wide
    "SELECT count(*) FROM part WHERE k > 7",                      # open
    "SELECT count(*) FROM part WHERE k = 2 OR k > 100000",        # OR
    "SELECT count(*) FROM part",                                  # none
    None,                                                         # probe
]


@pytest.mark.parametrize("sql", PARTITION_SQL)
@pytest.mark.parametrize("fn_name", ["Modulo", "Murmur"])
def test_partition_pruning_equal(sql, fn_name):
    for j, t in _both([sql], fn_name=fn_name):
        assert j == t


def test_partition_pruning_examples():
    """The oracle's expectations, on the port."""
    store = _store(PORT)
    rm = trouting.RoutingManager(store)
    got = [sorted(sum(_route(PORT, store, rm, sql)[0].values(), []))
           for sql in PARTITION_SQL[:3]]
    assert got == [["seg_2"], ["seg_1", "seg_2"], ["seg_0", "seg_1"]]
    routed, _, _, dec = _route(PORT, store, rm, PARTITION_SQL[0])
    assert dec == {"routing:all_servers->pruned:partition_prune": 1}
    assert _route(PORT, store, rm, PARTITION_SQL[6])[3] == {
        "routing:pruned->all_servers:no_filter": 1}
    assert _route(PORT, store, rm, PARTITION_SQL[4])[3] == {
        "routing:pruned->all_servers:no_partition_predicate": 1}


def test_no_partition_metadata_and_no_pruner():
    def strip(pkg, store):
        state = pkg[1]
        for i in range(4):
            store.set_segment_metadata(state.SegmentZKMetadata(
                segment_name=f"seg_{i}", table_name=TABLE))
    for j, t in _both(["SELECT count(*) FROM part WHERE k = 2"],
                      mutate=strip):
        assert j == t
        assert t[3] == {
            "routing:pruned->all_servers:no_partition_metadata": 1}
    for j, t in _both(["SELECT count(*) FROM part WHERE k = 2"],
                      pruner=False):
        assert j == t and t[3] == {}


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM part WHERE ts BETWEEN 12 AND 25",
    "SELECT count(*) FROM part WHERE ts = 30",
    "SELECT count(*) FROM part WHERE ts > 19 AND k = 2",
    "SELECT count(*) FROM part WHERE ts < 100",
    "SELECT count(*) FROM part WHERE k = 1",
])
def test_time_pruning_equal(sql):
    for j, t in _both([sql], time_ranges=[(0, 9), (10, 19), (20, 29),
                                          (30, 39)]):
        assert j == t
    if "BETWEEN" in sql:
        _, _, counts, dec = t
        assert counts[2] == 2       # two segments time-pruned
        assert dec["routing:all_servers->pruned:time_prune"] == 1


@pytest.mark.parametrize("selector", ["balanced", "replicaGroup",
                                      "strictReplicaGroup"])
def test_selectors_equal(selector):
    sqls = ["SELECT count(*) FROM part", None]
    for j, t in _both(sqls, request_ids=range(1, 7), replicas=2,
                      selector=selector, pruner=False):
        assert j == t


@pytest.mark.parametrize("selector", ["balanced", "replicaGroup",
                                      "strictReplicaGroup"])
def test_selectors_with_a_dead_server(selector):
    def kill(pkg, store):
        store.set_instance_alive("s1", False)
    for j, t in _both(["SELECT count(*) FROM part"], request_ids=range(1, 5),
                      replicas=2, selector=selector, pruner=False,
                      mutate=kill):
        assert j == t
        assert "s1" not in t[0]


def test_selector_classes():
    """tests/test_routing_replica.py's TestSelectors on both packages."""
    groups = [["s0", "s1"], ["s2", "s3"]]
    for routing in (jrouting, trouting):
        sel = routing.ReplicaGroupInstanceSelector(groups)
        picks = {sel.select("x", ["s0", "s2"], rid, frozenset())
                 for rid in range(4)}
        assert picks == {"s0", "s2"}
        assert sel.select("x", ["s0", "s2"], 0, frozenset({"s0"})) == "s2"
        strict = routing.StrictReplicaGroupInstanceSelector(groups)
        assert strict.select("x", ["s0"], 1, frozenset()) is None
        bal = routing.BalancedInstanceSelector()
        assert bal.select("x", ["b", "a"], 3, frozenset()) == "b"
        assert bal.select("x", ["a"], 3, frozenset({"a"})) is None


def test_dead_set_refreshed_on_liveness_change():
    for pkg in (JAX, PORT):
        store = _store(pkg)
        rm = pkg[0].RoutingManager(store)
        _route(pkg, store, rm, None)        # warm the dead-instance cache
        store.set_instance_alive("s1", False)
        routing, unavailable, _, _ = _route(pkg, store, rm, None)
        assert "s1" not in routing and unavailable == ["seg_1"]
        store.set_instance_alive("s1", True)
        assert "s1" in _route(pkg, store, rm, None)[0]


def test_new_segment_invalidates_the_snapshot():
    store = _store(PORT)
    rm = trouting.RoutingManager(store)
    assert _route(PORT, store, rm, None)[2][0] == 4     # segments
    store.set_segment_metadata(tstate.SegmentZKMetadata(
        segment_name="seg_4", table_name=TABLE,
        partition_metadata={"k": {"functionName": "Modulo",
                                  "numPartitions": 4, "partitions": [0]}}))
    store.report_instance_state(TABLE, "seg_4", "s0", tstate.ONLINE)
    routing = _route(PORT, store, rm,
                     "SELECT count(*) FROM part WHERE k = 4")[0]
    assert sorted(sum(routing.values(), [])) == ["seg_0", "seg_4"]


def test_no_store_reads_after_warm_up():
    store = _store(PORT, time_ranges=[(0, 9), (10, 19), (20, 29), (30, 39)])
    rm = trouting.RoutingManager(store)
    sql = "SELECT count(*) FROM part WHERE k = 2 AND ts < 25"
    warm = _route(PORT, store, rm, sql)

    def boom(*a, **k):
        raise AssertionError("state store read on a warmed route")

    for name in ("get", "get_segment_metadata", "segment_metadata_list",
                 "get_external_view", "get_table_config",
                 "get_instance_partitions", "instances", "children"):
        setattr(store, name, boom)
    assert _route(PORT, store, rm, sql)[:3] == warm[:3]


def test_routing_reasons_registered():
    """Every routing reason either package records is a registered code,
    and the two registries are equal."""
    from pinot_tpu.common.tracing import ROUTING_DECISION_REASONS

    assert trouting.ROUTING_DECISION_REASONS == ROUTING_DECISION_REASONS
    seen = set()
    for sql in PARTITION_SQL:
        for _, t in _both([sql]):
            seen |= {k.rsplit(":", 1)[1] for k in t[3]}
    assert seen and seen <= trouting.ROUTING_DECISION_REASONS


def test_lineage_hidden_reads_the_store_key():
    store = _store(PORT)
    rm = trouting.RoutingManager(store)
    assert rm._lineage_hidden(TABLE) == frozenset()
    store.set(f"lineage/{TABLE}", [
        {"id": "a", "segmentsFrom": ["seg_0"], "segmentsTo": ["seg_9"],
         "state": "COMPLETED"},
        {"id": "b", "segmentsFrom": ["seg_1"], "segmentsTo": ["seg_3"],
         "state": "IN_PROGRESS"}])
    routing = _route(PORT, store, rm, None)[0]
    assert sorted(sum(routing.values(), [])) == ["seg_1", "seg_2"]


# -- the timed-out gather (tests/test_cluster_routing.py:337, steady) ----------

def _small_port_cluster():
    import numpy as np

    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    cluster = EmbeddedCluster(num_servers=3, device="cpu")
    schema = Schema("sales", [
        FieldSpec("region", DataType.STRING),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC)])
    cluster.create_table(ttable.TableConfig("sales"), schema)
    rng = np.random.default_rng(7)
    for i in range(3):
        cluster.ingest_rows(
            "sales_OFFLINE", schema,
            {"region": ["east", "west"] * 50,
             "qty": rng.integers(1, 9, 100).tolist()},
            segment_name=f"sales_{i}")
    assert cluster.wait_for_ev_converged("sales_OFFLINE", timeout_s=30)
    return cluster


def _pins(cluster):
    return {sid: {n: d["pins"]
                  for n, d in s.executor.residency.snapshot()[
                      "stagedSegments"].items() if d["pins"]}
            for sid, s in cluster.servers.items()}


def test_timed_out_server_yields_partial_with_accounting(monkeypatch):
    cluster = _small_port_cluster()
    try:
        full = cluster.query("SELECT sum(qty) FROM sales")     # warm
        assert not full.exceptions
        victim_id = sorted(cluster.servers)[0]
        victim = cluster.servers[victim_id]
        real = victim.execute_query
        hold = threading.Event()
        done = threading.Event()

        def held(ctx, table, segment_names=None):
            hold.wait(60)       # released only after the broker timed out
            try:
                return real(ctx, table, segment_names)
            finally:
                done.set()

        monkeypatch.setattr(victim, "execute_query", held)
        monkeypatch.setattr(cluster.broker, "query_timeout_s", 0.2)
        resp = cluster.query("SELECT sum(qty) FROM sales")
        hold.set()
        assert resp.result_table is not None
        assert resp.num_servers_queried == 3
        assert resp.num_servers_responded == 2
        assert resp.stats.num_servers_responded == 2
        assert any("timed out" in e["message"] for e in resp.exceptions)
        assert resp.to_dict()["partialResult"] is True
        assert resp.stats.decisions.get(
            "gather:full_result->partial_result:server_timeout") == 1
        assert resp.result_table.rows[0][0] < full.result_table.rows[0][0]
        assert done.wait(60)
        assert not any(_pins(cluster).values())
    finally:
        cluster.shutdown()


def test_downed_server_yields_partial_not_wrong():
    cluster = _small_port_cluster()
    try:
        assert cluster.query_rows("SELECT count(*) FROM sales") == [[300]]
        victim = cluster.servers[sorted(cluster.servers)[1]]
        victim._queries_enabled = False     # a typed refusal mid-scatter
        resp = cluster.query("SELECT count(*) FROM sales")
        assert resp.result_table.rows[0][0] < 300
        assert resp.num_servers_responded < resp.num_servers_queried
        assert resp.stats.decisions.get(
            "gather:full_result->partial_result:server_error") == 1
        assert resp.exceptions
        victim._queries_enabled = True
        assert cluster.query_rows("SELECT count(*) FROM sales") == [[300]]
    finally:
        cluster.shutdown()
