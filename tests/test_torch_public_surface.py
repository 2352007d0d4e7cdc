"""The JAX package's public helpers in the port, held to the JAX tests
that call them, on both packages side by side:

- ``PinotConfiguration.set`` with its layers, ``set_default``,
  ``load_properties_file``, ``subset`` and ``to_dict``
  (tests/test_spi.py:160-190): an override beats the environment, the
  environment beats a properties file, a file beats a default;
- ``TimeGranularity.to_millis``, ``FieldSpec.is_dimension`` /
  ``is_metric``, ``Schema.dimension_names`` / ``metric_names`` /
  ``has_column`` (tests/test_spi.py:47-48);
- ``ThetaSketch.intersect`` and ``a_not_b``
  (tests/test_theta_idset_withtime.py:41-42): estimates within 15% and
  the retained hashes equal to JAX's;
- ``RoutingManager.routable_tables``, ``table_exists`` and
  ``get_routing_table`` (tests/test_routing_replica.py:89, :137,
  tests/test_lineage_tiers.py:86-99).

None of these touches the card.
"""

import types

import numpy as np
import pytest

from pinot_tpu.broker import routing as jrouting
from pinot_tpu.controller import lineage as jlineage
from pinot_tpu.controller import state as jstate
from pinot_tpu.spi import config as jconfig
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi import table as jtable
from pinot_tpu.utils import theta as jtheta
from pinot_tpu_torch.broker import routing as trouting
from pinot_tpu_torch.controller import lineage as tlineage
from pinot_tpu_torch.controller import state as tstate
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.spi import config as tconfig
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable
from pinot_tpu_torch.utils import theta as ttheta

JAX = types.SimpleNamespace(config=jconfig, data=jdata, table=jtable,
                            theta=jtheta, routing=jrouting,
                            lineage=jlineage, state=jstate)
PORT = types.SimpleNamespace(config=tconfig, data=tdata, table=ttable,
                             theta=ttheta, routing=trouting,
                             lineage=tlineage, state=tstate)
BOTH = pytest.mark.parametrize("ns", [JAX, PORT], ids=["jax", "port"])


def _schema(ns):
    d = ns.data
    return d.Schema("baseballStats", [
        d.FieldSpec("playerID", d.DataType.STRING),
        d.FieldSpec("teamID", d.DataType.STRING),
        d.FieldSpec("yearID", d.DataType.INT),
        d.FieldSpec("league", d.DataType.STRING),
        d.FieldSpec("homeRuns", d.DataType.INT, d.FieldType.METRIC),
        d.FieldSpec("runs", d.DataType.LONG, d.FieldType.METRIC),
        d.FieldSpec("avgScore", d.DataType.DOUBLE, d.FieldType.METRIC),
        d.FieldSpec("ts", d.DataType.LONG, d.FieldType.DATE_TIME),
    ])


# -- spi/data.py ----------------------------------------------------------------

def test_schema_dimension_metric_split():
    j, t = _schema(JAX), _schema(PORT)
    assert "playerID" in t.dimension_names
    assert "homeRuns" in t.metric_names
    assert t.dimension_names == j.dimension_names
    assert t.metric_names == j.metric_names
    assert "ts" in t.dimension_names
    for name in j.column_names + ["nope"]:
        assert t.has_column(name) == j.has_column(name)
    for jf, tf in zip(j.field_specs, t.field_specs):
        assert (tf.is_dimension, tf.is_metric) == (jf.is_dimension,
                                                   jf.is_metric)


@pytest.mark.parametrize("unit", ["MILLISECONDS", "SECONDS", "MINUTES",
                                  "HOURS", "days"])
@pytest.mark.parametrize("size", [1, 15])
def test_time_granularity_to_millis(unit, size):
    tg = tdata.TimeGranularity(unit=unit, size=size)
    jg = jdata.TimeGranularity(unit=unit, size=size)
    for v in (0, 1, 7, 19_000):
        assert tg.to_millis(v) == jg.to_millis(v)
    assert tdata.TimeGranularity.from_dict("1:DAYS").to_millis(2) \
        == 2 * 86_400_000


# -- spi/config.py (tests/test_spi.py:160-190) ------------------------------------

@BOTH
def test_override_wins(ns, monkeypatch):
    monkeypatch.setenv("PINOT_SERVER_QUERY_PORT", "9999")
    cfg = ns.config.PinotConfiguration({"pinot.broker.timeoutMs": 5000})
    assert cfg.get_int("pinot.server.query.port") == 9999
    assert cfg.get_int("PINOT.BROKER.TIMEOUTMS") == 5000
    cfg.set("pinot.broker.timeoutMs", 1)
    assert cfg.get_int("pinot.broker.timeout-ms") == 1


@BOTH
def test_env_beats_properties_file(ns, monkeypatch, tmp_path):
    monkeypatch.setenv("PINOT_SERVER_PORT", "9")
    p = tmp_path / "conf.properties"
    p.write_text("pinot.server.port=1\npinot.server.other=2\n")
    cfg = ns.config.PinotConfiguration()
    cfg.load_properties_file(str(p))
    assert cfg.get_int("pinot.server.port") == 9
    assert cfg.get_int("pinot.server.other") == 2


@BOTH
def test_layers_whatever_the_order(ns, tmp_path):
    c = ns.config
    p = tmp_path / "conf.properties"
    p.write_text("! bang comment\na.file=file\na.both=file\n")
    cfg = c.PinotConfiguration({"a.over": "over"}, use_env=False)
    cfg.load_properties_file(str(p))
    cfg.set_default("a.file", "default")
    cfg.set_default("a.fresh", "default")
    cfg.set("a.over", "env", c.PRIORITY_ENV)
    cfg.set("a.both", "env", c.PRIORITY_ENV)
    assert cfg.get("a.over") == "over"
    assert cfg.get("a.file") == "file"
    assert cfg.get("a.fresh") == "default"
    assert cfg.get("a.both") == "env"
    assert cfg.to_dict() == {"a.over": "over", "a.file": "file",
                             "a.both": "env", "a.fresh": "default"}


@BOTH
def test_typed_getters_and_subset(ns):
    cfg = ns.config.PinotConfiguration({"a.b.flag": "true", "a.b.n": "7",
                                        "c": "x"}, use_env=False)
    assert cfg.get_bool("a.b.flag") is True
    sub = cfg.subset("a.b")
    assert sub.get_int("n") == 7
    assert "c" not in sub
    assert sub.to_dict() == {"flag": "true", "n": "7"}


@BOTH
def test_subset_respects_segment_boundary(ns):
    cfg = ns.config.PinotConfiguration({"server.port": 1, "serverx.port": 2},
                                       use_env=False)
    sub = cfg.subset("server")
    assert sub.get_int("port") == 1
    assert "xport" not in sub and "x.port" not in sub


@BOTH
def test_properties_file(ns, tmp_path):
    p = tmp_path / "server.properties"
    p.write_text("# comment\npinot.server.port=1234\n")
    cfg = ns.config.PinotConfiguration(use_env=False)
    cfg.load_properties_file(str(p))
    assert cfg.get_int("pinot.server.port") == 1234


def test_config_layers_equal_to_jax(monkeypatch, tmp_path):
    """One sequence of sets on both packages: the same dict out."""
    monkeypatch.setenv("PINOT_X_Y", "env")
    p = tmp_path / "c.properties"
    p.write_text("pinot.x.y=file\nq.r-s=file\n")
    out = []
    for ns in (JAX, PORT):
        c = ns.config
        cfg = c.PinotConfiguration({"QR.s": "over"})
        cfg.load_properties_file(str(p))
        cfg.set_default("pinot.x.y", "default")
        cfg.set("z", 1, c.PRIORITY_FILE)
        cfg.set("z", 2, c.PRIORITY_DEFAULT)
        out.append(({k: v for k, v in cfg.to_dict().items()
                     if not k.startswith("pinot.") or k == "pinot.x.y"},
                    cfg.subset("pinot").to_dict().get("x.y")))
    assert out[0] == out[1]


# -- utils/theta.py (tests/test_theta_idset_withtime.py:38-44) -------------------

@pytest.mark.parametrize("k", [4096, 64])
def test_intersect_and_a_not_b(k):
    a_vals, b_vals = np.arange(0, 50_000), np.arange(25_000, 75_000)
    t_a = ttheta.ThetaSketch.of(a_vals, nominal_entries=k)
    t_b = ttheta.ThetaSketch.of(b_vals, nominal_entries=k)
    j_a = jtheta.ThetaSketch.of(a_vals, nominal_entries=k)
    j_b = jtheta.ThetaSketch.of(b_vals, nominal_entries=k)
    for op in ("intersect", "a_not_b"):
        got = getattr(t_a, op)(t_b)
        want = getattr(j_a, op)(j_b)
        assert np.array_equal(got.hashes, want.hashes), op
        assert got.theta == want.theta and got.k == want.k
        assert got.estimate() == want.estimate()
    if k == 4096:
        assert abs(t_a.intersect(t_b).estimate() - 25_000) <= 0.15 * 25_000
        assert abs(t_a.a_not_b(t_b).estimate() - 25_000) <= 0.15 * 25_000


def test_exact_set_operations_below_k():
    a = ttheta.ThetaSketch.of(["x", "y", "z"])
    b = ttheta.ThetaSketch.of(["y", "z", "w"])
    assert a.intersect(b).estimate() == 2.0
    assert a.a_not_b(b).estimate() == 1.0
    assert b.a_not_b(a).estimate() == 1.0


# -- broker/routing.py --------------------------------------------------------------

TABLE = "t_OFFLINE"


def _seed(ns, store, segments=("s0", "s1", "s2"), servers=("srv1", "srv2")):
    store.add_table_config(ns.table.TableConfig(table_name="t"))
    for s in servers:
        store.register_instance(ns.state.InstanceInfo(s, "SERVER"))
    ideal = {}
    for seg in segments:
        store.set_segment_metadata(ns.state.SegmentZKMetadata(
            seg, TABLE, status="ONLINE", push_time_ms=1_000_000))
        ideal[seg] = {servers[0]: "ONLINE"}
    store.set_ideal_state(TABLE, ideal)
    for seg in segments:
        for inst, st in ideal[seg].items():
            store.report_instance_state(TABLE, seg, inst, st)


def _lineage_routes(ns):
    """tests/test_lineage_tiers.py:86-99 through ``get_routing_table``."""
    store = ns.state.ClusterStateStore()
    _seed(ns, store)
    rm = ns.routing.RoutingManager(store)
    seen = []

    def routed():
        routing, unavailable = rm.get_routing_table(TABLE)
        seen.append((sorted(sum(routing.values(), [])), unavailable))

    routed()
    lm = ns.lineage.SegmentLineageManager(store)
    eid = lm.start_replace(TABLE, ["s0", "s1"], ["m0"])
    store.set_segment_metadata(ns.state.SegmentZKMetadata(
        "m0", TABLE, status="ONLINE"))
    store.update_ideal_state(TABLE, lambda i: {**i, "m0": {"srv1": "ONLINE"}})
    store.report_instance_state(TABLE, "m0", "srv1", "ONLINE")
    routed()
    lm.end_replace(TABLE, eid)
    routed()
    return seen, rm.routable_tables(), rm.table_exists(TABLE), \
        rm.table_exists("nope_OFFLINE")


def test_routing_respects_lineage():
    got, want = _lineage_routes(PORT), _lineage_routes(JAX)
    assert got == want
    routes = got[0]
    assert routes[0] == (["s0", "s1", "s2"], [])
    assert routes[1] == (["s0", "s1", "s2"], [])
    assert routes[2] == (["m0", "s2"], [])
    assert got[1:] == ([TABLE], True, False)


def test_get_routing_table_is_route():
    store = tstate.ClusterStateStore()
    _seed(PORT, store)
    rm = trouting.RoutingManager(store)
    ctx = t_compile("SELECT count(*) FROM t")
    for rid in range(4):
        routing, unavailable = rm.get_routing_table(TABLE, ctx,
                                                    request_id=rid)
        res = rm.route(TABLE, ctx, request_id=rid)
        assert (routing, unavailable) == (res.routing, res.unavailable)


def _rg_schema(ns):
    d = ns.data
    return d.Schema("rg", [d.FieldSpec("city", d.DataType.STRING),
                           d.FieldSpec("v", d.DataType.LONG,
                                       d.FieldType.METRIC)])


@pytest.fixture()
def rg_cluster(tmp_path):
    """tests/test_routing_replica.py's replica-group cluster in the
    port."""
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    c = EmbeddedCluster(num_servers=4, device="cpu",
                        data_dir=str(tmp_path / "c"))
    cfg = ttable.TableConfig("rg", routing_config=ttable.RoutingConfig(
        instance_selector_type="replicaGroup"))
    cfg.validation_config.replication = 2
    c.create_table(cfg, _rg_schema(PORT))
    rng = np.random.default_rng(1)
    for i in range(4):
        c.ingest_rows("rg_OFFLINE", _rg_schema(PORT), {
            "city": np.array(["sf", "nyc"])[rng.integers(0, 2, 500)],
            "v": rng.integers(0, 9, 500).astype(np.int64),
        }, segment_name=f"rg_{i}")
    assert c.wait_for_ev_converged("rg_OFFLINE")
    try:
        yield c
    finally:
        c.shutdown()


def test_one_group_serves_each_query(rg_cluster):
    """tests/test_routing_replica.py:84-98 on the port's cluster."""
    groups = [set(g) for g in
              rg_cluster.store.get_instance_partitions("rg_OFFLINE")]
    rm = rg_cluster.broker.routing
    assert rm.routable_tables() == ["rg_OFFLINE"]
    assert rm.table_exists("rg_OFFLINE")
    assert not rm.table_exists("rg_REALTIME")
    ctx = t_compile("SELECT count(*) FROM rg")
    for rid in range(6):
        routing, unavailable = rm.get_routing_table("rg_OFFLINE", ctx,
                                                    request_id=rid)
        assert not unavailable
        used = set(routing.keys())
        assert any(used <= g for g in groups), (used, groups)
        assert sorted(sum(routing.values(), [])) == \
            [f"rg_{i}" for i in range(4)]


def test_partitioned_segments_prune_at_broker(tmp_path):
    """tests/test_routing_replica.py:104-137 on the port's cluster."""
    from pinot_tpu.utils.partition import get_partition_function
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    c = EmbeddedCluster(num_servers=1, device="cpu",
                        data_dir=str(tmp_path / "c"))
    part_cfg = ttable.IndexingConfig(
        segment_partition_config=ttable.SegmentPartitionConfig(
            {"city": {"functionName": "Murmur", "numPartitions": 4}}))
    cfg = ttable.TableConfig("pp", indexing_config=part_cfg,
                             routing_config=ttable.RoutingConfig(
                                 segment_pruner_types=["partition"]))
    schema = tdata.Schema("pp", [
        tdata.FieldSpec("city", tdata.DataType.STRING),
        tdata.FieldSpec("v", tdata.DataType.LONG, tdata.FieldType.METRIC)])
    c.create_table(cfg, schema)
    try:
        fn = get_partition_function("Murmur", 4)
        by_part = {}
        for v in (f"city{i}" for i in range(60)):
            by_part.setdefault(fn.partition(v), []).append(v)
        parts = sorted(by_part)[:2]
        for p in parts:
            vals = by_part[p]
            c.ingest_rows("pp_OFFLINE", schema, {
                "city": np.array(vals),
                "v": np.ones(len(vals), dtype=np.int64),
            }, segment_name=f"pp_{p}")
        assert c.wait_for_ev_converged("pp_OFFLINE")
        probe = by_part[parts[0]][0]
        ctx = t_compile(f"SELECT count(*) FROM pp WHERE city = '{probe}'")
        routing, _ = c.broker.routing.get_routing_table("pp_OFFLINE", ctx)
        assert sum(routing.values(), []) == [f"pp_{parts[0]}"]
    finally:
        c.shutdown()
