"""The port's cluster state store, segment assignment and controller
(``pinot_tpu_torch/controller/``) against the JAX package's, driven with
the same mutations: the order watchers see, ``compare_and_set`` /
``update``, the version bump, and IdealStates equal to JAX's for the same
servers and pushes (balanced with and without failure domains,
replica-group with stored instance partitions)."""

import threading
import types

import numpy as np
import pytest

from pinot_tpu.controller import assignment as jassign
from pinot_tpu.controller import controller as jcontroller
from pinot_tpu.controller import state as jstate
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi import table as jtable
from pinot_tpu_torch.controller import assignment as tassign
from pinot_tpu_torch.controller import controller as tcontroller
from pinot_tpu_torch.controller import state as tstate
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable


def _mutations(store, state):
    """The same mutation sequence on either package's store; -> the
    (path, value) pairs its watchers saw and the versions returned."""
    seen = []
    store.watch("idealstate/", lambda p, v: seen.append(("is", p, v)))
    store.watch("", lambda p, v: seen.append(("all", p, v)))
    versions = [store.set("idealstate/t", {"s0": {"a": "ONLINE"}})]
    versions.append(store.set("externalview/t", {}))
    store.report_instance_state("t", "s0", "a", state.ONLINE)
    store.report_instance_state("t", "s0", "b", state.ONLINE)
    store.report_instance_state("t", "s0", "a", state.OFFLINE)
    cas = [store.compare_and_set("idealstate/t", {"s0": {"x": 1}}, {}),
           store.compare_and_set("idealstate/t", {"s0": {"a": "ONLINE"}},
                                 {"s1": {"a": "ONLINE"}})]
    upd = store.update("counter", lambda v: (v or 0) + 5, default=None)
    store.delete("externalview/t")
    store.delete("nothing/here")
    return seen, versions, cas, upd, store.version


def test_watch_order_cas_update_version():
    j = _mutations(jstate.ClusterStateStore(), jstate)
    t = _mutations(tstate.ClusterStateStore(), tstate)
    assert t == j
    seen, _, cas, upd, version = t
    assert cas == [False, True] and upd == 5 and version == 8


def test_reentrant_watcher_drains_in_mutation_order():
    """A watcher that mutates the store (a server reporting state inside
    the reconcile its IdealState watch started) sees every event once, in
    version order, in both packages."""
    def run(state):
        store = state.ClusterStateStore()
        seen = []

        def on_ideal(path, value):
            seen.append(path)
            for seg in value or {}:
                store.report_instance_state("t", seg, "a", state.ONLINE)

        store.watch("idealstate/", on_ideal)
        store.watch("externalview/", lambda p, v: seen.append((p, v)))
        store.set("idealstate/t", {"s0": {}, "s1": {}})
        return seen, store.version

    assert run(tstate) == run(jstate)


def test_concurrent_mutators_keep_version_order():
    store = tstate.ClusterStateStore()
    seen = []
    store.watch("k/", lambda p, v: seen.append(v))

    def writer(i):
        for n in range(50):
            store.update("k/x", lambda v: (v or 0) + 1, default=0)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert seen == list(range(1, 201))
    assert store.version == 200


def test_typed_configs_are_copies():
    store = tstate.ClusterStateStore()
    cfg = ttable.TableConfig("t", validation_config=ttable
                             .SegmentsValidationConfig(replication=2))
    store.add_table_config(cfg)
    cfg.validation_config.replication = 7
    got = store.get_table_config("t_OFFLINE")
    assert got.replication == 2
    got.validation_config.replication = 9
    assert store.get_table_config("t_OFFLINE").replication == 2
    assert store.table_names() == ["t_OFFLINE"]


@pytest.mark.parametrize("domains", [None, {"s0": "d0", "s1": "d0",
                                            "s2": "d1", "s3": "d2"}])
@pytest.mark.parametrize("replication", [1, 2, 3])
def test_balanced_assignment_equal(domains, replication):
    servers = ["s0", "s1", "s2", "s3"]
    ideal = {"j": {}, "t": {}}
    for i in range(11):
        seg = f"seg_{i}"
        for key, mod in (("j", jassign), ("t", tassign)):
            chosen = mod.BalancedSegmentAssignment(domains=domains).assign(
                seg, ideal[key], servers, replication)
            ideal[key][seg] = {c: "ONLINE" for c in chosen}
    assert ideal["t"] == ideal["j"]


@pytest.mark.parametrize("n_servers,groups", [(4, 2), (6, 3), (5, 2)])
def test_replica_group_assignment_equal(n_servers, groups):
    servers = [f"s{i}" for i in range(n_servers)][::-1]
    assert tassign.compute_instance_partitions(servers, groups) == \
        jassign.compute_instance_partitions(servers, groups)
    ideal = {"j": {}, "t": {}}
    for i in range(9):
        seg = f"seg_{i}"
        for key, mod in (("j", jassign), ("t", tassign)):
            chosen = mod.ReplicaGroupSegmentAssignment(groups).assign(
                seg, ideal[key], servers, groups)
            ideal[key][seg] = {c: "ONLINE" for c in chosen}
    assert ideal["t"] == ideal["j"]


def test_no_servers_raises():
    for mod in (jassign, tassign):
        with pytest.raises(ValueError):
            mod.BalancedSegmentAssignment().assign("s", {}, [], 1)


# -- the controller: the same pushes give the same IdealState --------------------

def _jax_metadata(name, num_docs):
    """What the JAX controller's add_segment reads of a segment's
    metadata (no partitioned column, no time column)."""
    return types.SimpleNamespace(
        segment_name=name, num_docs=num_docs, columns={}, crc=0,
        creation_time_ms=0, min_time=None, max_time=None)


def _port_metadata(name, num_docs):
    schema = tdata.Schema("t", [tdata.FieldSpec("k", tdata.DataType.INT)])
    return SegmentBuilder(schema, name).build(
        {"k": np.arange(num_docs)}).metadata


def _controller_pushes(mod, state, table, data, meta, selector, domains):
    c = mod.Controller()
    servers = ["s3", "s1", "s0", "s2"]
    for s in servers:
        c.register_instance(state.InstanceInfo(
            s, "SERVER", failure_domain=(domains or {}).get(s)))
    c.add_schema(data.Schema("t", [data.FieldSpec("k", data.DataType.INT)]))
    c.add_table(table.TableConfig(
        "t", validation_config=table.SegmentsValidationConfig(
            replication=2),
        routing_config=table.RoutingConfig(instance_selector_type=selector)))
    for i in range(7):
        c.add_segment("t_OFFLINE", meta(f"seg_{i}", 10 + i), f"u{i}")
    c.delete_segment("t_OFFLINE", "seg_3")
    c.add_segment("t_OFFLINE", meta("seg_7", 5), "u7")
    return (c.store.get_ideal_state("t_OFFLINE"),
            c.store.get_instance_partitions("t_OFFLINE"),
            c.store.segment_names("t_OFFLINE"))


@pytest.mark.parametrize("selector", ["balanced", "replicaGroup"])
@pytest.mark.parametrize("domains", [None, {"s0": "a", "s1": "a",
                                            "s2": "b", "s3": "b"}])
def test_controller_ideal_state_equal(selector, domains):
    j = _controller_pushes(jcontroller, jstate, jtable, jdata,
                           _jax_metadata, selector, domains)
    t = _controller_pushes(tcontroller, tstate, ttable, tdata,
                           _port_metadata, selector, domains)
    assert t == j


def test_realtime_table_refused_whole():
    """A REALTIME table without a stream config is refused before the
    controller writes anything."""
    c = tcontroller.Controller()
    c.add_schema(tdata.Schema("rt", [tdata.FieldSpec("k",
                                                     tdata.DataType.INT)]))
    before = c.store.version
    with pytest.raises(ValueError, match="stream config"):
        c.add_table(ttable.TableConfig("rt", ttable.TableType.REALTIME))
    assert c.store.version == before
    assert c.table_names() == []


def test_segment_time_range_from_the_table_time_column():
    """The table's time column gives the pushed segment's range even where
    the schema calls it a dimension (SSB's d_yearmonthnum)."""
    schema = tdata.Schema("t", [tdata.FieldSpec("m", tdata.DataType.INT),
                                tdata.FieldSpec("ts", tdata.DataType.LONG,
                                                tdata.FieldType.DATE_TIME)])
    seg = SegmentBuilder(schema, "s").build(
        {"m": np.array([199402, 199401, 199412]),
         "ts": np.array([5, 9, 7])})
    assert tcontroller.segment_time_range(seg.metadata, "m") == \
        (199401, 199412)
    assert tcontroller.segment_time_range(seg.metadata, None) == (5, 9)


def test_liveness_check_and_tags():
    c = tcontroller.Controller()
    c.register_instance(tstate.InstanceInfo("s0", "SERVER"))
    c.register_instance(tstate.InstanceInfo("s1", "SERVER"))
    c.store.touch_instance("s0", now_ms=1_000)
    assert c.run_liveness_check(timeout_ms=500, now_ms=2_000) == ["s0"]
    assert not c.store.get_instance("s0").alive
    assert c.store.get_instance("s1").alive      # never heartbeated
    c.store.touch_instance("s0", now_ms=3_000)
    assert c.store.get_instance("s0").alive
    c.update_instance_tags("s1", ["t1"])
    assert c.store.get_instance("s1").tags == ["t1"]
    with pytest.raises(KeyError):
        c.update_instance_tags("nope", [])


# -- the deep store, partition metadata, the time boundary ------------------------

def test_memory_deep_store():
    from pinot_tpu_torch.spi.filesystem import MemoryDeepStore

    schema = tdata.Schema("t", [tdata.FieldSpec("k", tdata.DataType.INT)])
    seg = SegmentBuilder(schema, "seg_a").build({"k": np.arange(5)})
    deep = MemoryDeepStore()
    url = deep.put_segment("t_OFFLINE", seg)
    assert url == "memory://t_OFFLINE/seg_a"
    assert deep.fetch_segment(url) is seg
    with pytest.raises(ValueError, match="scheme"):
        deep.fetch_segment("file:///tmp/t_OFFLINE/seg_a")
    with pytest.raises(ValueError):
        deep.fetch_segment("memory://no-segment-part")
    with pytest.raises(KeyError):
        deep.fetch_segment("memory://t_OFFLINE/other")
    # another store (another cluster) holds nothing of this one's
    with pytest.raises(KeyError):
        MemoryDeepStore().fetch_segment(url)
    deep.delete_table("t_OFFLINE")
    with pytest.raises(KeyError):
        deep.fetch_segment(url)
    assert len(deep) == 0


def test_controller_drops_deleted_segments_from_its_deep_store():
    """Deleting a segment or a table drops it from the controller's deep
    store, so a cluster keeps only what it serves."""
    schema = tdata.Schema("t", [tdata.FieldSpec("k", tdata.DataType.INT)])
    c = tcontroller.Controller()
    c.register_instance(tstate.InstanceInfo("s0", "SERVER"))
    c.add_schema(schema)
    c.add_table(ttable.TableConfig("t"))
    for name in ("seg_a", "seg_b"):
        seg = SegmentBuilder(schema, name).build({"k": np.arange(5)})
        c.add_segment("t_OFFLINE", seg.metadata,
                      c.deep_store.put_segment("t_OFFLINE", seg))
    assert len(c.deep_store) == 2
    c.delete_segment("t_OFFLINE", "seg_a")
    assert len(c.deep_store) == 1
    with pytest.raises(KeyError):
        c.deep_store.fetch_segment("memory://t_OFFLINE/seg_a")
    c.delete_table("t_OFFLINE")
    assert len(c.deep_store) == 0


@pytest.mark.parametrize("fn", ["Murmur", "Modulo", "HashCode"])
def test_builder_partition_metadata_equal(tmp_path, fn):
    """A column of the indexing config's segment_partition_config records
    the partitions its values fall in, as the JAX builder records them."""
    from pinot_tpu.segment import SegmentBuilder as JBuilder
    from pinot_tpu.segment import load_segment

    values = [3, 17, 17, 40, 99, 101, 250]
    cpm = {"k": {"functionName": fn, "numPartitions": 8}}
    jseg_schema = jdata.Schema("t", [jdata.FieldSpec("k", jdata.DataType.INT)])
    JBuilder(jseg_schema, "s", indexing_config=jtable.IndexingConfig(
        segment_partition_config=jtable.SegmentPartitionConfig(cpm))).build(
        {"k": values}, str(tmp_path))
    jcm = load_segment(str(tmp_path / "s")).metadata.columns["k"]
    tseg = SegmentBuilder(
        tdata.Schema("t", [tdata.FieldSpec("k", tdata.DataType.INT)]), "s",
        indexing=ttable.IndexingConfig(
            segment_partition_config=ttable.SegmentPartitionConfig(cpm))
    ).build({"k": np.array(values)})
    tcm = tseg.metadata.columns["k"]
    assert (tcm.partition_function, tcm.num_partitions, tcm.partitions) == \
        (jcm.partition_function, jcm.num_partitions, jcm.partitions)


def test_time_boundary_equal():
    from pinot_tpu.broker.routing import TimeBoundaryManager as JBoundary
    from pinot_tpu_torch.broker.routing import TimeBoundaryManager

    out = []
    for state, cls in ((jstate, JBoundary), (tstate, TimeBoundaryManager)):
        store = state.ClusterStateStore()
        tb = cls(store)
        got = [tb.get_boundary("t_OFFLINE")]
        for i, end in enumerate([19, 45, None, 30]):
            store.set_segment_metadata(state.SegmentZKMetadata(
                segment_name=f"s{i}", table_name="t_OFFLINE",
                start_time=0, end_time=end))
            got.append(tb.get_boundary("t_OFFLINE"))
        out.append(got)
    assert out[1] == out[0] == [None, 18, 44, 44, 44]
