"""The remote state service (tests/test_remote_state.py's cases on the
port), and across packages: a port replica of a JAX authority and a JAX
replica of a port authority see the same paths, a table config and a
schema included (they travel as JAX's dicts and are objects again on the
port's side). The authority's restart is a new store seeded from the old
one's snapshot on a new port (the port's store keeps no snapshot file).
Every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.controller import state as jstate  # noqa: E402
from pinot_tpu.spi import table as jtable  # noqa: E402
from pinot_tpu.transport import state_service as jsvc  # noqa: E402
from pinot_tpu_torch.controller.controller import Controller  # noqa: E402
from pinot_tpu_torch.controller.state import ClusterStateStore  # noqa: E402
from pinot_tpu_torch.spi import data as tdata  # noqa: E402
from pinot_tpu_torch.spi import table as ttable  # noqa: E402
from pinot_tpu_torch.transport.state_service import (  # noqa: E402
    RemoteClusterStateStore,
    StateStoreApi,
)


@pytest.fixture
def authority():
    store = ClusterStateStore()
    api = StateStoreApi(store, port=0)
    api.start()
    try:
        yield store, f"http://localhost:{api.port}"
    finally:
        api.stop()


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_read_your_writes_and_replication(authority):
    store, url = authority
    remote = RemoteClusterStateStore(url, timeout_s=10)
    try:
        remote.set("a/b", {"x": 1})
        assert remote.get("a/b") == {"x": 1}
        assert store.get("a/b") == {"x": 1}
        store.set("a/c", [1, 2])
        assert _wait(lambda: remote.get("a/c") == [1, 2])
    finally:
        remote.close()


def test_watch_fires_on_remote_mutation(authority):
    store, url = authority
    remote = RemoteClusterStateStore(url, timeout_s=10)
    seen = []
    remote.watch("tables/", lambda p, v: seen.append((p, v)))
    try:
        store.set("tables/t1", {"n": 1})
        assert _wait(lambda: ("tables/t1", {"n": 1}) in seen)
        store.add_table_config(ttable.TableConfig("sales"))
        assert _wait(lambda: any(p == "tables/sales_OFFLINE"
                                 for p, _v in seen))
        value = next(v for p, v in seen if p == "tables/sales_OFFLINE")
        assert value == ttable.TableConfig("sales")
    finally:
        remote.close()


def test_update_is_atomic_across_clients(authority):
    store, url = authority
    a = RemoteClusterStateStore(url, timeout_s=10)
    b = RemoteClusterStateStore(url, timeout_s=10)
    try:
        def bump(client, n):
            for _ in range(n):
                client.update("counter", lambda v: (v or 0) + 1, default=0)

        ts = [threading.Thread(target=bump, args=(c, 25)) for c in (a, b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert store.get("counter") == 50
    finally:
        a.close()
        b.close()


def test_delete_replicates(authority):
    store, url = authority
    remote = RemoteClusterStateStore(url, timeout_s=10)
    try:
        store.set("gone/x", 1)
        assert _wait(lambda: remote.get("gone/x") == 1)
        remote.delete("gone/x")
        assert store.get("gone/x") is None
        store.set("gone/y", 2)
        assert _wait(lambda: remote.get("gone/y") == 2)
        store.delete("gone/y")
        assert _wait(lambda: remote.get("gone/y") is None)
    finally:
        remote.close()


def test_full_resync_after_log_overflow(authority):
    store, url = authority
    remote = RemoteClusterStateStore(url, poll_interval_s=10, timeout_s=10)
    seen = []
    remote.watch("gone/", lambda p, v: seen.append((p, v)))
    try:
        store.set("gone/z", 1)
        remote._sync_once()
        assert remote.get("gone/z") == 1
        store.delete("gone/z")
        for i in range(ClusterStateStore._LOG_CAP + 50):
            store.set("k", i)
        remote._sync_once()
        assert remote.get("k") == ClusterStateStore._LOG_CAP + 49
        # the resync fires a delete for a path that vanished
        assert ("gone/z", None) in seen and remote.get("gone/z") is None
    finally:
        remote.close()


def test_typed_configs_through_a_replica(authority):
    """A replica's typed accessors hand out objects; its writes reach the
    authority as objects; compare-and-set on a config compares wire
    forms."""
    store, url = authority
    remote = RemoteClusterStateStore(url, timeout_s=10)
    try:
        schema = tdata.Schema("s", [
            tdata.FieldSpec("k", tdata.DataType.STRING),
            tdata.FieldSpec("v", tdata.DataType.LONG,
                            tdata.FieldType.METRIC)])
        remote.add_schema(schema)
        cfg = ttable.TableConfig("s", validation_config=ttable
                                 .SegmentsValidationConfig(replication=2))
        remote.add_table_config(cfg)
        assert store.get_table_config("s_OFFLINE") == cfg
        assert store.get_schema("s").column_names == ["k", "v"]
        assert remote.get_table_config("s_OFFLINE") == cfg
        cfg2 = ttable.TableConfig("s", validation_config=ttable
                                  .SegmentsValidationConfig(replication=3))
        assert remote.compare_and_set("tables/s_OFFLINE", cfg, cfg2)
        assert not remote.compare_and_set("tables/s_OFFLINE", cfg, cfg2)
        assert store.get_table_config("s_OFFLINE").replication == 3
        remote.update("tables/s_OFFLINE", lambda c: ttable.TableConfig(
            "s", quota_config=ttable.QuotaConfig(5.0)))
        assert store.get_table_config("s_OFFLINE").quota_config \
            .max_queries_per_second == 5.0
    finally:
        remote.close()


def test_replicas_across_packages():
    """A port replica of a JAX authority, and a JAX replica of a port
    authority: the same paths and values, configs as JAX's dicts on the
    wire."""
    jstore = jstate.ClusterStateStore()
    tstore = ClusterStateStore()
    apis = [jsvc.StateStoreApi(jstore, port=0), StateStoreApi(tstore, port=0)]
    for api in apis:
        api.start()
    t_of_j = RemoteClusterStateStore(f"http://localhost:{apis[0].port}",
                                     timeout_s=10)
    j_of_t = jsvc.RemoteClusterStateStore(
        f"http://localhost:{apis[1].port}", timeout_s=10)
    try:
        jstore.add_table_config(jtable.TableConfig("a"))
        tstore.add_table_config(ttable.TableConfig("a"))
        for store in (jstore, tstore):
            store.set("idealstate/a_OFFLINE", {"s0": {"server_0": "ONLINE"}})
        assert _wait(lambda: t_of_j.get_table_config("a_OFFLINE") is not None
                     and j_of_t.get_table_config("a_OFFLINE") is not None
                     and t_of_j.get_ideal_state("a_OFFLINE")
                     and j_of_t.get_ideal_state("a_OFFLINE"))
        assert t_of_j.get_table_config("a_OFFLINE") == ttable.TableConfig("a")
        assert j_of_t.get("tables/a_OFFLINE") == \
            jtable.TableConfig("a").to_dict()
        assert t_of_j.snapshot_data()[1] == j_of_t.snapshot_data()[1]
        t_of_j.set("x/y", [1])
        assert jstore.get("x/y") == [1]
    finally:
        t_of_j.close()
        j_of_t.close()
        for api in apis:
            api.stop()


def test_remote_roles_end_to_end(authority, tmp_path):
    """The controller local; a server and a broker on another host: the
    control plane through replicas, the data plane through gRPC."""
    from pinot_tpu_torch.broker.broker import BrokerRequestHandler
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.server.server import ServerInstance
    from pinot_tpu_torch.spi.filesystem import file_url
    from pinot_tpu_torch.transport.grpc_transport import (
        GrpcQueryServer,
        GrpcServerStub,
    )

    store, url = authority
    controller = Controller(store)
    schema = tdata.Schema("rs", [
        tdata.FieldSpec("k", tdata.DataType.STRING),
        tdata.FieldSpec("v", tdata.DataType.LONG, tdata.FieldType.METRIC)])
    controller.add_schema(schema)
    controller.add_table(ttable.TableConfig("rs"))

    server_store = RemoteClusterStateStore(url, timeout_s=10)
    broker_store = RemoteClusterStateStore(url, timeout_s=10)
    server = ServerInstance("remote_server_0", server_store,
                            controller.deep_store,
                            executor=ServerQueryExecutor(device="cpu"),
                            segment_dir=str(tmp_path / "srv"))
    server.start()
    grpc_srv = GrpcQueryServer(server, port=0)
    grpc_srv.start()
    broker = BrokerRequestHandler(broker_store, device="cpu")
    stub = GrpcServerStub(f"localhost:{grpc_srv.port}", timeout_s=20)
    broker.register_server("remote_server_0", stub)
    try:
        rng = np.random.default_rng(5)
        frame = {"k": np.array(["a", "b"] * 600),
                 "v": rng.integers(0, 50, 1200).astype(np.int64)}
        meta = SegmentBuilder(schema, "rs_0").build(frame, str(tmp_path))
        controller.add_segment("rs_OFFLINE", meta,
                               file_url(str(tmp_path / "rs_0")))
        assert _wait(lambda: "rs_0" in server.hosted_segments("rs_OFFLINE"),
                     timeout=10)
        assert _wait(lambda: "rs_0" in broker_store.get_external_view(
            "rs_OFFLINE"), timeout=10)
        resp = broker.handle_sql(
            "SELECT k, sum(v) FROM rs GROUP BY k ORDER BY k")
        assert not resp.exceptions, resp.exceptions
        expect_a = int(frame["v"][frame["k"] == "a"].sum())
        assert resp.result_table.rows[0] == ["a", expect_a]
    finally:
        stub.close()
        grpc_srv.stop(grace=0.5)
        server.shutdown()
        broker.shutdown()
        server_store.close()
        broker_store.close()


def test_replica_survives_authority_restart():
    """The authority restarts from its snapshot on a new port: a replica
    pointed there resyncs and writes flow again."""
    store1 = ClusterStateStore()
    api1 = StateStoreApi(store1, port=0)
    api1.start()
    remote = RemoteClusterStateStore(f"http://localhost:{api1.port}",
                                     timeout_s=10)
    try:
        try:
            remote.set("tables/t1", {"n": 1})
            assert store1.get("tables/t1") == {"n": 1}
            remote.add_table_config(ttable.TableConfig("c"))
        finally:
            api1.stop()
        assert remote.get("tables/t1") == {"n": 1}
        _ver, data = store1.snapshot_data()
        store2 = ClusterStateStore()
        for path, value in data.items():
            if path.startswith("tables/") and "tableName" in value:
                store2.add_table_config(ttable.TableConfig.from_dict(value))
            else:
                store2.set(path, value)
        api2 = StateStoreApi(store2, port=0)
        api2.start()
        try:
            remote.reconnect(f"http://localhost:{api2.port}")
            store2.set("tables/t2", {"n": 2})
            assert _wait(lambda: remote.get("tables/t2") == {"n": 2})
            remote.set("tables/t3", {"n": 3})
            assert store2.get("tables/t3") == {"n": 3}
            assert remote.get_table_config("c_OFFLINE") == \
                ttable.TableConfig("c")
        finally:
            api2.stop()
    finally:
        remote.close()
