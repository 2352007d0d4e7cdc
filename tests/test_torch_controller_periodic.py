"""The controller's periodic tasks and rebalance against the JAX package
(oracle tests/test_controller.py:330-392).

Both packages' ``Controller`` get the same calls: retention (with its
lineage cleanup first), the segment status check, ``rebalance_steps`` and
``rebalance_table`` after a server is added, and ``start_periodic_tasks``
/ ``stop``; the deleted segments, reports, steps and IdealStates are
equal. On the port's ``EmbeddedCluster(device="cpu")``: relocation and
rebalance move what each server stages (a server that loses a segment
evicts it, one that gains it stages it; every segment stays served), and
the periodic loop and the cluster's shutdown leave no thread behind.
"""

import threading
import time

import numpy as np
import pytest

from pinot_tpu.controller import Controller as JController
from pinot_tpu.controller import assignment as jassign
from pinot_tpu.controller.state import InstanceInfo as JInstance
from pinot_tpu.segment.metadata import SegmentMetadata as JSegMeta
from pinot_tpu.spi import data as jdata
from pinot_tpu.spi import table as jtable
from pinot_tpu_torch.controller import Controller
from pinot_tpu_torch.controller import assignment as tassign
from pinot_tpu_torch.controller.state import InstanceInfo
from pinot_tpu_torch.segment.metadata import ColumnMetadata, SegmentMetadata
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable
from pinot_tpu_torch.tools.cluster import EmbeddedCluster

DAY = 86_400_000
SEED = "20260729T0000Z"


def _schema(mod):
    return mod.Schema("events", [
        mod.FieldSpec("user", mod.DataType.STRING),
        mod.FieldSpec("value", mod.DataType.LONG, mod.FieldType.METRIC),
        mod.FieldSpec("ts", mod.DataType.LONG, mod.FieldType.DATE_TIME)])


def _cfg(mod, replication=1, **vc):
    return mod.TableConfig("events", mod.TableType.OFFLINE,
                           validation_config=mod.SegmentsValidationConfig(
                               time_column_name="ts",
                               replication=replication, **vc))


def _j_md(name, lo=None, hi=None):
    return JSegMeta(name, "events", _schema(jdata), 10, 1024,
                    min_time=lo, max_time=hi)


def _t_md(name, lo=None, hi=None):
    """The port's metadata of a segment whose ``ts`` spans [lo, hi] (its
    controller reads the range from the table's time column)."""
    cols = {}
    if lo is not None:
        cols["ts"] = ColumnMetadata("ts", tdata.DataType.LONG,
                                    tdata.FieldType.DATE_TIME, 1,
                                    min_value=lo, max_value=hi)
    return SegmentMetadata(name, "events", _schema(tdata), 10, 1024,
                           columns=cols)


def _controllers(n):
    j, t = JController(llc_seed=SEED), Controller(llc_seed=SEED)
    for i in range(n):
        j.register_instance(JInstance(f"server_{i}", "SERVER"))
        t.register_instance(InstanceInfo(f"server_{i}", "SERVER"))
    return j, t


def test_retention_deletes_expired_after_lineage_cleanup():
    j, t = _controllers(1)
    now = 100 * DAY
    for c, mod, dmod, md in ((j, jtable, jdata, _j_md),
                             (t, ttable, tdata, _t_md)):
        c.add_schema(_schema(dmod))
        c.add_table(_cfg(mod, time_type="MILLISECONDS",
                         retention_time_unit="DAYS", retention_time_value=7))
        c.add_segment("events_OFFLINE", md("fresh", now - DAY, now - DAY),
                      "loc")
        c.add_segment("events_OFFLINE",
                      md("stale", now - 30 * DAY, now - 30 * DAY), "loc")
        c.add_segment("events_OFFLINE", md("no_range"), "loc")
        # a stale in-progress replacement is reverted by the same pass
        eid = c.start_replace_segments("events_OFFLINE", ["fresh"], ["m0"])
    got = []
    for c in (j, t):
        ts = c.store.get("lineage/events_OFFLINE")[0]["timestampMs"]
        deleted = c.run_retention_manager(now_ms=ts + 25 * 3_600_000)
        got.append((deleted, sorted(c.store.segment_names("events_OFFLINE")),
                    [e["state"] for e in
                     c.store.get("lineage/events_OFFLINE")],
                    sorted(c.store.get_ideal_state("events_OFFLINE"))))
    assert got[0] == got[1]
    # "fresh" is past 7 days of the lineage clock too
    assert got[1] == (["fresh", "stale"], ["no_range"], ["REVERTED"],
                      ["no_range"])
    del eid


def test_no_retention_configured_deletes_nothing():
    j, t = _controllers(1)
    for c, mod, dmod, md in ((j, jtable, jdata, _j_md),
                             (t, ttable, tdata, _t_md)):
        c.add_schema(_schema(dmod))
        c.add_table(_cfg(mod))
        c.add_segment("events_OFFLINE", md("old", 0, 1), "loc")
        assert c.run_retention_manager(now_ms=1000 * DAY) == []


def test_segment_status_check():
    j, t = _controllers(2)
    got = []
    for c, mod, dmod, md in ((j, jtable, jdata, _j_md),
                             (t, ttable, tdata, _t_md)):
        c.add_schema(_schema(dmod))
        c.add_table(_cfg(mod, replication=2))
        for i in range(3):
            c.add_segment("events_OFFLINE", md(f"s{i}", i, i), "loc")
        c.store.report_instance_state("events_OFFLINE", "s0", "server_0",
                                      "ONLINE")
        c.store.report_instance_state("events_OFFLINE", "s1", "server_1",
                                      "ONLINE")
        got.append(c.run_segment_status_check())
    assert got[0] == got[1] == {"events_OFFLINE": {
        "segments": 3, "replicasExpected": 6, "replicasMissing": 4}}


@pytest.mark.parametrize("seed", range(4))
def test_rebalance_steps_and_target_equal(seed):
    """Random current maps over a grown server list: the targets and the
    make-before-break steps equal JAX's, and no step serves a segment
    from fewer replicas than it had."""
    rng = np.random.default_rng(seed)
    servers = [f"s{i}" for i in range(int(rng.integers(2, 6)))]
    current = {}
    for k in range(int(rng.integers(3, 12))):
        reps = rng.choice(servers[:-1] or servers, size=min(
            2, len(servers) - 1 or 1), replace=False)
        state = "CONSUMING" if k == 0 and seed % 2 else "ONLINE"
        current[f"seg_{k}"] = {str(r): state for r in reps}
    groups = ([servers[::2], servers[1::2]] if seed == 3 else None)
    jt = jassign.compute_target_assignment(current, servers, 2, groups=groups)
    tt = tassign.compute_target_assignment(current, servers, 2, groups=groups)
    assert tt == jt
    steps = tassign.rebalance_steps(current, tt)
    assert steps == jassign.rebalance_steps(current, jt)
    for step in steps:
        for seg, m in current.items():
            assert len(step[seg]) >= min(len(m), len(tt[seg]))
    assert not steps or steps[-1] == tt
    assert tassign.rebalance_steps(tt, tt) == []


def test_rebalance_table_after_adding_server():
    j, t = _controllers(1)
    for c, mod, dmod, md in ((j, jtable, jdata, _j_md),
                             (t, ttable, tdata, _t_md)):
        c.add_schema(_schema(dmod))
        c.add_table(_cfg(mod))
        for i in range(4):
            c.add_segment("events_OFFLINE", md(f"events_{i}"), "loc")
    for c, info in ((j, JInstance), (t, InstanceInfo)):
        assert all(list(m) == ["server_0"] for m in
                   c.store.get_ideal_state("events_OFFLINE").values())
        c.register_instance(info("server_1", "SERVER"))
    dry = [c.rebalance_table("events_OFFLINE", dry_run=True) for c in (j, t)]
    assert dry[0] == dry[1] and len(dry[1]) == 2
    steps = [c.rebalance_table("events_OFFLINE", convergence_timeout_s=0.1)
             for c in (j, t)]
    assert steps[0] == steps[1]
    after = [c.store.get_ideal_state("events_OFFLINE") for c in (j, t)]
    assert after[0] == after[1]
    per_server = {}
    for m in after[1].values():
        for inst in m:
            per_server[inst] = per_server.get(inst, 0) + 1
    assert per_server == {"server_0": 2, "server_1": 2}
    with pytest.raises(RuntimeError):
        t.register_instance(InstanceInfo("server_2", "SERVER"))
        t.rebalance_table("events_OFFLINE", convergence_timeout_s=0.05,
                          best_effort=False)


def test_periodic_loop_runs_and_stop_joins():
    _j, t = _controllers(1)
    t.add_schema(_schema(tdata))
    t.add_table(_cfg(ttable, retention_time_unit="DAYS",
                     retention_time_value=1))
    t.add_segment("events_OFFLINE", _t_md("ancient", 0, 1), "loc")
    t.start_periodic_tasks(interval_s=0.01)
    t.start_periodic_tasks(interval_s=0.01)     # once only
    deadline = time.monotonic() + 10
    while t.store.segment_names("events_OFFLINE"):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    t.stop()
    assert not [th for th in threading.enumerate()
                if th.name == "controller-periodic" and th.is_alive()]
    t.stop()    # idempotent


def _cluster(tmp_path, servers=2, replication=1, tiers=None):
    c = EmbeddedCluster(num_servers=servers, device="cpu",
                        data_dir=str(tmp_path))
    cfg = _cfg(ttable, replication=replication)
    cfg.tier_configs = tiers or []
    c.create_table(cfg, _schema(tdata))
    rng = np.random.default_rng(3)
    for i in range(4):
        c.ingest_rows("events_OFFLINE", _schema(tdata), {
            "user": [f"u{x}" for x in rng.integers(0, 5, 200)],
            "value": rng.integers(0, 100, 200).tolist(),
            "ts": list(range(i * 1000, i * 1000 + 200))},
            segment_name=f"seg_{i}")
    assert c.wait_for_ev_converged("events_OFFLINE")
    return c


def _staged(cluster):
    """Each server's staged segments once its prefetches have landed."""
    out = {}
    for sid, srv in cluster.servers.items():
        srv.executor.residency.drain_prefetch()
        out[sid] = sorted(n for n in srv.executor.residency._entries)
    return out


def _hosted(cluster):
    return {sid: srv.hosted_segments("events_OFFLINE")
            for sid, srv in cluster.servers.items()}


def test_cluster_rebalance_moves_staged_segments(tmp_path):
    c = _cluster(tmp_path)
    try:
        want = c.query_rows("SELECT count(*), sum(value) FROM events")
        before = _staged(c)
        assert before == _hosted(c)
        c.add_server("server_2")
        c.add_server("server_3")
        steps = c.controller.rebalance_table("events_OFFLINE",
                                             convergence_timeout_s=10)
        assert len(steps) == 2
        assert c.wait_for_ev_converged("events_OFFLINE")
        after = _staged(c)
        assert after == _hosted(c)
        assert all(len(v) == 1 for v in after.values())
        assert sorted(sum(after.values(), [])) == [f"seg_{i}"
                                                   for i in range(4)]
        assert c.query_rows("SELECT count(*), sum(value) FROM events") == want
        assert c.controller.run_segment_status_check()["events_OFFLINE"][
            "replicasMissing"] == 0
    finally:
        c.shutdown()


def test_cluster_relocation_to_tagged_server(tmp_path):
    tiers = [{"name": "cold", "segmentAge": "1d", "serverTag": "cold",
              "segmentSelectorType": "time"}]
    c = _cluster(tmp_path, tiers=tiers)
    try:
        want = c.query_rows("SELECT count(*), sum(value) FROM events")
        c.add_server("server_cold")
        c.controller.update_instance_tags("server_cold", ["cold"])
        now = int(time.time() * 1000)
        assert c.controller.run_segment_relocation(now_ms=now) == []
        moved = c.controller.run_segment_relocation(now_ms=now + 2 * DAY)
        assert sorted(moved) == [f"seg_{i}" for i in range(4)]
        assert c.wait_for_ev_converged("events_OFFLINE")
        staged = _staged(c)
        assert staged["server_cold"] == [f"seg_{i}" for i in range(4)]
        assert staged["server_0"] == staged["server_1"] == []
        assert c.query_rows("SELECT count(*), sum(value) FROM events") == want
        assert c.controller.run_segment_relocation(now_ms=now + 2 * DAY) == []
    finally:
        c.shutdown()


def test_cluster_shutdown_stops_periodic_loop(tmp_path):
    c = _cluster(tmp_path)
    c.controller.start_periodic_tasks(interval_s=0.01)
    c.add_minion()
    time.sleep(0.05)
    c.shutdown()
    assert not [th for th in threading.enumerate() if th.is_alive()
                and th.name.startswith(("controller-periodic", "minion-"))]
