"""Realtime tables in the port's embedded cluster
(``pinot_tpu_torch/tools/cluster.py``: the LLC manager, the completion FSM,
servers consuming with their own threads, the seal swap) against the JAX
``EmbeddedCluster``.

tests/test_cluster.py ``TestRealtimeCluster::test_realtime_ingest_and_query``
on both packages (2 servers, 1000 rows on 2 partitions, a flush at 400
rows): the rows of three query shapes equal to pandas and to the JAX
cluster's, and the ONLINE and CONSUMING segments with their offsets equal.
Also, in the port: replication 2, where each sealed segment has one
committer and one KEEP replica that seals its own rows, and both answer
alike when asked directly; deleting the table empties the deep store; the
seal swap under 4 query threads with the commit held at a gate until a
query has seen the consuming view, so both views are seen by
construction; unassignment stopping a consumer, and no consumer thread
outliving ``shutdown``.

Each package reads its own ``MemoryStream`` topic. Counts, integer sums
and keys are exact; float cells within ``rel=1e-5, abs=1e-6``. Every wait
is bounded, and no assertion depends on how long anything took.
"""

import sys
import threading
import time

import pytest

import tests.test_cluster as tc
from pinot_tpu.controller.state import ONLINE as J_ONLINE
from pinot_tpu.ingestion import MemoryStream as JStream
from pinot_tpu.spi import table as jtable
from pinot_tpu.tools.cluster import EmbeddedCluster as JCluster
from pinot_tpu_torch.engine.mutable_staging import resident_name
from pinot_tpu_torch.ingestion import MemoryStream as TStream
from pinot_tpu_torch.ingestion.realtime import (
    CompletionReply,
    CompletionResponse,
    ConsumerState,
)
from pinot_tpu_torch.query import compile_query
from pinot_tpu_torch.spi import data as tdata
from pinot_tpu_torch.spi import table as ttable
from pinot_tpu_torch.tools.cluster import EmbeddedCluster
from tests.test_torch_cluster import _rows_equal

SEED = "20260801T0000Z"
SQLS = {
    "region": "SELECT region, sum(qty) FROM rtsales GROUP BY region "
              "ORDER BY region LIMIT 50",
    "kind": "SELECT kind, count(*), min(qty), max(price), sum(price) "
            "FROM rtsales WHERE qty > 10 GROUP BY kind ORDER BY kind "
            "LIMIT 50",
    "scalar": "SELECT count(*), sum(qty), max(ts) FROM rtsales",
}


def _schema(name="rtsales"):
    return tdata.Schema(name, [
        tdata.FieldSpec("region", tdata.DataType.STRING),
        tdata.FieldSpec("kind", tdata.DataType.STRING),
        tdata.FieldSpec("qty", tdata.DataType.LONG, tdata.FieldType.METRIC),
        tdata.FieldSpec("price", tdata.DataType.DOUBLE,
                        tdata.FieldType.METRIC),
        tdata.FieldSpec("ts", tdata.DataType.LONG,
                        tdata.FieldType.DATE_TIME)])


def _config(mod, topic, flush, replication=1, name="rtsales"):
    return mod.TableConfig(
        name, mod.TableType.REALTIME,
        validation_config=mod.SegmentsValidationConfig(
            time_column_name="ts", replication=replication),
        stream_config=mod.StreamIngestionConfig(
            stream_type="memory", topic=topic,
            segment_flush_threshold_rows=flush))


def _pandas(df, key):
    if key == "region":
        return [[k, float(v)] for k, v in
                df.groupby("region").qty.sum().sort_index().items()]
    if key == "kind":
        g = df[df.qty > 10].groupby("kind")
        return [[k, int(len(p)), float(p.qty.min()), float(p.price.max()),
                 float(p.price.sum())] for k, p in sorted(g)]
    return [[len(df), float(df.qty.sum()), float(df.ts.max())]]


def _until(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _segments(store, table):
    return {md.segment_name: (md.status, md.start_offset, md.end_offset)
            for md in store.segment_metadata_list(table)}


def _close(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-5, abs=1e-6), (what, g, w)
            else:
                assert a == b, (what, g, w)


def test_realtime_ingest_and_query(tmp_path):
    df = tc.make_df(1000, seed=33)
    JStream.create("rt_sales_j", 2)
    TStream.create("rt_sales_t", 2)
    jc = JCluster(num_servers=2, data_dir=str(tmp_path), llc_seed=SEED)
    pc = EmbeddedCluster(num_servers=2, device="cpu", llc_seed=SEED)
    try:
        jc.create_table(_config(jtable, "rt_sales_j", 400),
                        tc.make_schema("rtsales"))
        pc.create_table(_config(ttable, "rt_sales_t", 400), _schema())
        js, ts = JStream.get("rt_sales_j"), TStream.get("rt_sales_t")
        for i, r in enumerate(df.to_dict("records")):
            js.produce(r, partition=i % 2)
            ts.produce(r, partition=i % 2)
        assert pc.wait_for_docs("rtsales", 1000)
        assert pc.wait_for_consumers("rtsales_REALTIME")
        assert jc.wait_for_docs("rtsales", 1000)
        # the JAX seals land after its count: wait for both ONLINE
        assert _until(lambda: sum(
            m.status == J_ONLINE for m in
            jc.store.segment_metadata_list("rtsales_REALTIME")) == 2)
        assert jc.wait_for_ev_converged("rtsales_REALTIME", timeout_s=60)
        segs = _segments(pc.store, "rtsales_REALTIME")
        assert segs == _segments(jc.store, "rtsales_REALTIME")
        assert sorted(v for v in segs.values()) == [
            ("CONSUMING", "400", None), ("CONSUMING", "400", None),
            ("ONLINE", "0", "400"), ("ONLINE", "0", "400")]
        assert pc.store.get_ideal_state("rtsales_REALTIME") == \
            jc.store.get_ideal_state("rtsales_REALTIME")
        for key, sql in SQLS.items():
            t, j = pc.query(sql), jc.query(sql)
            assert not t.exceptions and not j.exceptions, key
            _rows_equal(t.result_table.rows, j.result_table.rows, key)
            _close(t.result_table.rows, _pandas(df, key), key)
            assert t.num_servers_responded == t.num_servers_queried
    finally:
        jc.shutdown()
        pc.shutdown()
        JStream.delete("rt_sales_j")
        TStream.delete("rt_sales_t")


def test_replicas_commit_once_and_keep_once():
    """Replication 2 on 2 servers: each sealed segment has one committer
    (its hosted object is the deep store's) and one KEEP replica (its own
    seal of the same rows); asked directly, both answer alike."""
    df = tc.make_df(1000, seed=34)
    TStream.create("rt_rep", 2)
    pc = EmbeddedCluster(num_servers=2, device="cpu", llc_seed=SEED)
    table = "rtsales_REALTIME"
    try:
        pc.create_table(_config(ttable, "rt_rep", 200, replication=2),
                        _schema())
        stream = TStream.get("rt_rep")
        for i, r in enumerate(df.to_dict("records")):
            stream.produce(r, partition=i % 2)
        assert pc.wait_for_consumers(table)
        online = sorted(s for s, (st, _, _) in
                        _segments(pc.store, table).items() if st == "ONLINE")
        assert len(online) == 4     # 500 rows a partition, 2 seals each
        for seg in online:
            kept = pc.controller.deep_store.fetch_segment(
                f"memory://{table}/{seg}")
            objs = [pc.servers[s].data_manager.get(table)._segments[
                seg].segment for s in ("server_0", "server_1")]
            assert sum(o is kept for o in objs) == 1, seg
            assert objs[0].num_docs == objs[1].num_docs == 200
        for s in pc.servers.values():
            tdm = s.data_manager.get(table)
            assert tdm.seal_decisions == {
                "seal:consuming_segment->immutable_swap:seal_swap": 4}
            assert {e["segment"] for e in tdm.seals} == set(online)
        for key, sql in SQLS.items():
            ctx = compile_query(sql)
            tables = [pc.servers[s].execute_query(ctx, table, online)
                      for s in ("server_0", "server_1")]
            rows = [pc.broker.reduce_service.reduce(ctx, [dt])[0].rows
                    for dt in tables]
            assert rows[0] == rows[1], key
            sealed = df[[i % 2 == p and i // 2 < 400
                         for i, p in zip(range(1000), [0, 1] * 500)]]
            _close(rows[0], _pandas(sealed, key), key)
            resp = pc.query(sql)
            _close(resp.result_table.rows, _pandas(df, key), key)
        assert len(pc.controller.deep_store) == 4
        pc.controller.delete_table(table)
        assert len(pc.controller.deep_store) == 0
        assert _until(lambda: not pc.consumers(table))
    finally:
        pc.shutdown()
        TStream.delete("rt_rep")


class _Gate:
    """The cluster's completion FSM behind a gate: a replica that reached
    its flush threshold HOLDs until the gate opens."""

    def __init__(self, inner):
        self.inner = inner
        self.open = threading.Event()

    def segment_consumed(self, segment_name, instance, offset):
        if not self.open.is_set():
            return CompletionReply(CompletionResponse.HOLD)
        return self.inner.segment_consumed(segment_name, instance, offset)

    def __getattr__(self, name):
        return getattr(self.inner, name)


HAMMER_ROWS = 400
HAMMER_SQL = ("SELECT region, count(*), sum(qty), max(price) FROM rtsales "
              "GROUP BY region ORDER BY region LIMIT 100")


def test_seal_swap_under_queries():
    df = tc.make_df(HAMMER_ROWS, seed=35)
    want = [[k, int(len(p)), float(p.qty.sum()), float(p.price.max())]
            for k, p in sorted(df.groupby("region"))]
    TStream.create("rt_hammer", 1)
    pc = EmbeddedCluster(num_servers=1, device="cpu", llc_seed=SEED)
    server = pc.servers["server_0"]
    gate = _Gate(pc.controller.completion)
    server.completion_protocol = gate
    table = "rtsales_REALTIME"
    first = f"rtsales__0__0__{SEED}"
    try:
        pc.create_table(_config(ttable, "rt_hammer", HAMMER_ROWS), _schema())
        stream = TStream.get("rt_hammer")
        for r in df.to_dict("records"):
            stream.produce(r, partition=0)
        tdm = server.data_manager.get(table)
        assert _until(lambda: (tdm.consuming_manager(first) is not None
                               and tdm.consuming_manager(first).state
                               is ConsumerState.HOLDING))
        acquired = []
        real_acquire = tdm.acquire_segments

        def acquire(names=None):
            got = real_acquire(names)
            acquired.append([h.segment for h in got
                             if h.segment_name == first])
            return got

        tdm.acquire_segments = acquire
        # the consuming view, by construction: the commit is held
        resp = pc.query(HAMMER_SQL)
        _close(resp.result_table.rows, want, "consuming")
        assert [s.is_mutable for s in acquired[-1]] == [True]

        stop = threading.Event()
        answers, errors = [], []

        def client():
            try:
                while not stop.is_set():
                    r = pc.query(HAMMER_SQL)
                    answers.append((r.exceptions, r.result_table.rows
                                    if r.result_table else None,
                                    r.num_servers_responded))
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(4)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)     # more thread switches in the swap
        for t in threads:
            t.start()
        try:
            gate.open.set()
            assert pc.wait_for_consumers(table)
            # the sealed view, by construction: the commit is done
            resp = pc.query(HAMMER_SQL)
            _close(resp.result_table.rows, want, "sealed")
            assert [getattr(s, "is_mutable", False)
                    for s in acquired[-1]] == [False]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
        assert not errors and answers
        for exceptions, rows, responded in answers:
            assert not exceptions and responded == 1
            _close(rows, want, "hammer")
        # every acquire saw exactly one view of the segment
        assert all(len(a) == 1 for a in acquired)
        assert {getattr(a[0], "is_mutable", False) for a in acquired} == \
            {True, False}
        residency = server.executor.residency
        assert resident_name(first) not in residency.resident_names()
        assert all(e["pins"] == 0 for e in
                   residency.snapshot()["stagedSegments"].values())
        assert tdm.seal_decisions == {
            "seal:consuming_segment->immutable_swap:seal_swap": 1}
    finally:
        pc.shutdown()
        TStream.delete("rt_hammer")


def _consumer_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("consumer-") and t.is_alive()]


def test_unassignment_stops_the_consumer_and_shutdown_leaves_none():
    TStream.create("rt_unassign", 2)
    pc = EmbeddedCluster(num_servers=2, device="cpu", llc_seed=SEED)
    table = "rtsales_REALTIME"
    try:
        pc.create_table(_config(ttable, "rt_unassign", 1000, replication=2),
                        _schema())
        stream = TStream.get("rt_unassign")
        for i, r in enumerate(tc.make_df(60, seed=36).to_dict("records")):
            stream.produce(r, partition=i % 2)
        assert pc.wait_for_consumers(table)
        assert len(_consumer_threads()) == 4
        victim = f"rtsales__1__0__{SEED}"
        pc.controller.delete_segment(table, victim)
        assert _until(lambda: all(
            c.segment_name != victim for c in pc.consumers(table)))
        assert f"consumer-{victim}" not in _consumer_threads()
        assert len(_consumer_threads()) == 2
        assert pc.query_rows("SELECT count(*) FROM rtsales") == [[30]]
        # validation recreates the partition's consuming segment, which
        # reads the partition again from its start
        assert pc.controller.run_realtime_validation() == [victim]
        assert pc.wait_for_consumers(table)
        assert pc.query_rows("SELECT count(*) FROM rtsales") == [[60]]
    finally:
        pc.shutdown()
        TStream.delete("rt_unassign")
    assert _consumer_threads() == []


def test_chip_smoke_phase_17_small():
    """Phase 17 on the CPU: 8000 + 1600 user-events rows on 2 partitions
    (flush 1600), 3000 realtime SSB rows beside 48 k offline rows in 8
    segments (flush 2000), a 2200-row upsert table (flush 500); every
    check of the phase held (the plain version counts no launch)."""
    import chip_smoke
    from pinot_tpu_torch.engine.pruner import prune_segments
    from pinot_tpu_torch.tools import ssb

    segs, frames = ssb.build_segments(0, num_segments=8, seed=3,
                                      rows=48_000)
    ctxs = {q: compile_query(t + " LIMIT 100000")
            for q, t in ssb.QUERIES.items()}
    parts = {q: [ssb.numpy_answer(f, q) for f in frames] for q in ctxs}
    main = {"segs": segs, "ctxs": ctxs, "parts": parts, "seed": 3,
            "kept": {q: len(prune_segments(c, segs))
                     for q, c in ctxs.items()}}
    run = chip_smoke.phase_realtime_cluster(
        main, reps=1, device="cpu", user_rows=8000, user_flush=1600,
        more_rows=800, ssb_rows=3000, ssb_flush=2000, upsert_rows=2200,
        upsert_flush=500, seed=5)
    users = run["users"]
    assert users["segments"] == {"ONLINE": 4, "CONSUMING": 2}
    assert users["seals"]["replies"] == {"COMMIT": 4, "KEEP": 4,
                                         "DISCARD_OR_FETCH": 0}
    assert users["deep_store_entries"] == 4
    assert run["seals_under_queries"]["segments"]["ONLINE"] == 6
    assert run["hybrid"]["boundary"] == 199811
    assert run["hybrid"]["sealed_segments"] == 1
    assert run["upsert"]["segments"] == {"ONLINE": 4, "CONSUMING": 1}
    assert run["launches"] == {"fused_scan": 0, "fused_scan_probe": 0}
    assert run["timing"] == []
    assert _consumer_threads() == []
