"""Per-query launch counts under concurrency (the repair of the
process-wide counts).

A query counts every launch that served it, whether it led the launch or
rode it (``engine/results.py`` ``count_launches_into`` /
``shared_launch``), so the oracle is the query's own solo counts: two
servers' queries at once in one process, one server under 8 SEWF runner
threads, riders of a ``kernel_flight`` launch, and requests the launcher
dedups or batches into one launch must each count exactly what they count
alone. On the CPU the fused scan runs its plain version and counts
nothing, so the fused-scan cases count each plain run as a launch
(``plain_counts``); the general rung and the jnp combine count on any
device. Segments are built with the port's SSB generator, small.
"""

import sys
import threading
import time

import pytest

from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.engine import fused_scan
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.engine.results import QueryStats
from pinot_tpu_torch.parallel import combine
from pinot_tpu_torch.parallel.executor import ShardedQueryExecutor
from pinot_tpu_torch.parallel.launcher import LaunchKernel
from pinot_tpu_torch.query import compile_query
from pinot_tpu_torch.tools import ssb

FLIGHTS = ("Q1.1", "Q2.1", "Q3.2", "Q4.1")


def _counts(stats: QueryStats) -> dict:
    return stats.launch_counts()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    yield
    TELEMETRY.reset()       # stops the sampler a server's gauges started


@pytest.fixture(scope="module")
def segs():
    return ssb.build_segments(0, num_segments=4, seed=5, rows=16_000)[0]


@pytest.fixture
def plain_counts(monkeypatch):
    """The fused scan's plain version counted as a launch on the CPU (its
    counter's ``add`` where the kernel would launch)."""
    real, real_many = fused_scan.counted_scan, fused_scan.counted_scan_many

    def counted(prog, packed, values, num_docs, counter, tiles=None):
        out = real(prog, packed, values, num_docs, counter, tiles)
        counter.add()
        return out

    def counted_many(progs, packed, values, num_docs, counter, tiles=None):
        out = real_many(progs, packed, values, num_docs, counter, tiles)
        counter.add()
        return out

    monkeypatch.setattr(fused_scan, "counted_scan", counted)
    monkeypatch.setattr(fused_scan, "counted_scan_many", counted_many)
    monkeypatch.setattr(combine, "counted_scan", counted)
    monkeypatch.setattr(combine, "counted_scan_many", counted_many)


def _together(jobs, rounds: int = 4) -> list:
    """Each ``job()`` ``rounds`` times on its own thread, all released at
    once. -> (job index, result) in completion order."""
    start = threading.Barrier(len(jobs))
    out, errors = [], []
    lock = threading.Lock()

    def run(i, job):
        try:
            start.wait(10)
            for _ in range(rounds):
                got = job()
                with lock:
                    out.append((i, got))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, j))
               for i, j in enumerate(jobs)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)     # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_two_servers_at_once_count_their_solo_launches(segs, plain_counts,
                                                       fused):
    """Two executors (two servers of one process), each over half the
    segments, queried at once from 8 threads: every query's counts equal
    its solo counts (the process-wide delta counted the other server's
    launches too)."""
    servers = [ServerQueryExecutor(device="cpu", use_fused_scan=fused)
               for _ in range(2)]
    halves = [segs[:2], segs[2:]]
    ctxs = {q: compile_query(ssb.QUERIES[q]) for q in FLIGHTS}
    solo = {(i, q): _counts(servers[i].execute(ctx, halves[i])[1])
            for i in range(2) for q, ctx in ctxs.items()}
    assert any(sum(c.values()) for c in solo.values())
    jobs = []
    for i in range(2):
        for q, ctx in ctxs.items():
            def job(i=i, q=q, ctx=ctx):
                # a context compiled per call: no query flight shares it
                got = servers[i].execute_instance(compile_query(ctx.sql),
                                                  halves[i])
                return (i, q), _counts(got.stats)
            jobs.append(job)
    for _, (key, counts) in _together(jobs):
        assert counts == solo[key], key


def test_one_server_under_eight_sewf_runners(segs):
    """One server's 8 SEWF runner threads run C1-C8 at once: each query's
    general-rung calls equal its solo calls."""
    from pinot_tpu_torch.controller.state import ClusterStateStore
    from pinot_tpu_torch.server.server import ServerInstance
    from pinot_tpu_torch.spi.filesystem import MemoryDeepStore

    srv = ServerInstance(
        "server_0", ClusterStateStore(), MemoryDeepStore(),
        executor=ServerQueryExecutor(device="cpu", use_fused_scan=False))
    assert srv.scheduler.stats_snapshot()["policy"] == "SewfScheduler"
    tdm = srv.data_manager.get_or_create(ssb.TABLE + "_OFFLINE")
    for s in segs:
        tdm.add_segment(s)
    srv._queries_enabled = True
    try:
        sqls = dict(ssb.COALESCE_QUERIES)
        table = ssb.TABLE + "_OFFLINE"
        solo = {c: _counts(srv.execute_query(compile_query(sql),
                                             table).stats)
                for c, sql in sqls.items()}
        assert all(c["general_launches"] == len(segs)
                   for c in solo.values())
        jobs = [lambda c=c, sql=sql: (c, _counts(srv.execute_query(
            compile_query(sql), table).stats)) for c, sql in sqls.items()]
        for _, (c, counts) in _together(jobs, rounds=3):
            assert counts == solo[c], c
    finally:
        srv.shutdown()


def test_kernel_flight_riders_count_the_launch(segs, monkeypatch):
    """Identical queries that ride one general-rung run through the
    executor's kernel flight each count its launch: their counts equal
    the solo count, and the flight really was shared."""
    ex = ServerQueryExecutor(device="cpu", use_fused_scan=False)
    ctx = compile_query(ssb.QUERIES["Q2.1"])
    seg = [segs[0]]
    solo = _counts(ex.execute_instance(ctx, seg).stats)
    assert solo["general_launches"] == 1
    riders = 5
    real = ex._run_general
    h0 = ex.kernel_flight.hits

    def gated(plan, staged):
        deadline = time.monotonic() + 10
        while ex.kernel_flight.hits - h0 < riders - 1 \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        return real(plan, staged)

    monkeypatch.setattr(ex, "_run_general", gated)
    got = _together([lambda: _counts(ex.execute_instance(ctx, seg).stats)
                     for _ in range(riders)], rounds=1)
    assert ex.kernel_flight.hits - h0 == riders - 1
    assert [c for _, c in got] == [solo] * riders


def _hold_dispatcher(ex):
    """Block the executor's launch dispatcher on a request of its own, so
    the next requests pile up and drain together. -> release(). Returns
    once the dispatcher runs the blocker: until then it could drain the
    blocker with the first few requests and leave the rest for later."""
    ev, running = threading.Event(), threading.Event()

    def hold(_p, _n):
        running.set()
        return ev.wait(10)

    blocker = LaunchKernel(("hold",), hold)
    req = ex.launcher.submit(blocker, None, None)
    assert running.wait(10)

    def release():
        ev.set()
        req.result(10)

    return release


@pytest.mark.parametrize("fused", [False, True])
def test_launcher_shared_launch_counts_for_every_rider(segs, plain_counts,
                                                       fused):
    """Requests the launcher serves with one launch: identical queries
    deduped onto one jnp-combine call, or C1-C8 batched into one
    query-axis launch of the fused scan. Each query counts that launch
    once: its solo counts."""
    ex = ShardedQueryExecutor(device="cpu", use_fused_scan=fused)
    sqls = (dict(ssb.COALESCE_QUERIES) if fused
            else {f"r{i}": ssb.QUERIES["Q2.1"] for i in range(6)})
    ctxs = {k: compile_query(sql) for k, sql in sqls.items()}
    solo = {k: _counts(ex.execute_instance(ctx, segs).stats)
            for k, ctx in ctxs.items()}
    field = "sharded_scan_launches" if fused else "batch_general_launches"
    assert all(c[field] == 1 for c in solo.values())
    release = _hold_dispatcher(ex)
    pending0 = ex.launcher._pending
    outs = []

    def query(k):
        outs.append((k, ex.execute_instance(ctxs[k], segs).stats))

    threads = [threading.Thread(target=query, args=(k,)) for k in ctxs]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while ex.launcher._pending < pending0 + len(ctxs) \
            and time.monotonic() < deadline:
        time.sleep(0.002)
    release()
    for t in threads:
        t.join(30)
    assert len(outs) == len(ctxs)
    assert max(st.launch["batchSize"] for _, st in outs) == len(ctxs)
    for k, st in outs:
        assert _counts(st) == solo[k], k
