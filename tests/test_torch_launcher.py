"""The port's launch scheduler (``pinot_tpu_torch/parallel/launcher.py``)
against ``tests/test_launcher.py``'s cases, and the batch executor's
coalesced launches against the JAX executor's rows.

The scheduler cases run the port's ``LaunchScheduler`` with fake kernels
(deterministic coalescing: a blocker request parks the dispatcher while
the batch piles up). The executor cases run ``ShardedQueryExecutor(
device="cpu")``, whose launches go through the same scheduler and whose
query-axis kernel runs its plain version here, on segments carried from
the JAX SegmentBuilder; rows are held to the JAX executor's. Tolerance: counts,
integer sums and keys exact; float cells rel 1e-5, abs 1e-6 (the JAX
kernel sums floats as f32 pairs, the port in f64). The column borrower,
the worker pool and ``/debug/launches`` belong to later work and are not
ported here.
"""

import threading
import time

import numpy as np
import pytest

from pinot_tpu.engine import ServerQueryExecutor as JExecutor
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.segment import SegmentBuilder, load_segment
from pinot_tpu.spi import DataType, FieldSpec, FieldType, IndexingConfig, Schema
from pinot_tpu_torch.engine import fused_scan
from pinot_tpu_torch.engine.plan import plan_segment
from pinot_tpu_torch.engine.results import QueryStats
from pinot_tpu_torch.parallel import ShardedQueryExecutor
from pinot_tpu_torch.parallel.combine import (
    sharded_fused_scan_many,
    sharded_fused_scan_many_plain,
    sharded_fused_scan_probe_many,
)
from pinot_tpu_torch.parallel.launcher import (
    LaunchKernel,
    LaunchScheduler,
    launcher_for_device,
)
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.segment import columns_of, segment_from_arrays
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration

RNG = np.random.default_rng(23)
NUM_SEGMENTS = 4
DOCS = 1024


def _schema():
    return Schema("sales", [
        FieldSpec("region", DataType.STRING),
        FieldSpec("kind", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("raw_amt", DataType.LONG, FieldType.METRIC),
    ])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_launcher_segs")
    regions = ["east", "west", "north", "south"]
    kinds = ["a", "b", "c"]
    jsegs = []
    for i in range(NUM_SEGMENTS):
        frame = {
            "region": [regions[j] for j in RNG.integers(0, 4, DOCS)],
            "kind": [kinds[j] for j in RNG.integers(0, 3, DOCS)],
            "year": RNG.integers(2015, 2024, DOCS).astype(np.int64).tolist(),
            "qty": RNG.integers(1, 50, DOCS).astype(np.int64).tolist(),
            "price": np.round(RNG.normal(100, 25, DOCS), 2).tolist(),
            "raw_amt": RNG.integers(0, 10_000, DOCS).astype(
                np.int64).tolist(),
        }
        SegmentBuilder(
            _schema(), f"sales_{i}",
            indexing_config=IndexingConfig(no_dictionary_columns=["raw_amt"])
        ).build(frame, str(out))
        jsegs.append(load_segment(str(out / f"sales_{i}")))
    tsegs = [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                 table_name="sales") for j in jsegs]
    return jsegs, tsegs


def _assert_rows(got, want):
    assert len(got) == len(want)
    for gr, wr in zip(got, want):
        assert len(gr) == len(wr)
        for g, w in zip(gr, wr):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-5, abs=1e-6), (gr, wr)
            else:
                assert g == w, (gr, wr)


# --------------------------------------------------------------------------
# the scheduler with fake kernels
# --------------------------------------------------------------------------

def _park(sched):
    """(the blocker's request, release): a launch that holds the
    dispatcher until released, running before this returns, so every
    request submitted after it piles up behind it."""
    gate, entered = threading.Event(), threading.Event()

    def call(params, num_docs):
        entered.set()
        gate.wait(20)
        return params

    req = sched.submit(LaunchKernel(("blocker",), call, max_batch=1), 0, 0)
    assert entered.wait(20), "the dispatcher never ran the blocker"
    return req, gate


def test_dedup_identical_params():
    sched = LaunchScheduler(name="t-dedup")
    calls = []

    def counted(params, num_docs):
        calls.append(params)
        return ("out", params)

    kern = LaunchKernel(("k1",), counted, max_batch=8)
    b, gate = _park(sched)
    params = ("p",)
    reqs = [sched.submit(kern, params, 7) for _ in range(3)]
    gate.set()
    assert b.result(30) == 0
    assert [r.result(30) for r in reqs] == [("out", params)] * 3
    assert len(calls) == 1, "identical params must share one launch"
    assert all(r.batch_size == 3 and r.launches_saved == 2 and r.deduped
               for r in reqs)
    snap = sched.stats_snapshot()
    assert snap["dedupedRequests"] >= 2
    assert snap["coalescedLaunches"] >= 1
    sched.close()


def test_distinct_params_ride_one_many_launch():
    sched = LaunchScheduler(name="t-batch")
    launches = []

    def many(params_list, num_docs):
        launches.append(len(params_list))
        return [p * num_docs for p in params_list]

    kern = LaunchKernel(("k2",), lambda p, nd: p * nd, many=many,
                        max_batch=8)
    b, gate = _park(sched)
    reqs = [sched.submit(kern, v, 3) for v in (1.0, 2.0, 5.0)]
    gate.set()
    b.result(30)
    assert [r.result(30) for r in reqs] == [3.0, 6.0, 15.0]
    assert launches == [3], "one launch serves the whole group"
    assert all(r.batch_size == 3 and r.launches_saved == 2 for r in reqs)
    snap = sched.stats_snapshot()
    assert snap["launchesSaved"] >= 2 and snap["batchedRequests"] >= 3
    sched.close()


def test_max_batch_chunks_and_no_many_runs_serially():
    """Past ``max_batch`` the group takes several launches; a kernel
    without a ``many`` form (the jnp combine) runs its distinct parameter
    sets one after another, identical ones still shared."""
    sched = LaunchScheduler(name="t-chunks")
    chunks, solo = [], []

    def many(params_list, num_docs):
        chunks.append(list(params_list))
        return list(params_list)

    def one(p, nd):
        solo.append(p)
        return p

    kern = LaunchKernel(("k3",), one, many=many, max_batch=2)
    serial = LaunchKernel(("k3s",), one, max_batch=8)
    b, gate = _park(sched)
    reqs = [sched.submit(kern, v, 0) for v in (1, 2, 3)]
    same = ("x",)
    sreqs = [sched.submit(serial, p, 0) for p in (same, same, ("y",))]
    gate.set()
    b.result(30)
    assert [r.result(30) for r in reqs] == [1, 2, 3]
    assert chunks == [[1, 2]] and solo[0] == 3
    assert all(r.launches_saved == 1 for r in reqs)
    assert [r.result(30) for r in sreqs] == [same, same, ("y",)]
    assert solo[1:] == [same, ("y",)]
    assert all(r.batch_size == 3 and r.launches_saved == 1 for r in sreqs)
    sched.close()


def test_launch_errors_reach_every_rider():
    sched = LaunchScheduler(name="t-err")

    def boom(params, num_docs):
        raise RuntimeError("kernel exploded")

    kern = LaunchKernel(("k4",), boom, max_batch=4)
    b, gate = _park(sched)
    params = ("same",)
    reqs = [sched.submit(kern, params, 0) for _ in range(2)]
    gate.set()
    b.result(30)
    for r in reqs:
        with pytest.raises(RuntimeError, match="kernel exploded"):
            r.result(30)
    assert sched.stats_snapshot()["failures"] >= 1
    sched.close()


def test_failed_many_launch_raises_with_no_serial_retry():
    """A failed batched launch raises in every query that rode it: there
    is no fallback to solo launches (which would hide a failed kernel)."""
    sched = LaunchScheduler(name="t-no-fallback")
    solo = []

    def many(params_list, num_docs):
        raise RuntimeError("batched launch failed")

    def one(p, nd):
        solo.append(p)
        return p

    kern = LaunchKernel(("k6",), one, many=many, max_batch=8)
    b, gate = _park(sched)
    reqs = [sched.submit(kern, v, 0) for v in (1, 2, 3)]
    gate.set()
    b.result(30)
    for r in reqs:
        with pytest.raises(RuntimeError, match="batched launch failed"):
            r.result(30)
    assert solo == [], "a failed batched launch must not be retried solo"
    assert kern.batchable
    assert sched.stats_snapshot()["failures"] == 3
    sched.close()


def test_dispatcher_crash_completes_waiters_and_recovers(monkeypatch):
    sched = LaunchScheduler(name="t-crash")
    orig = LaunchScheduler._launch_group
    crashed = []

    def flaky(self, reqs):
        if not crashed:
            crashed.append(True)
            raise RuntimeError("synthetic dispatcher bug")
        return orig(self, reqs)

    monkeypatch.setattr(LaunchScheduler, "_launch_group", flaky)
    kern = LaunchKernel(("k5",), lambda params, num_docs: params,
                        max_batch=1)
    req = sched.submit(kern, ("p1",), 0)
    with pytest.raises(RuntimeError, match="synthetic dispatcher bug"):
        req.result(30)
    assert sched.submit(kern, ("p2",), 0).result(30) == ("p2",)
    sched.close()


def test_window_gathers_stragglers_into_one_batch():
    sched = LaunchScheduler(name="t-window")
    sched.set_window(max_ms=250.0, hot_ms=float("inf"))
    with sched._cond:
        t = time.perf_counter()
        for i in range(5):
            sched._note_arrival_locked(t + i * 0.0005)
        sched._overlap_ewma = 1.0   # arrivals from several clients
    launches = []

    def many(params_list, num_docs):
        launches.append(len(params_list))
        return [p * num_docs for p in params_list]

    kern = LaunchKernel(("kw",), lambda p, nd: p * nd, many=many,
                        max_batch=8)
    r1 = sched.submit(kern, 2.0, 3)
    time.sleep(0.02)  # mid-window: joins r1's drain
    r2 = sched.submit(kern, 5.0, 3)
    assert r1.result(30) == 6.0 and r2.result(30) == 15.0
    assert r1.batch_size == 2 and r2.batch_size == 2
    assert launches == [2]
    snap = sched.stats_snapshot()
    assert snap["windowWaits"] >= 1 and snap["windowGathered"] >= 1
    assert sched.window_max_ms == 250.0
    sched.close()


def test_window_idle_traffic_pays_no_hold():
    sched = LaunchScheduler(name="t-window-idle")
    sched.set_window(max_ms=500.0, hot_ms=0.0)
    kern = LaunchKernel(("ki",), lambda params, num_docs: params,
                        max_batch=8)
    t0 = time.perf_counter()
    assert sched.submit(kern, ("p",), 0).result(30) == ("p",)
    assert (time.perf_counter() - t0) < 0.4
    assert sched.stats_snapshot()["windowWaits"] == 0
    sched.close()


def test_window_lone_client_pays_no_hold():
    """One client whose next request waits for its last never overlaps
    another pending request: however hot its arrivals, the dispatcher
    does not hold the window for stragglers that cannot come."""
    sched = LaunchScheduler(name="t-window-lone")
    sched.set_window(max_ms=200.0, hot_ms=float("inf"))
    kern = LaunchKernel(("kl",), lambda params, num_docs: params,
                        max_batch=8)
    t0 = time.perf_counter()
    for i in range(20):
        assert sched.submit(kern, i, 0).result(30) == i
    assert (time.perf_counter() - t0) < 2.0
    assert sched.stats_snapshot()["windowWaits"] == 0
    assert sched._pending == 0 and sched._overlap_ewma < 0.1
    sched.close()


def test_window_arrival_ewma_tracks_and_resets():
    sched = LaunchScheduler(name="t-ewma")
    sched.set_window(max_ms=1.0, hot_ms=2.0)
    with sched._cond:
        t = 100.0
        sched._note_arrival_locked(t)
        for _ in range(10):  # 1 ms apart: hot
            t += 0.001
            sched._note_arrival_locked(t)
        hot = sched._arrival_ewma_ms
        assert hot is not None and hot < 2.0
        t += 10.0  # a 10 s gap resets, it does not decay
        sched._note_arrival_locked(t)
        assert sched._arrival_ewma_ms > 2.0
    assert sched._window_hold_s(1) == 0.0


def test_window_and_batch_config_keys():
    cfg = PinotConfiguration({
        CommonConstants.LAUNCH_WINDOW_MS_KEY: 3.5,
        CommonConstants.LAUNCH_WINDOW_HOT_MS_KEY: 9.0,
        CommonConstants.LAUNCH_MAX_BATCH_KEY: 1}, use_env=False)
    dev = ShardedQueryExecutor(device="cpu", config=cfg)
    assert dev._launch_max_batch == 1
    assert dev.launcher is launcher_for_device("cpu")
    assert dev.launcher.window_max_ms == 3.5
    assert dev.launcher.window_hot_ms == 9.0
    # restore the device's shared dispatcher for the other tests
    dev.launcher.set_window(
        max_ms=CommonConstants.DEFAULT_LAUNCH_WINDOW_MS,
        hot_ms=CommonConstants.DEFAULT_LAUNCH_WINDOW_HOT_MS)


def test_launch_stats_merge():
    a = QueryStats()
    a.launch = {"launches": 1, "coalesced": 1, "batchSize": 3,
                "launchesSaved": 2, "queueWaitMs": 1.5}
    b = QueryStats()
    b.launch = {"launches": 1, "coalesced": 0, "batchSize": 1,
                "launchesSaved": 0, "queueWaitMs": 4.0}
    a.merge(b)
    assert a.launch == {"launches": 2, "coalesced": 1, "batchSize": 3,
                        "launchesSaved": 2, "queueWaitMs": 4.0}


# --------------------------------------------------------------------------
# the batch executor through the scheduler
# --------------------------------------------------------------------------

def test_uncontended_single_query_stats(setup):
    _, tsegs = setup
    dev = ShardedQueryExecutor(device="cpu")
    _, stats = dev.execute(t_compile(
        "SELECT count(*), sum(price) FROM sales WHERE kind = 'a'"), tsegs)
    assert stats.launch["launches"] == 1
    assert stats.launch["batchSize"] == 1
    assert stats.launch["coalesced"] == 0


def _bound(dev, sql):
    with dev._cache_lock:
        return next(v for k, v in dev._param_cache.items() if k[0] == sql)


def test_distinct_literals_in_one_batched_call_equal_solo(setup):
    """Same-shape literal variants share the launch key, and one query-axis
    call over their programs gives each its solo outputs (the plain
    version here; the kernel on the card in chip_smoke.py)."""
    jsegs, tsegs = setup
    dev = ShardedQueryExecutor(device="cpu")
    sqls = [f"SELECT region, sum(qty), count(*) FROM sales "
            f"WHERE year >= {y} GROUP BY region ORDER BY region"
            for y in (2016, 2019, 2021)]
    for sql in sqls:
        got, _ = dev.execute(t_compile(sql), tsegs)
        want, _ = JSharded().execute(j_compile(sql), jsegs)
        _assert_rows(got.rows, want.rows)
    bounds = [_bound(dev, sql) for sql in sqls]
    assert len({b.launch_key for b in bounds}) == 1
    assert len(dev._launch_cache) == 1 and len(dev._param_cache) == 3
    kernel = dev._launch_cache[bounds[0].launch_key]
    batch, staged = dev.batch_for(tsegs)
    nd = staged.num_docs_tensor()
    progs = [b.params for b in bounds]
    solo = [kernel.run_one(p, nd) for p in progs]
    rows = kernel.run_many(progs, nd)
    for s, r in zip(solo, rows):
        assert np.array_equal(s.buf.numpy(), r.buf.numpy())
    # the wrapper and its plain version over the same staged inputs
    inp = fused_scan.scan_inputs(bounds[0].plan, staged)
    many = sharded_fused_scan_many(progs, inp.words, inp.values, nd,
                                   inp.tiles)
    plain = sharded_fused_scan_many_plain(progs, inp.words, inp.values, nd,
                                          inp.tiles)
    for m, p, s in zip(many, plain, solo):
        assert np.array_equal(m.buf.numpy(), p.buf.numpy())
        assert np.array_equal(m.buf.numpy(), s.buf.numpy())
    with pytest.raises(ValueError, match="layout"):
        other = fused_scan.scan_inputs(
            dev._plan_for(t_compile(
                "SELECT kind, count(*) FROM sales GROUP BY kind"), tsegs[0]),
            dev.stage(tsegs[0]))
        sharded_fused_scan_many([progs[0], other.prog], inp.words,
                                inp.values, nd, inp.tiles)


def test_probe_programs_share_a_query_axis_launch(setup):
    """The probe mode rides the query axis too: two probe programs of one
    layout in one call equal their solo probes."""
    _, tsegs = setup
    dev = ShardedQueryExecutor(device="cpu")
    batch, staged = dev.batch_for(tsegs)
    progs = []
    for y in (2016, 2020):
        sql = (f"SELECT region, year, count(*) FROM sales WHERE "
               f"year >= {y} GROUP BY region, year")
        pp = fused_scan.extract_plan(plan_segment(t_compile(sql), batch),
                                     batch)
        probe_pp = fused_scan.probe_plan_of(pp)
        words = [staged.packed_column(n).words
                 for n in probe_pp.packed_names]
        progs.append(fused_scan.compile_program(
            probe_pp, tuple(staged.packed_column(n).bits
                            for n in probe_pp.packed_names), probe=True))
    assert progs[0].layout_key() == progs[1].layout_key()
    nd = staged.num_docs_tensor()
    outs = sharded_fused_scan_probe_many(progs, words, nd)
    for p, o in zip(progs, outs):
        solo = fused_scan.fused_scan_plain(p, words, [], nd)
        assert np.array_equal(o.buf.numpy(), solo.buf.numpy())
    assert not np.array_equal(outs[0].mm.numpy(), outs[1].mm.numpy())


def test_literals_that_change_a_lut_run_count_do_not_share_a_key(setup):
    """With region's dictIds east 0, north 1, south 2, west 3, ``IN
    ('east', 'west')`` is two dictId runs and ``IN ('east', 'north')``
    one: their programs differ in layout, so their launch keys differ (a
    shared key would serve one query the other's answer). ``IN ('north',
    'west')`` is two runs again: it shares the first query's key, and one
    batched call over the two gives each its own answer."""
    jsegs, tsegs = setup
    dev = ShardedQueryExecutor(device="cpu")
    sqls = ["SELECT kind, sum(qty) FROM sales WHERE region IN "
            "('east', 'west') GROUP BY kind ORDER BY kind",
            "SELECT kind, sum(qty) FROM sales WHERE region IN "
            "('east', 'north') GROUP BY kind ORDER BY kind",
            "SELECT kind, sum(qty) FROM sales WHERE region IN "
            "('north', 'west') GROUP BY kind ORDER BY kind"]
    for sql in sqls:
        got, _ = dev.execute(t_compile(sql), tsegs)
        want, _ = JSharded().execute(j_compile(sql), jsegs)
        _assert_rows(got.rows, want.rows)
    bounds = [_bound(dev, sql) for sql in sqls]
    keys = [b.launch_key for b in bounds]
    assert keys[0] != keys[1] and keys[2] != keys[1]
    assert keys[0] == keys[2]
    assert bounds[0].params.filter_n != bounds[1].params.filter_n
    kernel = dev._launch_cache[keys[0]]
    nd = dev.batch_for(tsegs)[1].num_docs_tensor()
    rows = kernel.run_many([bounds[0].params, bounds[2].params], nd)
    for b, r in zip((bounds[0], bounds[2]), rows):
        assert np.array_equal(kernel.run_one(b.params, nd).buf.numpy(),
                              r.buf.numpy())
    assert not np.array_equal(rows[0].buf.numpy(), rows[1].buf.numpy())


def test_unique_literals_share_the_launch_tier(setup):
    jsegs, tsegs = setup
    dev = ShardedQueryExecutor(device="cpu")
    sqls = [f"SELECT region, sum(qty) FROM sales WHERE year >= {y} "
            "GROUP BY region ORDER BY region" for y in (2016, 2017, 2019,
                                                        2021)]
    for sql in sqls:
        got, _ = dev.execute(t_compile(sql), tsegs)
        want, _ = JExecutor(use_device=False).execute(j_compile(sql), jsegs)
        _assert_rows(got.rows, want.rows)
    assert len(dev._launch_cache) == 1
    assert len(dev._param_cache) == len(sqls)
    # an exact repeat is served the same bound query: what dedup keys on
    before = {k: id(v.params) for k, v in dev._param_cache.items()}
    dev.execute(t_compile(sqls[0]), tsegs)
    assert {k: id(v.params) for k, v in dev._param_cache.items()} == before


HAMMER_QUERIES = [
    "SELECT region, sum(qty), count(*) FROM sales WHERE year >= 2016 "
    "GROUP BY region ORDER BY region",
    "SELECT region, sum(qty), count(*) FROM sales WHERE year >= 2018 "
    "GROUP BY region ORDER BY region",
    "SELECT region, sum(qty), count(*) FROM sales WHERE year >= 2020 "
    "GROUP BY region ORDER BY region",
    "SELECT count(*), sum(price) FROM sales WHERE kind = 'a'",
    "SELECT year, min(price), max(price) FROM sales GROUP BY year "
    "ORDER BY year",
    "SELECT kind, avg(qty), sum(raw_amt) FROM sales GROUP BY kind "
    "ORDER BY kind",
    # the jnp combine (an int max past 2^24 declines the fused scan):
    # serial launches on the dispatcher, dedup shared
    "SELECT kind, max(raw_amt * raw_amt) FROM sales GROUP BY kind "
    "ORDER BY kind",
]
THREADS = 8
ITERS = 6


def test_concurrency_hammer_rows_equal_the_jax_executor(setup):
    jsegs, tsegs = setup
    jdev = JExecutor(use_device=False)
    want = [jdev.execute(j_compile(q), jsegs)[0].rows
            for q in HAMMER_QUERIES]
    dev = ShardedQueryExecutor(device="cpu")
    ctxs = [t_compile(q) for q in HAMMER_QUERIES]
    for ctx, w in zip(ctxs, want):     # binds every shape once
        _assert_rows(dev.execute(ctx, tsegs)[0].rows, w)
    mark = dev.launcher.stats_snapshot()
    errors, coalesced = [], []
    start = threading.Barrier(THREADS)

    def pump(tid: int) -> None:
        try:
            start.wait(30)
            for it in range(ITERS):
                qi = (tid + it) % len(ctxs)
                # a context compiled per call: identical calls on one
                # compiled context would share one run (the executor's
                # query single-flight), and this counts launch requests
                rt, stats = dev.execute(t_compile(HAMMER_QUERIES[qi]),
                                        tsegs)
                _assert_rows(rt.rows, want[qi])
                assert stats.staging["spills"] == 0
                if stats.launch.get("batchSize", 0) > 1:
                    coalesced.append(stats.launch)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=pump, args=(t,), daemon=True)
               for t in range(THREADS)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "hammer threads hung"
    assert not errors, errors[:3]
    snap = dev.launcher.stats_snapshot()
    assert snap["requests"] - mark["requests"] == THREADS * ITERS
    assert snap["coalescedLaunches"] > mark["coalescedLaunches"]
    assert snap["launchesSaved"] > mark["launchesSaved"]
    assert snap["maxBatchSize"] >= 2 and coalesced


def test_flight_shares_identical_per_segment_launches(setup):
    """Concurrent identical queries over one segment share one launch of
    the per-segment path (the same cached plan on the same resident)."""
    jsegs, tsegs = setup
    sql = "SELECT kind, sum(raw_amt) FROM sales GROUP BY kind ORDER BY kind"
    want, _ = JExecutor(use_device=False).execute(j_compile(sql), jsegs[:1])
    dev = ShardedQueryExecutor(device="cpu")
    ctx = t_compile(sql)
    dev.execute(ctx, tsegs[:1])
    release = threading.Event()
    real = fused_scan.run_segment

    def slow(*a, **k):
        release.wait(10)
        return real(*a, **k)

    fused_scan.run_segment = slow
    try:
        hits0 = dev.kernel_flight.hits
        outs, errors = [], []

        def run():
            try:
                # a context compiled per call: one compiled context would
                # share the whole run (the query flight) before the launch
                outs.append(dev.execute(t_compile(sql), tsegs[:1])[0].rows)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=run) for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while dev.kernel_flight.hits - hits0 < 3 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(30)
    finally:
        fused_scan.run_segment = real
    assert not errors, errors
    assert dev.kernel_flight.hits - hits0 == 3
    for rows in outs:
        _assert_rows(rows, want.rows)
