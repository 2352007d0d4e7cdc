"""The port's residency manager (``pinot_tpu_torch/engine/residency.py``)
against ``tests/test_residency.py``'s cases, run on both managers.

The same segments (built by the JAX SegmentBuilder, carried across with
``columns_of`` / ``segment_from_arrays``) and the same operations go
through the JAX ``ResidencyManager`` and the port's (``device="cpu"``);
the outcomes that do not depend on either package's byte layout must be
equal: which residents stay, the pins, the hit / miss / eviction
counters, the decisions and the rows. Byte counts differ (the port stages
its own layout), so a budget is always taken from the package's own
measured bytes. Fake residents (the same byte sizes on both) hold the
eviction order, the pins and the host tier to the JAX manager exactly.
Rows: counts and integer sums exact; float cells rel 1e-5, abs 1e-6.
"""

import sys
import threading

import numpy as np
import pytest

from pinot_tpu.engine import QueryStats as JStats
from pinot_tpu.engine import ServerQueryExecutor as JExecutor
from pinot_tpu.engine.residency import QueryLease as JLease
from pinot_tpu.engine.residency import ResidencyManager as JManager
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.segment import SegmentBuilder, load_segment
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.engine.residency import QueryLease as TLease
from pinot_tpu_torch.engine.residency import ResidencyManager as TManager
from pinot_tpu_torch.engine.residency import estimate_segment_bytes
from pinot_tpu_torch.engine.results import QueryStats as TStats
from pinot_tpu_torch.parallel import ShardedQueryExecutor
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.segment import columns_of, segment_from_arrays

RNG = np.random.default_rng(7)
N = 1024
NUM_SEGMENTS = 4
COLUMNS = ("region", "qty")

GROUP_SQL = ("SELECT region, sum(qty), count(*) FROM sales "
             "GROUP BY region ORDER BY region")
AGG_SQL = "SELECT sum(qty), count(*) FROM sales WHERE region != 'west'"
BOTH = ["jax", "port"]


def _schema():
    return Schema("sales", [
        FieldSpec("region", DataType.STRING),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
    ])


def carry(jsegs):
    return [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                table_name="sales") for j in jsegs]


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """{"jax": the JAX segments, "port": their carried copies}."""
    out = tmp_path_factory.mktemp("torch_residency_segs")
    regions = ["east", "west", "north", "south"]
    built = []
    for i in range(NUM_SEGMENTS):
        b = SegmentBuilder(_schema(), f"sales_{i}")
        b.build({
            "region": [regions[j] for j in RNG.integers(0, 4, N)],
            "qty": RNG.integers(1, 50, N).tolist(),
        }, str(out))
        built.append(load_segment(str(out / f"sales_{i}")))
    return {"jax": built, "port": carry(built)}


def manager(pkg, **kw):
    return (JManager(**kw) if pkg == "jax"
            else TManager(device="cpu", **kw))


def lease(pkg):
    return JLease() if pkg == "jax" else TLease()


def qstats(pkg):
    return JStats() if pkg == "jax" else TStats()


def _stage_full(rm, seg, lease=None):
    st = rm.stage(seg, lease=lease)
    for c in COLUMNS:
        st.column(c)
    return st


def _host_rows(jsegs, sql):
    rt, _ = JExecutor(use_device=False).execute(j_compile(sql), jsegs)
    return rt.rows


def _assert_rows(got, want):
    assert len(got) == len(want)
    for gr, wr in zip(got, want):
        for g, w in zip(gr, wr):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-5, abs=1e-6), (gr, wr)
            else:
                assert g == w, (gr, wr)


def _decisions(stats, points=("residency", "sharded_combine")):
    return {k: v for k, v in stats.decisions.items()
            if k.split(":")[0] in points}


# --------------------------------------------------------------------------
# lock correctness
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", BOTH)
def test_concurrent_stage_shares_one_resident(segs, pkg):
    rm = manager(pkg, budget_bytes=0)
    barrier = threading.Barrier(8)
    got = []

    def worker():
        barrier.wait()
        got.append(rm.stage(segs[pkg][0]))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert len({id(s) for s in got}) == 1
    assert rm.misses == 1 and rm.hits == 7


def test_concurrent_column_builds_share_one_tensor(segs):
    """The per-segment lock: threads building the same column of one
    resident get one tensor."""
    rm = manager("port", budget_bytes=0)
    st = rm.stage(segs["port"][0])
    barrier = threading.Barrier(8)
    got = []

    def worker():
        barrier.wait()
        got.append((st.column("qty").fwd, st.packed_column("region").words,
                    st.value_column("qty")))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for k in range(3):
        assert len({id(g[k]) for g in got}) == 1


def test_stage_evict_thread_hammer(segs):
    rm = manager("port", budget_bytes=0)
    stop = threading.Event()
    errors = []
    tsegs = segs["port"]

    def stager(seg):
        while not stop.is_set():
            try:
                st = rm.stage(seg)
                st.column("region")
                st.packed_column("region")
                st.value_column("qty")
            except Exception as e:  # pragma: no cover - failure mode
                errors.append(e)
                return

    def evictor():
        while not stop.is_set():
            for s in tsegs[:2]:
                try:
                    rm.evict(s.segment_name)
                except Exception as e:  # pragma: no cover - failure mode
                    errors.append(e)
                    return

    threads = [threading.Thread(target=stager, args=(s,))
               for s in tsegs[:2] for _ in range(3)]
    threads.append(threading.Thread(target=evictor))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # switch threads often: lost updates show
    try:
        for t in threads:
            t.start()
        stop.wait(1.0)
        stop.set()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    # the accounting agrees with the residents' own byte counts
    snap = rm.snapshot()
    assert snap["stagedBytes"] == sum(
        e["bytes"] for e in snap["stagedSegments"].values())
    for _name, st in rm.residents():
        assert st.nbytes() == (
            sum(pc.words.numel() * 4 for pc in st._packed.values())
            + sum(v.numel() * v.element_size() for v in st._values.values())
            + sum(c.nbytes() for c in st._columns.values()))
    st = rm.stage(tsegs[0])
    assert st.column("region").fwd is not None
    assert rm.staged_bytes() > 0


# --------------------------------------------------------------------------
# budget / LRU / pins, on both managers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", BOTH)
def test_budget_evicts_lru_first(segs, pkg):
    rm = manager(pkg, budget_bytes=0)
    for s in segs[pkg][:3]:
        _stage_full(rm, s)
    per_seg = rm.staged_bytes() // 3
    rm.stage(segs[pkg][0])     # LRU order becomes [1, 2, 0]
    rm.set_budget_bytes(int(per_seg * 2.5))
    assert rm.resident_names() == [segs[pkg][2].segment_name,
                                   segs[pkg][0].segment_name]
    snap = rm.stats_snapshot()
    assert snap["evictions"] == 1
    assert snap["stagedBytes"] <= int(per_seg * 2.5)


class _Resident:
    """A resident of ``n`` bytes; with ``demotable`` its eviction leaves a
    host image of the same bytes."""

    def __init__(self, n, demotable=False):
        self._n = n
        self.released = False
        if demotable:
            self.demote = self._demote

    def nbytes(self):
        return 0 if self.released else self._n

    def release(self):
        self.released = True

    def _demote(self):
        self.released = True
        return _Image(self._n)


class _Image:
    def __init__(self, n):
        self.n = n

    def nbytes(self):
        return self.n

    def release(self):
        self.n = 0

    def matches(self, target):
        return True


@pytest.mark.parametrize("pkg", BOTH)
def test_register_accounts_and_enforces_on_insert(pkg):
    rm = manager(pkg, budget_bytes=1000)
    a = _Resident(600)
    rm.register("a", lambda: a)
    assert rm.staged_bytes() == 600
    b = _Resident(600)
    rm.register("b", lambda: b)
    assert a.released and not b.released
    assert rm.resident_names() == ["b"]
    assert rm.staged_bytes() == 600


def _script(pkg):
    """One sequence of operations with fake residents: registrations of
    several sizes, touches, a pinning lease, a budget, a host budget,
    demotions, promotions, an explicit demote and an evict. -> what the
    manager holds after each step."""
    rm = manager(pkg, budget_bytes=0, host_budget_bytes=2500)
    sizes = {"a": 900, "b": 300, "c": 700, "d": 500, "e": 400}
    res = {n: _Resident(s, demotable=n != "e") for n, s in sizes.items()}
    trail = []

    def mark(step):
        snap = rm.stats_snapshot()
        trail.append((step, rm.resident_names(), rm.host_entry_names(),
                      {k: snap[k] for k in (
                          "hits", "misses", "evictions",
                          "pinBlockedEvictions", "demotions", "promotions",
                          "hostDrops", "stagedBytes", "hostBytes",
                          "demotedBytes", "promotedBytes",
                          "hostDroppedBytes")}))

    for n in "abcde":
        rm.register(n, lambda n=n: res[n])
    mark("registered")
    q = lease(pkg)
    rm.register("b", lambda: res["b"], lease=q)
    rm.register("a", lambda: res["a"])
    mark("touched")
    rm.set_budget_bytes(1500)
    mark("budget")
    rm.promote_host("c", None, q)
    mark("promoted c")
    rm.set_budget_bytes(100)
    mark("tight while pinned")
    stats = qstats(pkg)
    rm.end_query(q, stats)
    mark("ended")
    rm.set_budget_bytes(600)
    mark("budget 600")
    for n in ("f", "g"):
        rm.register(n, lambda: _Resident(350, demotable=True))
    mark("more")
    trail.append(("demote", rm.demote("f"), rm.demote("g"),
                  rm.demote("zz")))
    mark("demoted")
    rm.evict("a")
    mark("evicted a")
    rm.register("h", lambda: _Resident(1200, demotable=True))
    mark("past both budgets")
    return trail, stats.staging


def test_eviction_order_pins_and_host_tier_equal_the_jax_manager():
    jtrail, jstaging = _script("jax")
    ttrail, tstaging = _script("port")
    for j, t in zip(jtrail, ttrail):
        assert j == t, (j[0], j, t)
    assert jstaging == tstaging


@pytest.mark.parametrize("pkg", BOTH)
def test_pinned_segments_survive_eviction_pressure(segs, pkg):
    rm = manager(pkg, budget_bytes=0)
    q = lease(pkg)
    _stage_full(rm, segs[pkg][0], lease=q)
    _stage_full(rm, segs[pkg][1])
    rm.set_budget_bytes(1)
    names = rm.resident_names()
    assert names == [segs[pkg][0].segment_name]
    assert rm.pin_blocked >= 1
    stats = qstats(pkg)
    rm.end_query(q, stats)
    assert rm.resident_names() == []
    assert stats.staging["stagedBytes"] == 0
    assert stats.staging["hits"] == 0 and stats.staging["misses"] == 1


@pytest.mark.parametrize("pkg", BOTH)
def test_reload_keeps_identity_invalidation(segs, pkg):
    rm = manager(pkg, budget_bytes=0)
    st1 = _stage_full(rm, segs[pkg][0])
    reloaded = (load_segment(segs["jax"][0].segment_dir) if pkg == "jax"
                else carry(segs["jax"][:1])[0])
    st2 = rm.stage(reloaded)
    assert st2 is not st1 and st2.segment is reloaded
    assert rm.misses == 2
    assert len(rm.resident_names()) == 1


def test_estimate_tracks_actual_bytes(segs):
    """The estimate of the port's layout against what the fused scan's
    staging measures (packed words and value columns)."""
    seg = segs["port"][0]
    rm = manager("port", budget_bytes=0)
    st = rm.stage(seg)
    st.packed_column("region")
    st.packed_column("qty")
    st.value_column("qty")
    est = estimate_segment_bytes(seg, COLUMNS)
    actual = st.nbytes()
    assert est > 0 and actual > 0
    assert actual / 2 <= est <= actual * 2


# --------------------------------------------------------------------------
# spill to the host engine (admission)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sql", [GROUP_SQL, AGG_SQL])
def test_per_segment_spill_matches_the_jax_executor(segs, sql):
    jex = JExecutor(hbm_budget_bytes=64)
    tex = ServerQueryExecutor(device="cpu", hbm_budget_bytes=64)
    want, jstats = jex.execute(j_compile(sql), segs["jax"])
    got, tstats = tex.execute(t_compile(sql), segs["port"])
    _assert_rows(got.rows, want.rows)
    _assert_rows(got.rows, _host_rows(segs["jax"], sql))
    assert _decisions(tstats) == _decisions(jstats) == {
        "residency:device->host_engine:single_segment_over_budget": 1}
    assert tstats.staging == jstats.staging
    assert tstats.staging["spills"] == 1
    assert tstats.staging["stagedBytes"] == 0
    assert tstats.scan_launches == tstats.general_launches == 0


def test_sharded_spill_matches_the_jax_executor(segs):
    jex = JSharded(hbm_budget_bytes=64)
    tex = ShardedQueryExecutor(device="cpu", hbm_budget_bytes=64)
    want, jstats = jex.execute(j_compile(GROUP_SQL), segs["jax"])
    got, tstats = tex.execute(t_compile(GROUP_SQL), segs["port"])
    _assert_rows(got.rows, want.rows)
    assert _decisions(tstats) == _decisions(jstats)
    assert tstats.staging["spills"] == 1
    assert tstats.group_by_rung == jstats.group_by_rung == "host"
    assert tstats.launch == {}


def test_sharded_capped_budget_churns_but_stays_correct(segs):
    probe = ShardedQueryExecutor(device="cpu")
    ctx_all = t_compile(GROUP_SQL)
    probe.execute(ctx_all, segs["port"])
    one_batch = probe.residency.staged_bytes()
    assert one_batch > 0
    dev = ShardedQueryExecutor(device="cpu",
                               hbm_budget_bytes=int(one_batch * 1.3))
    ctx_sub = t_compile(AGG_SQL)
    want_all = _host_rows(segs["jax"], GROUP_SQL)
    want_sub = _host_rows(segs["jax"][:2], AGG_SQL)
    for _ in range(2):
        rt, stats = dev.execute(ctx_all, segs["port"])
        _assert_rows(rt.rows, want_all)
        assert stats.staging["spills"] == 0
        rt, stats = dev.execute(ctx_sub, segs["port"][:2])
        _assert_rows(rt.rows, want_sub)
        assert dev.residency.staged_bytes() <= int(one_batch * 1.3)
    snap = dev.residency.stats_snapshot()
    assert snap["evictions"] >= 1
    assert snap["stagedBytes"] <= int(one_batch * 1.3)


@pytest.mark.parametrize("pkg", BOTH)
def test_warm_hit_rate_is_total(segs, pkg):
    dev = (JSharded() if pkg == "jax"
           else ShardedQueryExecutor(device="cpu"))
    compile_ = j_compile if pkg == "jax" else t_compile
    ctx = compile_(GROUP_SQL)
    _, cold = dev.execute(ctx, segs[pkg])
    _, stats = dev.execute(ctx, segs[pkg])
    assert cold.staging["misses"] == 1
    assert stats.staging["misses"] == 0
    assert stats.staging["hits"] >= 1
    assert stats.staging["spills"] == 0


# --------------------------------------------------------------------------
# batch eviction
# --------------------------------------------------------------------------

def test_evict_segment_clears_every_containing_batch(segs):
    tsegs = segs["port"]
    dev = ShardedQueryExecutor(device="cpu")
    dev.execute(t_compile(GROUP_SQL), tsegs)
    dev.execute(t_compile(AGG_SQL), tsegs[:2])
    assert len(dev._batches) == 2
    assert dev._param_cache and dev._launch_cache
    dev.evict_segment(tsegs[0].segment_name)
    assert not dev._batches
    assert not dev._launch_cache and not dev._param_cache
    assert not dev.residency.resident_names()
    rt, _ = dev.execute(t_compile(GROUP_SQL), tsegs)
    _assert_rows(rt.rows, _host_rows(segs["jax"], GROUP_SQL))


def test_evict_batch_clears_both_cache_tiers(segs):
    dev = ShardedQueryExecutor(device="cpu")
    dev.execute(t_compile(GROUP_SQL), segs["port"])
    assert dev._param_cache and dev._launch_cache
    batch, staged = dev.batch_for(segs["port"])
    assert staged.nbytes() > 0
    dev._evict_batch(batch)
    assert not dev._param_cache and not dev._launch_cache
    assert staged.nbytes() == 0


# --------------------------------------------------------------------------
# stats
# --------------------------------------------------------------------------

def test_staging_stats_merge_counters_sum_bytes_max():
    parts = ({"hits": 1, "misses": 2, "spills": 0, "stagedBytes": 100},
             {"hits": 3, "misses": 1, "spills": 1, "stagedBytes": 40,
              "evictions": 2})
    j, t = JStats(staging=dict(parts[0])), TStats(staging=dict(parts[0]))
    j.merge(JStats(staging=dict(parts[1])))
    t.merge(TStats(staging=dict(parts[1])))
    assert t.staging == j.staging == {"hits": 4, "misses": 3, "spills": 1,
                                      "stagedBytes": 100, "evictions": 2}


# --------------------------------------------------------------------------
# prefetch
# --------------------------------------------------------------------------

def test_prefetch_stages_in_background(segs):
    rm = manager("port", budget_bytes=0)
    try:
        rm.prefetch(segs["port"][0])
        rm.drain_prefetch()
        assert segs["port"][0].segment_name in rm.resident_names()
        assert rm.staged_bytes() > 0
        assert rm.stats_snapshot()["prefetched"] == 1
    finally:
        rm.close()


def test_prefetch_never_evicts_for_itself(segs):
    rm = manager("port", budget_bytes=0)
    try:
        _stage_full(rm, segs["port"][0])
        rm.set_budget_bytes(rm.staged_bytes())
        rm.stage(segs["port"][0])
        rm.prefetch(segs["port"][1])
        rm.drain_prefetch()
        assert segs["port"][0].segment_name in rm.resident_names()
    finally:
        rm.close()


def test_prefetch_queued_before_remove_cannot_resurrect(segs):
    from types import SimpleNamespace

    release_worker = threading.Event()

    class _BlockingCols:
        def keys(self):
            release_worker.wait(10.0)
            return []

    blocker = SimpleNamespace(
        segment_name="__blocker__", is_mutable=False, num_docs=0,
        padded_capacity=0, metadata=SimpleNamespace(columns=_BlockingCols()))
    seg = segs["port"][0]
    rm = manager("port", budget_bytes=0)
    try:
        rm.prefetch(blocker)            # the worker stalls in this item
        rm.prefetch(seg)                # queued behind it
        rm.evict(seg.segment_name)      # the removal lands first
        release_worker.set()
        rm.drain_prefetch()
        assert seg.segment_name not in rm.resident_names()
        rm.prefetch(seg)                # a re-add prefetches again
        rm.drain_prefetch()
        assert seg.segment_name in rm.resident_names()
    finally:
        release_worker.set()
        rm.close()


def test_prefetch_vs_remove_thread_hammer(segs):
    rm = manager("port", budget_bytes=0)
    tsegs = segs["port"]
    stop = threading.Event()
    errors = []

    def prefetcher(seg):
        while not stop.is_set():
            try:
                rm.prefetch(seg)
            except Exception as e:  # pragma: no cover - failure mode
                errors.append(e)
                return

    def remover():
        while not stop.is_set():
            for s in tsegs[:2]:
                try:
                    rm.evict(s.segment_name)
                except Exception as e:  # pragma: no cover - failure mode
                    errors.append(e)
                    return

    threads = [threading.Thread(target=prefetcher, args=(s,))
               for s in tsegs[:2] for _ in range(2)]
    threads += [threading.Thread(target=remover) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        stop.wait(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    rm.drain_prefetch()
    for s in tsegs[:2]:
        rm.evict(s.segment_name)
    rm.drain_prefetch()
    for s in tsegs[:2]:
        assert s.segment_name not in rm.resident_names()
    snap = rm.snapshot()
    by_resident = sum(e["bytes"] for e in snap["stagedSegments"].values())
    assert snap["stagedBytes"] == by_resident >= 0
    rm.close()


def test_snapshot_is_bytes_accurate(segs):
    rm = manager("port", budget_bytes=0)
    st = _stage_full(rm, segs["port"][0])
    snap = rm.snapshot()
    ent = snap["stagedSegments"][segs["port"][0].segment_name]
    assert ent["bytes"] == st.nbytes() > 0
    assert ent["columns"] == len(COLUMNS)
    assert snap["stagedBytes"] == ent["bytes"]
    assert snap["peakBytes"] >= snap["stagedBytes"]
    assert snap["budgetBytes"] is None


def test_budget_defaults_are_uncapped_on_the_cpu():
    from pinot_tpu_torch.engine.residency import resolve_budget_bytes
    from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration

    assert manager("port").budget_bytes is None
    cfg = PinotConfiguration({CommonConstants.HBM_BUDGET_BYTES_KEY: 4096},
                             use_env=False)
    assert manager("port", config=cfg).budget_bytes == 4096
    assert resolve_budget_bytes(-1) is None
    assert resolve_budget_bytes(None) is None
    host = manager("port").host_budget_bytes
    assert host is None or host > 0
