"""The port's host tier, sliced execution and cost-aware eviction
(``engine/residency.py``, ``engine/staging.py``, ``parallel/executor.py``)
against ``tests/test_residency_tier.py``'s cases.

Demote then promote gives tensors equal to a cold build. Under churn, a
sliced combine at a fraction of the working set, one segment over the
budget, a selection that cannot slice and slicing turned off by config,
the port's executors give the rows and the ``residency`` /
``sharded_combine`` decisions of the JAX executors on the same segments.
Each package takes its budget from its own measured working set (or its
own estimate), since the two layouts differ in bytes; the JAX sharded
executor runs on a one-device mesh, the port's on one device. Rows:
counts and integer sums exact, float cells rel 1e-5, abs 1e-6.
"""

import threading

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ServerQueryExecutor as JExecutor
from pinot_tpu.engine import residency as j_residency
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded
from pinot_tpu.parallel.combine import make_combine_mesh
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.segment import SegmentBuilder, load_segment
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema
from pinot_tpu.spi.config import CommonConstants as JConstants
from pinot_tpu.spi.config import PinotConfiguration as JConfig
from pinot_tpu_torch.engine import residency as t_residency
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.engine.residency import (
    COST_COLUMN_BUILD,
    COST_HOST_RESTAGE,
    COST_STARTREE_BUILD,
    QueryLease,
    ResidencyManager,
)
from pinot_tpu_torch.engine.results import QueryStats
from pinot_tpu_torch.engine.staging import SegmentHostImage, StagedSegment
from pinot_tpu_torch.parallel import ShardedQueryExecutor
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.segment import columns_of, segment_from_arrays
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration

RNG = np.random.default_rng(11)
N = 512
NUM_SEGMENTS = 16
COLUMNS = ("region", "qty")

GROUP_SQL = ("SELECT region, sum(qty), count(*) FROM sales "
             "GROUP BY region ORDER BY region")
AGG_SQL = "SELECT sum(qty), count(*) FROM sales WHERE region != 'west'"
SQLS = {"group": GROUP_SQL, "agg": AGG_SQL}


def _schema():
    return Schema("sales", [
        FieldSpec("region", DataType.STRING),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
    ])


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_tier_segs")
    regions = ["east", "west", "north", "south"]
    built = []
    for i in range(NUM_SEGMENTS):
        b = SegmentBuilder(_schema(), f"sales_{i}")
        b.build({
            "region": [regions[j] for j in RNG.integers(0, 4, N)],
            "qty": RNG.integers(1, 50, N).tolist(),
        }, str(out))
        built.append(load_segment(str(out / f"sales_{i}")))
    port = [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                table_name="sales") for j in built]
    return {"jax": built, "port": port}


def _one_device_mesh():
    import jax

    return make_combine_mesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def oracle(segs):
    """Uncapped executors: the JAX rows, and each package's measured
    working set."""
    jdev = JSharded(mesh=_one_device_mesh())
    tdev = ShardedQueryExecutor(device="cpu")
    rows, ws = {}, {}
    for name, sql in SQLS.items():
        rows[name] = jdev.execute(j_compile(sql), segs["jax"])[0].rows
        got, _ = tdev.execute(t_compile(sql), segs["port"])
        _assert_rows(got.rows, rows[name])
    ws["jax"] = jdev.residency.staged_bytes()
    ws["port"] = tdev.residency.staged_bytes()
    assert ws["jax"] > 0 and ws["port"] > 0
    return {"rows": rows, "ws": ws}


def _assert_rows(got, want):
    assert len(got) == len(want)
    for gr, wr in zip(got, want):
        for g, w in zip(gr, wr):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-5, abs=1e-6), (gr, wr)
            else:
                assert g == w, (gr, wr)


def _decisions(stats):
    return {k: v for k, v in stats.decisions.items()
            if k.split(":")[0] in ("residency", "sharded_combine")}


def _stage_full(rm, seg, lease=None):
    st = rm.stage(seg, lease=lease)
    for c in COLUMNS:
        st.column(c)
    st.packed_column("region")
    st.value_column("qty")
    return st


def _pair(sharded: bool, budgets, config=None):
    """(JAX executor, port executor), each with its own budget."""
    jcfg = tcfg = None
    if config is not None:
        jcfg = JConfig(config, use_env=False)
        tcfg = PinotConfiguration(config, use_env=False)
    if sharded:
        return (JSharded(mesh=_one_device_mesh(),
                         hbm_budget_bytes=budgets["jax"], config=jcfg),
                ShardedQueryExecutor(device="cpu",
                                     hbm_budget_bytes=budgets["port"],
                                     config=tcfg))
    return (JExecutor(hbm_budget_bytes=budgets["jax"], config=jcfg),
            ServerQueryExecutor(device="cpu",
                                hbm_budget_bytes=budgets["port"],
                                config=tcfg))


def _est(segs, factor):
    return {"jax": int(j_residency.estimate_segment_bytes(
                segs["jax"][0], COLUMNS) * factor),
            "port": int(t_residency.estimate_segment_bytes(
                segs["port"][0], COLUMNS) * factor)}


def _both(pair, segs, sql):
    jex, tex = pair
    want, jstats = jex.execute(j_compile(sql), segs["jax"])
    got, tstats = tex.execute(t_compile(sql), segs["port"])
    _assert_rows(got.rows, want.rows)
    assert _decisions(tstats) == _decisions(jstats), sql
    return jstats, tstats


# --------------------------------------------------------------------------
# demote / promote
# --------------------------------------------------------------------------

def test_demote_then_promote_restores_identical_arrays(segs):
    seg = segs["port"][0]
    rm = ResidencyManager(budget_bytes=0, device="cpu")
    st = _stage_full(rm, seg)
    cold = {c: st.column(c).fwd.clone() for c in COLUMNS}
    cold_words = st.packed_column("region").words.clone()
    cold_vals = st.value_column("qty").clone()
    assert rm.demote(seg.segment_name)
    assert seg.segment_name not in rm.resident_names()
    assert rm.host_entry_names() == [seg.segment_name]
    assert rm.host_bytes() == st.nbytes() + rm.host_bytes() > 0
    st2 = _stage_full(rm, seg)
    assert st2 is not st
    snap = rm.stats_snapshot()
    assert snap["demotions"] == 1 and snap["promotions"] == 1
    assert rm.host_entry_names() == [] and rm.host_bytes() == 0
    for c in COLUMNS:
        assert torch.equal(st2.column(c).fwd, cold[c])
    assert torch.equal(st2.packed_column("region").words, cold_words)
    assert st2.packed_column("region").bits == 2
    assert torch.equal(st2.value_column("qty"), cold_vals)
    assert st2.promoted_bytes == snap["promotedBytes"] > 0


def test_star_tree_nodes_demote_and_promote(segs):
    """A tree's node columns leave with their segment and come back by
    promotion, equal."""
    from pinot_tpu_torch.spi.table import IndexingConfig, StarTreeIndexConfig

    seg = segment_from_arrays(
        "st_0", segs["port"][0].num_docs, columns_of(segs["jax"][0]),
        table_name="sales", indexing=IndexingConfig(
            star_tree_index_configs=[StarTreeIndexConfig(
                dimensions_split_order=["region"],
                function_column_pairs=["SUM__qty"])]))
    rm = ResidencyManager(budget_bytes=0, device="cpu")
    nodes = {k: v.clone() for k, v in
             rm.stage(seg).startree_nodes(0).items()}
    with rm._lock:
        e = rm._entries[seg.segment_name]
        assert rm._rebuild_cost_locked(seg.segment_name, e) \
            == COST_STARTREE_BUILD
    assert rm.demote(seg.segment_name)
    st = rm.stage(seg)
    assert st._startree == {}
    back = st.startree_nodes(0)
    assert back.keys() == nodes.keys()
    for k in nodes:
        assert torch.equal(back[k], nodes[k])
    assert rm.stats_snapshot()["promotions"] == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_promote_validates_segment_identity(segs, pkg):
    if pkg == "jax":
        rm = j_residency.ResidencyManager(budget_bytes=0)
        seg = segs["jax"][0]
        reloaded = load_segment(seg.segment_dir)
    else:
        rm = ResidencyManager(budget_bytes=0, device="cpu")
        seg = segs["port"][0]
        reloaded = segment_from_arrays(
            seg.segment_name, seg.num_docs, columns_of(segs["jax"][0]),
            table_name="sales")
    st = rm.stage(seg)
    st.column("region")
    assert rm.demote(seg.segment_name)
    st = rm.stage(reloaded)
    st.column("region")
    assert st.segment is reloaded
    snap = rm.stats_snapshot()
    assert snap["promotions"] == 0 and snap["hostDrops"] == 1
    assert rm.host_bytes() == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_eviction_demotes_instead_of_dropping(segs, pkg):
    rm = (j_residency.ResidencyManager(budget_bytes=0) if pkg == "jax"
          else ResidencyManager(budget_bytes=0, device="cpu"))
    for s in segs[pkg][:3]:
        st = rm.stage(s)
        for c in COLUMNS:
            st.column(c)
    per_seg = rm.staged_bytes() // 3
    rm.set_budget_bytes(int(per_seg * 1.5))
    assert rm.stats_snapshot()["demotions"] == 2
    assert rm.host_entry_count() == 2 and rm.host_bytes() > 0
    rm.set_budget_bytes(0)
    for s in segs[pkg][:3]:
        st = rm.stage(s)
        for c in COLUMNS:
            st.column(c)
    assert rm.stats_snapshot()["promotions"] == 2


# --------------------------------------------------------------------------
# the executors under a budget, against the JAX executors
# --------------------------------------------------------------------------

def test_query_parity_under_demote_promote_churn(segs, oracle):
    """The per-segment executors with a budget of about two segments:
    every segment churns through demote and promote, the rows equal the
    JAX executor's and the uncapped oracle's."""
    pair = _pair(False, _est(segs, 2.5))
    for _ in range(2):
        for name, sql in SQLS.items():
            jstats, tstats = _both(pair, segs, sql)
            _assert_rows(pair[1].execute(t_compile(sql), segs["port"])[0]
                         .rows, oracle["rows"][name])
            assert tstats.staging["spills"] == 0
            assert tstats.staging["stagedBytes"] <= _est(segs, 2.5)["port"]
    snap = pair[1].residency.stats_snapshot()
    assert snap["demotions"] > 0 and snap["promotions"] > 0
    assert snap["spills"] == 0


@pytest.mark.parametrize("frac", [4, 10])
def test_sliced_combine_parity_at_fraction_of_working_set(segs, oracle,
                                                          frac):
    budgets = {k: v // frac for k, v in oracle["ws"].items()}
    pair = _pair(True, budgets)
    for name, sql in SQLS.items():
        jstats, tstats = _both(pair, segs, sql)
        _assert_rows(pair[1].execute(t_compile(sql), segs["port"])[0].rows,
                     oracle["rows"][name])
        assert _decisions(tstats) == {
            "residency:resident_device->sliced_device:"
            "working_set_over_budget_sliceable": 1}
        assert tstats.staging["spills"] == 0
        assert tstats.staging["slices"] >= 2
        assert tstats.staging["demotions"] >= 1
        # ws/4 slices hold several segments: one batch launch a slice;
        # ws/10 slices one segment each, on the per-segment path
        assert tstats.launch.get("launches", 0) >= (2 if frac == 4 else 0)
    # a repeated pass: the slices come back from the host tier
    jstats, tstats = _both(pair, segs, GROUP_SQL)
    assert tstats.staging["promotions"] >= 1
    snap = pair[1].residency.stats_snapshot()
    assert snap["slicedQueries"] >= 3 and snap["spills"] == 0
    assert snap["stagedBytes"] <= budgets["port"]


def test_slice_pad_over_budget_degrades_to_per_segment_slices(segs,
                                                             oracle):
    """A budget just over one segment's estimate: admission slices, but no
    slice fits the fill share of the free budget, so the per-segment
    sliced path serves, with the JAX executor's decision."""
    pair = _pair(True, _est(segs, 1.1))
    jstats, tstats = _both(pair, segs, GROUP_SQL)
    assert _decisions(tstats) == {
        "residency:resident_device->sliced_device:"
        "working_set_over_budget_sliceable": 1,
        "sharded_combine:sharded_sliced->per_segment_sliced:"
        "slice_pad_over_budget": 1}
    assert tstats.staging["spills"] == 0
    assert tstats.staging["slices"] == jstats.staging["slices"] \
        == NUM_SEGMENTS


def test_single_segment_over_budget_still_spills(segs):
    pair = _pair(True, {"jax": 64, "port": 64})
    jstats, tstats = _both(pair, segs, GROUP_SQL)
    assert _decisions(tstats) == {
        "residency:device->host_engine:single_segment_over_budget": 1}
    assert tstats.staging["spills"] == 1 and tstats.staging["slices"] == 0
    assert tstats.launch == {}


def test_selection_is_not_sliceable(segs):
    sql = "SELECT region, qty FROM sales ORDER BY qty, region LIMIT 5"
    pair = _pair(True, _est(segs, 2.5))
    jstats, tstats = _both(pair, segs, sql)
    assert _decisions(tstats) == {
        "residency:device->host_engine:"
        "working_set_over_budget_not_sliceable": 1}
    assert tstats.staging["spills"] == 1 and tstats.staging["slices"] == 0
    assert tstats.topk_launches == 0


def test_slicing_disabled_by_config_restores_spill(segs):
    cfg = {JConstants.HBM_SLICING_ENABLED_KEY: "false"}
    assert CommonConstants.HBM_SLICING_ENABLED_KEY == \
        JConstants.HBM_SLICING_ENABLED_KEY
    pair = _pair(True, _est(segs, 3), config=cfg)
    jstats, tstats = _both(pair, segs, GROUP_SQL)
    assert _decisions(tstats) == {
        "residency:device->host_engine:"
        "working_set_over_budget_not_sliceable": 1}
    assert tstats.staging["spills"] == 1


def test_staged_bytes_stay_under_the_budget_after_every_query(segs,
                                                             oracle):
    budgets = {k: v // 3 for k, v in oracle["ws"].items()}
    for sharded in (False, True):
        pair = _pair(sharded, budgets)
        for _ in range(2):
            for sql in SQLS.values():
                _both(pair, segs, sql)
                assert pair[1].residency.staged_bytes() <= budgets["port"]


# --------------------------------------------------------------------------
# the host tier's own budget
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_host_tier_lru_drop_under_its_own_budget(segs, pkg):
    rm = (j_residency.ResidencyManager(budget_bytes=0) if pkg == "jax"
          else ResidencyManager(budget_bytes=0, device="cpu"))
    for s in segs[pkg][:3]:
        st = rm.stage(s)
        for c in COLUMNS:
            st.column(c)
    per_seg = rm.staged_bytes() // 3
    rm.set_host_budget_bytes(int(per_seg * 1.5))
    rm.set_budget_bytes(1)
    snap = rm.stats_snapshot()
    assert snap["demotions"] == 3 and snap["hostDrops"] >= 2
    assert rm.host_bytes() <= int(per_seg * 1.5)
    assert rm.host_entry_names() == [segs[pkg][2].segment_name]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_host_tier_disabled_drops_on_eviction(segs, pkg):
    rm = (j_residency.ResidencyManager(budget_bytes=0) if pkg == "jax"
          else ResidencyManager(budget_bytes=0, device="cpu"))
    rm.set_host_tier_enabled(False)
    rm.stage(segs[pkg][0]).column("region")
    rm.set_budget_bytes(1)
    snap = rm.stats_snapshot()
    assert snap["evictions"] == 1 and snap["demotions"] == 0
    assert rm.host_entry_count() == 0


def test_host_tier_disabled_by_config(segs):
    cfg = PinotConfiguration({CommonConstants.HOSTRAM_ENABLED_KEY: "false"},
                             use_env=False)
    rm = ResidencyManager(budget_bytes=0, config=cfg, device="cpu")
    assert not rm.host_tier_enabled()


def test_evict_drops_both_tiers(segs):
    rm = ResidencyManager(budget_bytes=0, device="cpu")
    _stage_full(rm, segs["port"][0])
    assert rm.demote(segs["port"][0].segment_name)
    assert rm.host_entry_count() == 1
    rm.evict(segs["port"][0].segment_name)
    assert rm.host_entry_count() == 0 and rm.host_bytes() == 0
    assert rm.stats_snapshot()["hostDrops"] == 1


def test_snapshot_reports_both_tiers(segs):
    rm = ResidencyManager(budget_bytes=0, device="cpu")
    _stage_full(rm, segs["port"][0])
    _stage_full(rm, segs["port"][1])
    assert rm.demote(segs["port"][0].segment_name)
    snap = rm.snapshot()
    assert segs["port"][1].segment_name in snap["stagedSegments"]
    tier = snap["hostTier"]
    assert tier["enabled"] is True
    assert tier["entries"][segs["port"][0].segment_name]["bytes"] > 0
    assert tier["hostBytes"] == sum(e["bytes"]
                                    for e in tier["entries"].values())
    assert tier["peakBytes"] >= tier["hostBytes"]


# --------------------------------------------------------------------------
# pins and the eviction ranking
# --------------------------------------------------------------------------

def test_lease_pins_survive_demotion_pressure(segs):
    seg = segs["port"][0]
    rm = ResidencyManager(budget_bytes=0, device="cpu")
    lease = QueryLease()
    st = _stage_full(rm, seg, lease=lease)
    rm.set_budget_bytes(1)
    assert seg.segment_name in rm.resident_names()
    assert rm.host_entry_count() == 0
    assert st.column("region").fwd is not None
    stats = QueryStats()
    rm.end_query(lease, stats)
    assert rm.host_entry_names() == [seg.segment_name]
    assert stats.staging["demotions"] == 1 and stats.staging["hostBytes"] > 0
    st2 = _stage_full(rm, seg)
    assert rm.stats_snapshot()["promotions"] == 1 and st2.segment is seg


def test_eviction_prefers_cheap_to_restage_over_pure_lru(segs):
    rm = ResidencyManager(budget_bytes=0, device="cpu")
    tsegs = segs["port"]
    _stage_full(rm, tsegs[0])  # cold build, older
    _stage_full(rm, tsegs[1])  # newer, about to gain host backing
    with rm._lock:
        rm._host_entries[tsegs[1].segment_name] = t_residency._Entry(
            SegmentHostImage(tsegs[1]))
        c0 = rm._rebuild_cost_locked(tsegs[0].segment_name,
                                     rm._entries[tsegs[0].segment_name])
        c1 = rm._rebuild_cost_locked(tsegs[1].segment_name,
                                     rm._entries[tsegs[1].segment_name])
    assert c0 == COST_COLUMN_BUILD and c1 == COST_HOST_RESTAGE
    per = rm.staged_bytes() // 2
    rm.set_budget_bytes(int(per * 1.5))
    assert rm.resident_names() == [tsegs[0].segment_name]


def test_startree_residents_rank_expensive(segs):
    rm = ResidencyManager(budget_bytes=0, device="cpu")
    st = StagedSegment(segs["port"][0], device="cpu")
    st._startree[0] = {"stdim:a": torch.zeros(4, dtype=torch.int32)}
    with rm._lock:
        assert rm._rebuild_cost_locked("x", t_residency._Entry(st)) \
            == COST_STARTREE_BUILD


# --------------------------------------------------------------------------
# admission-estimate drift
# --------------------------------------------------------------------------

def test_estimate_drift_correction_feeds_admission(segs, monkeypatch):
    real = t_residency.estimate_segment_bytes
    monkeypatch.setattr(t_residency, "estimate_segment_bytes",
                        lambda s, c: max(1, real(s, c) // 4))
    tsegs = segs["port"]
    rm = ResidencyManager(budget_bytes=0, device="cpu")
    est = t_residency.estimate_segment_bytes(tsegs[0], COLUMNS)
    # the measured bytes of a staged segment, about 4x the estimate
    probe = ResidencyManager(budget_bytes=0, device="cpu")
    measured = probe.stage(tsegs[0])
    measured.packed_column("region")
    measured.value_column("qty")
    measured.packed_column("qty")
    assert measured.nbytes() >= 3 * est
    rm.set_budget_bytes(int(est * 5))
    lease = rm.begin_query(tsegs[:2], COLUMNS, sliceable=True)
    assert lease.device_allowed and not lease.sliced
    for s in tsegs[:2]:
        st = rm.stage(s, lease=lease)
        st.packed_column("region")
        st.packed_column("qty")
        st.value_column("qty")
    rm.end_query(lease, QueryStats())
    assert rm.est_observations >= 2
    assert rm.estimate_scale() > 1.3
    for _ in range(8):
        rm.observe_estimate(est, est * 4)
    lease2 = rm.begin_query(tsegs[:2], COLUMNS, sliceable=True)
    assert lease2.sliced
    chunks = rm.plan_slices(tsegs[:4], COLUMNS, lease2)
    assert chunks is not None and max(len(c) for c in chunks) <= 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_observe_estimate_clamps(pkg):
    rm = (j_residency.ResidencyManager(budget_bytes=0) if pkg == "jax"
          else ResidencyManager(budget_bytes=0, device="cpu"))
    for _ in range(100):
        rm.observe_estimate(1, 1000)
    assert rm.estimate_scale() <= 4.0
    for _ in range(100):
        rm.observe_estimate(1000, 1)
    assert rm.estimate_scale() >= 0.25


def test_tier_stats_merge_counters_sum_bytes_max():
    a = QueryStats(staging={"promotions": 1, "demotions": 2, "slices": 3,
                            "hostBytes": 100, "stagedBytes": 10})
    b = QueryStats(staging={"promotions": 2, "demotions": 1, "slices": 1,
                            "hostBytes": 40, "stagedBytes": 20})
    a.merge(b)
    assert a.staging == {"promotions": 3, "demotions": 3, "slices": 4,
                         "hostBytes": 100, "stagedBytes": 20}


# --------------------------------------------------------------------------
# churn while querying
# --------------------------------------------------------------------------

def test_churn_while_querying_hammer(segs, oracle):
    dev = ShardedQueryExecutor(device="cpu",
                               hbm_budget_bytes=oracle["ws"]["port"] // 4)
    ctxs = {name: t_compile(sql) for name, sql in SQLS.items()}
    stop = threading.Event()
    errors = []

    def querier(name):
        while not stop.is_set():
            try:
                rt, _ = dev.execute(ctxs[name], segs["port"])
                _assert_rows(rt.rows, oracle["rows"][name])
            except BaseException as e:  # noqa: BLE001 - surfaced below
                errors.append(e)
                return

    def churner():
        while not stop.is_set():
            for s in segs["port"][::3]:
                try:
                    dev.residency.demote(s.segment_name)
                except Exception as e:  # pragma: no cover - failure mode
                    errors.append(e)
                    return

    threads = [threading.Thread(target=querier, args=(n,))
               for n in SQLS for _ in range(2)]
    threads.append(threading.Thread(target=churner))
    for t in threads:
        t.start()
    stop.wait(2.0)
    stop.set()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    snap = dev.residency.snapshot()
    by_resident = sum(e["bytes"] for e in snap["stagedSegments"].values())
    assert snap["stagedBytes"] == by_resident >= 0
    tier = snap["hostTier"]
    assert tier["hostBytes"] == sum(e["bytes"]
                                    for e in tier["entries"].values()) >= 0


def test_chip_smoke_phase13_on_cpu():
    """chip_smoke.py's phase 13a and 13b at a small size on the CPU: the
    budget's admission, slicing, promotion and spill checks and the
    concurrent clients' coalescing, on SSB segments and the numpy
    oracle (the kernels' own checks run on the card)."""
    import chip_smoke

    from pinot_tpu_torch.tools import ssb as t_ssb

    segs, frames = t_ssb.build_segments(0.01, num_segments=4, seed=3)
    texts = {q: t + " LIMIT 100000" for q, t in t_ssb.QUERIES.items()}
    ctxs = {q: t_compile(t) for q, t in texts.items()}
    parts = {q: [t_ssb.numpy_answer(f, q) for f in frames] for q in texts}
    variant_texts = {**t_ssb.COALESCE_QUERIES, **t_ssb.PROBE_QUERIES}
    ex = ServerQueryExecutor(device="cpu")
    main = {"segs": segs, "ctxs": ctxs,
            "wants": {q: t_ssb.merge_answers(p) for q, p in parts.items()},
            "kept_segs": chip_smoke._kept_segments(ctxs, segs, frames,
                                                   parts),
            "results": {q: ex.execute(c, segs)[0] for q, c in ctxs.items()},
            "per_flight": {q: {"p50_ms": 0.0} for q in ctxs},
            "variant_texts": variant_texts,
            "variant_wants": {v: t_ssb.merge_answers(
                [t_ssb.numpy_answer(f, v) for f in frames])
                for v in variant_texts}}
    run = chip_smoke.phase_budget(main, main["per_flight"], reps=2,
                                  device="cpu")
    flights = run["executors"]["per_segment"]["flights"]
    assert any(r["sliced"] for r in flights.values())
    assert sum(r["promotions"] for r in flights.values()) > 0
    assert run["executors"]["per_segment"]["transfer"]["bytes"] > 0
    co = chip_smoke.phase_coalesce(main, device="cpu")
    assert co["scheduler"]["coalescedLaunches"] > 0
    # C1-C8 from 8 threads, Q2.1, P1-P8 each binding: a probe and a scan
    assert co["scheduler"]["requests"] == 8 * 8 + 8 + 2 * 8
