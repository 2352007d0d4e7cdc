"""The port's multi-segment combine against the JAX package's: the batch
scan's outputs (plain version on the CPU) against the JAX sharded fused
Pallas kernel (interpret mode, the conftest's 8 CPU devices, segments padded
to the mesh), and port ShardedQueryExecutor(device="cpu") rows and stats
against the JAX ShardedQueryExecutor(use_pallas=True) and the JAX host
executor, on 3 SSB segments carried across with segment_from_arrays; then
routing (one segment, unbatchable segments), the bound-query cache, the
plans the fused scan declines (served by the jnp combine) and the device
default.

Tolerance: counts, integer sums, keys, seg_matched and row order exact;
cells that aggregate floats rel 1e-5, abs 1e-6 (tests/test_pallas.py:274):
the JAX kernel sums floats as Neumaier f32 pairs, the port in f64.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.engine.results import QueryStats as JStats  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.results import QueryStats  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel import executor as t_pexec  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import columns_of, segment_from_arrays  # noqa: E402

from tests.test_torch_executor import _assert_rows, _exact_columns  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 18_000
SEED = 5
NOT_BATCHABLE = ("sharded_combine:sharded_combine->per_segment:"
                 "segments_not_batchable")


def carry(jsegs, table):
    return [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                table_name=table) for j in jsegs]


@pytest.fixture(scope="module")
def ssb(tmp_path_factory):
    jsegs = j_ssb.build_segments(
        0, str(tmp_path_factory.mktemp("torch_combine_ssb")), num_segments=3,
        seed=SEED, rows=ROWS, star_tree=False, workers=1)
    return jsegs, carry(jsegs, "ssb_lineorder")


@pytest.fixture(scope="module")
def executors():
    return {"port": ShardedQueryExecutor(device="cpu"),
            "sharded": JSharded(use_pallas=True),
            "host": JExecutor(use_device=False)}


def _leaf_equal(got, want, exact, what):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            _leaf_equal(g, w, exact, what)
        return
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if exact:
        np.testing.assert_array_equal(got, want, what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=what)


@pytest.mark.parametrize("qid", sorted(j_ssb.QUERIES))
def test_batch_scan_matches_jax_sharded_kernel(ssb, executors, qid):
    """Outputs of one batch scan against build_sharded_pallas_kernel's."""
    jsegs, tsegs = ssb
    sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
    jstats = JStats()
    _, jout, jplan = executors["sharded"]._run_sharded(
        j_compile(sql), jsegs, jstats)
    tstats = QueryStats()
    tbatch, tout, tplan = executors["port"]._run_sharded(
        t_compile(sql), tsegs, tstats)
    assert tplan.spec == jplan.spec
    assert tplan.group_bases == jplan.group_bases
    S = tbatch.num_segments
    assert len(jout["seg_matched"]) == 8          # JAX pads S to its mesh
    np.testing.assert_array_equal(tout["seg_matched"],
                                  jout["seg_matched"][:S])
    assert not jout["seg_matched"][S:].any()
    key = "presence" if jplan.spec[2] else "num_matched"
    _leaf_equal(tout[key], jout[key], True, key)
    for i, aspec in enumerate(jplan.spec[1]):
        _leaf_equal(tout[f"agg{i}"], jout[f"agg{i}"], aspec[3] != "f32",
                    f"{qid} agg{i}")
    for field in ("num_segments_processed", "num_docs_scanned",
                  "num_segments_matched", "total_docs"):
        assert getattr(tstats, field) == getattr(jstats, field), field


@pytest.mark.parametrize("qid", sorted(j_ssb.QUERIES))
def test_rows_match_jax_sharded_and_host(ssb, executors, qid):
    jsegs, tsegs = ssb
    sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
    got, stats = executors["port"].execute(t_compile(sql), tsegs)
    exact = _exact_columns(sql, tsegs[0])
    decisions = {}
    for ref in ("sharded", "host"):
        want, wstats = executors[ref].execute(j_compile(sql), jsegs)
        decisions.setdefault(ref, wstats.decisions)
        assert got.schema.column_names == want.schema.column_names
        _assert_rows(got.rows, want.rows, exact, f"{ref}: {sql}")
        # both prune the same segments first; one segment left takes the
        # per-segment path
        for field in ("num_docs_scanned", "num_segments_matched",
                      "num_segments_processed", "num_segments_pruned",
                      "total_docs"):
            assert getattr(stats, field) == getattr(wstats, field), \
                (ref, field)
    # none over the batch; where the pruner keeps one segment, the index
    # rung's decline on it (the segments carry no index)
    assert stats.decisions == decisions["sharded"]
    assert not stats.decisions or stats.num_segments_processed == 1
    # the plain version on the CPU is no kernel launch
    assert (stats.scan_launches, stats.probe_launches,
            stats.sharded_scan_launches, stats.sharded_probe_launches) == \
        (0, 0, 0, 0)


def test_single_segment_takes_per_segment_path(ssb, executors):
    jsegs, tsegs = ssb
    sql = j_ssb.QUERIES["Q2.1"] + " LIMIT 100000"
    ex = ShardedQueryExecutor(device="cpu")
    got, stats = ex.execute(t_compile(sql), tsegs[:1])
    assert ex._batches == {} and ex._param_cache == {}
    _, jstats = executors["sharded"].execute(j_compile(sql), jsegs[:1])
    assert stats.decisions == jstats.decisions == {
        "index:index_gather->scan:index_missing_index": 1}
    assert stats.num_segments_processed == 1
    want, _ = executors["host"].execute(j_compile(sql), jsegs[:1])
    _assert_rows(got.rows, want.rows, _exact_columns(sql, tsegs[0]), sql)
    per_seg, _ = ServerQueryExecutor(device="cpu").execute(t_compile(sql),
                                                           tsegs[:1])
    assert got.rows == per_seg.rows


def test_batch_cache_keeps_the_recent_batches(ssb):
    """Past the residency budget the least recently used batch goes, with
    its bound queries, to the host tier; asked for again, it is adopted
    from there."""
    _, tsegs = ssb
    # no time filter: the pruner keeps every segment of each subset
    ctx = t_compile(j_ssb.QUERIES["Q2.1"] + " LIMIT 100000")
    subsets = [(0, 1), (0, 2), (0, 1), (1, 2)]
    sizer = ShardedQueryExecutor(device="cpu")
    size = {}
    for sub in set(subsets):
        sizer.execute(ctx, [tsegs[i] for i in sub])
        size[sub] = sizer.batch_for([tsegs[i] for i in sub])[1].nbytes()
    # room for any two of the three batches, not for all three
    ex = ShardedQueryExecutor(device="cpu",
                              hbm_budget_bytes=sum(size.values()) - 1)
    rows = {}
    for sub in subsets:
        table, stats = ex.execute(ctx, [tsegs[i] for i in sub])
        rows.setdefault(sub, table.rows)
        assert table.rows == rows[sub]
        assert stats.launch["launches"] == 1 and not stats.decisions
    assert ex.batches_staged == 3
    names = lambda sub: tuple(tsegs[i].segment_name for i in sub)  # noqa: E731
    assert list(ex._batches) == [names((0, 1)), names((1, 2))]
    batch_names = {b.segment_name for b, _ in ex._batches.values()}
    assert {k[1] for k in ex._param_cache} == batch_names
    assert ex.residency.host_entry_names() == [
        "batch(" + ",".join(names((0, 2))) + ")"]
    table, _ = ex.execute(ctx, [tsegs[0], tsegs[2]])
    assert table.rows == rows[(0, 2)]
    assert ex.batches_staged == 4 and ex.batches_adopted == 1
    assert list(ex._batches) == [names((1, 2)), names((0, 2))]
    assert ex.residency.staged_bytes() <= sum(size.values()) - 1
    # a budget of one byte demotes every batch no query pins
    ex.residency.set_budget_bytes(1)
    assert ex._batches == {} and ex._param_cache == {}
    # the default: the card's memory times 0.75, no bound on the CPU
    assert sizer.residency.budget_bytes is None
    assert len(sizer._batches) == 3 and sizer.batches_staged == 3


def _pair(out, schemas):
    """Two JAX-built segments (one schema each) and their port copies."""
    rng = np.random.default_rng(3)
    jsegs = []
    for i, fields in enumerate(schemas):
        n = 3000 + 500 * i
        frame = {"k": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
                 "v": rng.integers(0, 100, n), "w": rng.integers(0, 9, n)}
        schema = Schema("t", [FieldSpec("k", DataType.STRING)] + [
            FieldSpec(c, dt, FieldType.METRIC) for c, dt in fields])
        SegmentBuilder(schema, f"t_{i}").build(
            {f.name: frame[f.name] for f in schema.field_specs}, str(out))
        jsegs.append(load_segment(str(out / f"t_{i}")))
    return jsegs, carry(jsegs, "t")


@pytest.mark.parametrize("schemas", [
    ([("v", DataType.INT)], [("v", DataType.INT), ("w", DataType.INT)]),
    ([("v", DataType.INT)], [("v", DataType.LONG)]),
], ids=["schemas differ", "column layout differs"])
def test_unbatchable_segments_take_per_segment_path(tmp_path, schemas):
    jsegs, tsegs = _pair(tmp_path, schemas)
    sql = "SELECT k, sum(v), count(*) FROM t GROUP BY k ORDER BY k"
    got, stats = ShardedQueryExecutor(device="cpu").execute(
        t_compile(sql), tsegs)
    want, wstats = JSharded(use_pallas=True).execute(j_compile(sql), jsegs)
    assert stats.decisions == {NOT_BATCHABLE: 1}
    assert wstats.decisions.get(NOT_BATCHABLE) == 1
    assert got.rows == want.rows
    assert stats.num_segments_processed == 2


def test_repeated_query_binds_once(ssb, monkeypatch):
    _, tsegs = ssb
    calls = {"plan": 0, "bind": 0}
    real_plan, real_bind = t_pexec.plan_segment, t_pexec.fused_scan.scan_inputs

    def plan(*a, **k):
        calls["plan"] += 1
        return real_plan(*a, **k)

    def bind(*a, **k):
        calls["bind"] += 1
        return real_bind(*a, **k)

    monkeypatch.setattr(t_pexec, "plan_segment", plan)
    monkeypatch.setattr(t_pexec.fused_scan, "scan_inputs", bind)
    ex = ShardedQueryExecutor(device="cpu")
    # Q3.2's years keep every segment (Q4.3's keep one: no batch)
    ctx = t_compile(j_ssb.QUERIES["Q3.2"] + " LIMIT 100000")
    first, _ = ex.execute(ctx, tsegs)
    inp = next(iter(ex._param_cache.values()))
    assert inp.probe is not None          # Q3.2 probes at binding
    second, _ = ex.execute(ctx, tsegs)
    assert calls == {"plan": 1, "bind": 1}
    assert second.rows == first.rows
    assert next(iter(ex._param_cache.values())) is inp
    # a reloaded segment (same name, new object) rebuilds and rebinds
    reloaded = carry([tsegs[1]], "ssb_lineorder")
    third, _ = ex.execute(ctx, [tsegs[0], reloaded[0], tsegs[2]])
    assert calls == {"plan": 2, "bind": 2}
    assert third.rows == first.rows
    assert len(ex._batches) == 1 and len(ex._param_cache) == 1


@pytest.mark.parametrize("sql,reason", [
    ("SELECT count(DISTINCT c_city) FROM ssb_lineorder",
     "pallas_distinct_agg"),
    ("SELECT max(lo_extendedprice * lo_discount) FROM ssb_lineorder",
     "pallas_minmax_not_f32_exact"),
])
def test_declined_batch_plan_raises_not_ported(ssb, sql, reason):
    """The fused scan's decline over the batch is recorded once and the
    jnp combine serves: equal to the JAX sharded executor's rows, stats and
    decisions."""
    jsegs, tsegs = ssb
    got, stats = ShardedQueryExecutor(device="cpu").execute(t_compile(sql),
                                                            tsegs)
    want, jstats = JSharded(use_pallas=True).execute(j_compile(sql), jsegs)
    # a distinct count and a max of integer products: exact
    _assert_rows(got.rows, want.rows, [True], sql)
    assert stats.decisions == jstats.decisions == {
        f"pallas:pallas_combine->jnp_combine:{reason}": 1}
    for field in ("num_docs_scanned", "num_segments_matched",
                  "num_segments_processed"):
        assert getattr(stats, field) == getattr(jstats, field), field
    assert stats.batch_general_launches == 1


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedQueryExecutor()


def test_parallel_import_leaves_jax_unloaded():
    code = ("import sys, pinot_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pinot_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


RAW_BATCH_SQL = [
    "SELECT team, count(*), sum(salary), min(salary), max(bonus), "
    "avg(ratio) FROM stats WHERE league = 'AL' GROUP BY team ORDER BY team",
    "SELECT sum(big), sum(salary), count(*) FROM stats",
]


@pytest.fixture(scope="module")
def stats_segs(tmp_path_factory):
    from tests.test_torch_columns import build_stats

    return build_stats(tmp_path_factory.mktemp("torch_combine_stats"))


@pytest.mark.parametrize("i", range(len(RAW_BATCH_SQL)))
def test_raw_value_columns_on_the_batch(stats_segs, i):
    """Raw value columns (an i64 one among them; no packed column in the
    second query) ride one batch scan: rows and stats equal the JAX
    sharded executor's (its fused kernel in interpret mode) and its host
    engine's; a raw filter leaf the fused scan declines raises."""
    jsegs, tsegs = stats_segs
    sql = RAW_BATCH_SQL[i]
    got, stats = ShardedQueryExecutor(device="cpu").execute(t_compile(sql),
                                                            tsegs)
    exact = _exact_columns(sql, tsegs[0])
    for ref in (JSharded(use_pallas=True), JExecutor(use_device=False)):
        want, wstats = ref.execute(j_compile(sql), jsegs)
        _assert_rows(got.rows, want.rows, exact, sql)
        assert stats.num_docs_scanned == wstats.num_docs_scanned
    assert stats.decisions == {} and stats.general_launches == 0
    sql = "SELECT count(*) FROM stats WHERE salary > 100000"
    got, stats = ShardedQueryExecutor(device="cpu").execute(t_compile(sql),
                                                            tsegs)
    want, jstats = JSharded(use_pallas=True).execute(j_compile(sql), jsegs)
    assert got.rows == want.rows
    assert stats.decisions == jstats.decisions == {
        "pallas:pallas_combine->jnp_combine:pallas_vrange": 1}
    assert stats.num_docs_scanned == jstats.num_docs_scanned
