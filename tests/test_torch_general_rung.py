"""The general rung end to end: SQL -> port ServerQueryExecutor(device=
"cpu") with and without the fused scan -> rows, against the JAX executor
on its jnp rung (use_pallas=False), with its fused kernel first
(use_pallas=True, interpret mode, the jnp rung on decline) and its host
engine, on the same segments carried across with segment_from_arrays.

With the fused scan off the port is held to JAX use_pallas=False, with it
on to JAX use_pallas=True: rows, group_by_rung, the segments pruned and
processed, total_docs and num_docs_scanned, and (fused scan on) the
decline reason codes with their counts. Queries: tests/test_hash_groupby
.py's wide and tied shapes and SELECTIVE_SQL, tests/test_engine.py's
DISTINCTCOUNT queries, tests/test_sketches.py's device DISTINCTCOUNTHLL
queries, the declined SSB queries G1-G5 and the 13 SSB flights.

Tolerance: counts, integer sums, min/max, keys, distinct counts and HLL
estimates exact; float sums rel 1e-5, abs 1e-6.
"""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JaxExecutor  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.tools import ssb as t_ssb  # noqa: E402

from tests.test_hash_groupby import SELECTIVE_SQL  # noqa: E402
from tests.test_torch_executor import _assert_rows, carry  # noqa: E402

ROWS = 18_000
SEED = 5


def _build(out, schema, frames):
    segs = []
    for i, frame in enumerate(frames):
        SegmentBuilder(schema, f"{schema.schema_name}_{i}").build(frame,
                                                                  str(out))
        segs.append(load_segment(str(out / f"{schema.schema_name}_{i}")))
    return segs, carry(segs, schema.schema_name)


def _hash_frame(seed, correlated):
    """tests/test_hash_groupby.py's wide_segs / tied_segs frame."""
    rng = np.random.default_rng(seed)
    n = 20_000
    ai = rng.integers(0, 150, n)
    frame = {"a": [f"a{i:03d}" for i in ai]}
    if correlated:
        frame["b"] = [f"b{i:03d}" for i in ai]
    else:
        frame["b"] = [f"b{i:03d}" for i in rng.integers(0, 150, n)]
    frame["year"] = rng.integers(2000, 2004, n).tolist()
    frame["v"] = rng.integers(0, 100, n).tolist()
    return frame


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_general")
    got = {}
    hw = Schema("hw", [FieldSpec("a", DataType.STRING),
                       FieldSpec("b", DataType.STRING),
                       FieldSpec("year", DataType.INT),
                       FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    for key, seed, corr in (("wide", 11, False), ("tied", 12, True)):
        frame = _hash_frame(seed, corr)
        got[key] = _build(out / key, hw, [frame, frame])
    # tests/test_engine.py's stats table, its single-value columns
    rng = np.random.default_rng(7)
    n = 3000
    teams = ["ATL", "BOS", "CHC", "NYA", "SFO", "LAD", "HOU"]
    stats = {"team": [teams[i] for i in rng.integers(0, 7, n)],
             "league": [("AL", "NL")[i] for i in rng.integers(0, 2, n)],
             "year": rng.integers(1990, 2021, n).tolist(),
             "runs": rng.integers(0, 150, n).tolist(),
             "score": np.round(rng.normal(50, 12, n), 3).tolist()}
    got["stats"] = _build(out / "stats", Schema("stats", [
        FieldSpec("team", DataType.STRING),
        FieldSpec("league", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("runs", DataType.LONG, FieldType.METRIC),
        FieldSpec("score", DataType.DOUBLE, FieldType.METRIC)]),
        [{c: v[:n // 2] for c, v in stats.items()},
         {c: v[n // 2:] for c, v in stats.items()}])
    # tests/test_sketches.py's TestDeviceHLL segments
    rng = np.random.default_rng(23)
    n = 30_000
    ev = {"user": np.array([f"u{i}" for i in range(8000)])[
              rng.integers(0, 8000, n)].tolist(),
          "grp": np.array(["a", "b", "c"])[rng.integers(0, 3, n)].tolist(),
          "lat": np.round(rng.gamma(3, 25, n), 3).tolist()}
    got["events"] = _build(out / "events", Schema("events", [
        FieldSpec("user", DataType.STRING), FieldSpec("grp", DataType.STRING),
        FieldSpec("lat", DataType.DOUBLE, FieldType.METRIC)]),
        [{c: v[:n // 2] for c, v in ev.items()},
         {c: v[n // 2:] for c, v in ev.items()}])
    jssb = j_ssb.build_segments(0, str(out / "ssb"), num_segments=2,
                                seed=SEED, rows=ROWS, star_tree=False,
                                workers=1)
    got["ssb"] = (jssb, carry(jssb, "ssb_lineorder"))
    return got


@pytest.fixture(scope="module")
def executors():
    return {"port_on": ServerQueryExecutor(device="cpu"),
            "port_off": ServerQueryExecutor(device="cpu",
                                            use_fused_scan=False),
            "jnp": JaxExecutor(use_device=True, use_pallas=False),
            "pallas": JaxExecutor(use_device=True, use_pallas=True),
            "host": JaxExecutor(use_device=False)}


def _exact_columns(sql, tseg, host=False):
    """Per select column: False for an aggregation that sums floats, and
    against the host engine (f64 over the raw values, where the device
    paths read f32) for every aggregation of floats."""
    ctx = t_compile(sql)
    spec = t_plan(ctx, tseg).spec[1]
    loose = {str(fn) for fn, a in zip(ctx.aggregations, spec)
             if len(a) > 3 and a[3] == "f32"
             and (host or a[0] in ("sum", "avg"))}
    return [str(e) not in loose for e in ctx.select_expressions]


def _pallas_decisions(stats):
    return {k: v for k, v in stats.decisions.items()
            if k.startswith("pallas:")}


def _index_decisions(stats):
    return {k: v for k, v in stats.decisions.items()
            if k.startswith("index:")}


def _check(data, executors, key, sql):
    """-> (port stats with the fused scan off, with it on)."""
    jsegs, tsegs = data[key]
    exact = _exact_columns(sql, tsegs[0])
    exact_host = _exact_columns(sql, tsegs[0], host=True)
    host, _ = executors["host"].execute(j_compile(sql), jsegs)
    out = []
    for port, ref in (("port_off", "jnp"), ("port_on", "pallas")):
        got, stats = executors[port].execute(t_compile(sql), tsegs)
        want, jstats = executors[ref].execute(j_compile(sql), jsegs)
        assert got.schema.column_names == want.schema.column_names
        _assert_rows(got.rows, want.rows, exact, f"{ref}: {sql}")
        _assert_rows(got.rows, host.rows, exact_host, f"host: {sql}",
                     same_types=False)
        # both executors prune the same segments, so whole stats compare
        assert (stats.num_segments_processed, stats.num_segments_pruned,
                stats.total_docs) == (jstats.num_segments_processed,
                                      jstats.num_segments_pruned,
                                      jstats.total_docs), (port, sql)
        assert stats.group_by_rung == jstats.group_by_rung, (port, sql)
        assert stats.num_docs_scanned == jstats.num_docs_scanned, (port, sql)
        # the index rung's outcome per segment (its declines, on segments
        # without an index) is JAX's
        assert _index_decisions(stats) == _index_decisions(jstats), (port,
                                                                     sql)
        if port == "port_on":
            assert _pallas_decisions(stats) == _pallas_decisions(jstats), sql
        out.append(stats)
    return out


WIDE_SQL = [
    SELECTIVE_SQL,
    "SELECT a, b, year, sum(v), count(*) FROM hw "
    "WHERE a IN ('a001', 'a002', 'a003') "
    "GROUP BY a, b, year ORDER BY a, b, year LIMIT 15000",
    "SELECT a, b, sum(v), count(*) FROM hw WHERE a < 'a060' "
    "GROUP BY a, b ORDER BY a, b LIMIT 15000",
    "SELECT a, b, year, sum(v) FROM hw WHERE a = 'a001' OR b = 'b140' "
    "GROUP BY a, b, year ORDER BY a, b, year LIMIT 15000",
]


@pytest.mark.parametrize("i", range(len(WIDE_SQL)))
def test_wide_matches_jax(data, executors, i):
    _check(data, executors, "wide", WIDE_SQL[i])


def test_selective_query_takes_hash_rung(data, executors):
    off, on = _check(data, executors, "wide", SELECTIVE_SQL)
    assert off.group_by_rung == on.group_by_rung == "hash"
    assert off.general_launches == on.general_launches == 2
    assert on.scan_launches == on.probe_launches == 0


def test_tied_full_capacity_matches_jax(data, executors):
    sql = ("SELECT a, b, year, sum(v), count(*), avg(v) FROM hw "
           "GROUP BY a, b, year ORDER BY a, b, year LIMIT 15000")
    off, on = _check(data, executors, "tied", sql)
    assert off.group_by_rung == "hash"


@pytest.mark.parametrize("knob", ["HASH_PROBES", "HASH_LIVE_DOCS"])
def test_forced_sort_fallback_matches_jax(data, monkeypatch, knob):
    """tests/test_hash_groupby.py's forced fallbacks, set in both packages;
    fresh executors, so no kernel built before the patch is reused."""
    from pinot_tpu.engine import kernels as jk
    from pinot_tpu_torch.engine import kernels as tk

    value = {"HASH_PROBES": 0, "HASH_LIVE_DOCS": 64}[knob]
    monkeypatch.setattr(jk, knob, value)
    monkeypatch.setattr(tk, knob, value)
    off, on = _check(data, {
        "port_on": ServerQueryExecutor(device="cpu"),
        "port_off": ServerQueryExecutor(device="cpu", use_fused_scan=False),
        "jnp": JaxExecutor(use_device=True, use_pallas=False),
        "pallas": JaxExecutor(use_device=True, use_pallas=True),
        "host": JaxExecutor(use_device=False)}, "wide", SELECTIVE_SQL)
    assert off.group_by_rung == on.group_by_rung == "sort"


STATS_SQL = [
    "SELECT distinctcount(team), distinctcount(year) FROM stats "
    "WHERE league = 'AL'",
    "SELECT COUNT(DISTINCT team) FROM stats",
    "SELECT count(DISTINCT year), sum(runs), max(score) FROM stats "
    "WHERE team IN ('BOS', 'NYA') AND year >= 2000",
]


@pytest.mark.parametrize("i", range(len(STATS_SQL)))
def test_distinctcount_matches_jax(data, executors, i):
    _check(data, executors, "stats", STATS_SQL[i])


EVENTS_SQL = [
    "SELECT distinctcounthll(user) FROM events",
    "SELECT distinctcounthll(user) FROM events WHERE lat > 20",
    "SELECT grp, distinctcounthll(user) FROM events GROUP BY grp ORDER BY grp",
    "SELECT grp, distinctcounthll(user), count(*) FROM events "
    "GROUP BY grp ORDER BY grp",
]


@pytest.mark.parametrize("i", range(len(EVENTS_SQL)))
def test_distinctcounthll_matches_jax(data, executors, i):
    _check(data, executors, "events", EVENTS_SQL[i])


@pytest.mark.parametrize("gid", sorted(t_ssb.DECLINED_QUERIES))
def test_declined_ssb_queries_match_jax_and_oracle(data, executors, gid):
    sql = t_ssb.DECLINED_QUERIES[gid]
    off, on = _check(data, executors, "ssb", sql)
    reason = t_ssb.DECLINED_REASONS[gid]
    assert any(k.endswith(":" + reason) for k in on.decisions), on.decisions
    assert on.general_launches >= 1
    _, tsegs = data["ssb"]
    frames = [t_ssb.generate_segment_frame(i, 2, n, seed=SEED)
              for i, n in enumerate(t_ssb.segment_rows(2, ROWS))]
    want = t_ssb.declined_answer(frames, gid)
    table, _ = executors["port_on"].execute(t_compile(sql), tsegs)
    assert t_ssb.declined_rows(gid, table.rows) == want


@pytest.mark.parametrize("qid", sorted(j_ssb.QUERIES))
def test_ssb_flights_on_general_rung(data, executors, qid):
    off, on = _check(data, executors, "ssb",
                     j_ssb.QUERIES[qid] + " LIMIT 100000")
    # one rung call per segment the pruner keeps
    assert off.general_launches == off.num_segments_processed
    assert off.scan_launches == 0
    # the fused scan serves every flight when it is on (the index rung
    # declines each segment with JAX's code, held in _check)
    assert on.general_launches == 0 and not _pallas_decisions(on)


def test_gexpr_keys_match_jax(data, executors):
    off, on = _check(data, executors, "ssb",
                     "SELECT d_year * 100 + lo_discount, sum(lo_revenue), "
                     "count(*) FROM ssb_lineorder WHERE lo_quantity < 20 "
                     "GROUP BY d_year * 100 + lo_discount "
                     "ORDER BY d_year * 100 + lo_discount LIMIT 1000")
    assert on.decisions


def test_host_only_plans_still_raise(data, executors):
    """Plans the JAX package sends to its host engine reach the port's
    host engine with the JAX reason code, recorded once per segment, and
    the JAX rows: grouped DISTINCTCOUNT (a planner decline) and more live
    groups than the compact cap (a decode decline, after the rung ran).
    They no longer raise: the host engine is ported."""
    from tests.test_torch_host_engine import assert_same_answer, run

    for key, sql in (
            ("stats", "SELECT team, distinctcount(year) FROM stats "
                      "GROUP BY team"),
            ("wide", "SELECT a, b, year, sum(v) FROM hw "
                     "GROUP BY a, b, year LIMIT 100000")):
        jsegs, tsegs = data[key]
        want = run(executors["pallas"], j_compile, sql, jsegs)
        codes = {k.rsplit(":", 1)[1] for k in want[1].decisions
                 if k.startswith("plan:device_kernel->host_engine:")}
        assert len(codes) == 1, want[1].decisions
        (code,) = codes
        for port, ref in (("port_on", "pallas"), ("port_off", "jnp")):
            got = run(executors[port], t_compile, sql, tsegs)
            assert_same_answer(got, run(executors[ref], j_compile, sql,
                                        jsegs), f"{port}: {sql}")
            stats = got[1]
            assert stats.decisions[
                f"plan:device_kernel->host_engine:{code}"] == len(tsegs)
            assert stats.group_by_rung == "host", (port, sql)


def test_batch_path_still_raises_on_declined_plans(data):
    """A plan the fused scan declines over a segment batch is served by the
    jnp combine, equal to the JAX sharded executor (use_pallas=True, its
    jnp combine on the decline): rows, stats and the decline recorded once
    for the batch. G4's year keeps one segment, which takes the
    per-segment path and its general rung, as in the JAX sharded
    executor."""
    from pinot_tpu.parallel import ShardedQueryExecutor as JSharded
    from pinot_tpu_torch.parallel import ShardedQueryExecutor

    jsegs, tsegs = data["ssb"]
    ex = ShardedQueryExecutor(device="cpu")
    sql = t_ssb.DECLINED_QUERIES["G5"]
    got, stats = ex.execute(t_compile(sql), tsegs)
    want, jstats = JSharded(use_pallas=True).execute(j_compile(sql), jsegs)
    _assert_rows(got.rows, want.rows, [True] * len(want.rows[0]), sql)
    assert stats.decisions == jstats.decisions == {
        "pallas:pallas_combine->jnp_combine:pallas_distinct_agg": 1}
    assert (stats.batch_general_launches, stats.general_launches) == (1, 0)
    assert (stats.num_docs_scanned, stats.num_segments_matched) == (
        jstats.num_docs_scanned, jstats.num_segments_matched)
    _, stats = ex.execute(t_compile(t_ssb.DECLINED_QUERIES["G4"]), tsegs)
    assert (stats.num_segments_pruned, stats.general_launches) == (1, 1)
