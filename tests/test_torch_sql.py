"""The SQL the JAX package serves on its device rungs, in the port: LIKE /
NOT LIKE / REGEXP_LIKE as dictId lookup tables of 1, 9-64 and more than 64
runs (``iv`` leaves, one ``ivs`` node, the general rung's ``lut``), on a
multi-value column (``mv_lut``); TEXT_MATCH and JSON_MATCH; the epoch time
transforms as values and as group keys; HAVING with aliases, LIMIT ...
OFFSET in both spellings and OPTION; and the parse errors, with JAX's
messages.

Every query runs on JAX-built segments carried across with ``columns_of``
through the port with the fused scan on and off and over the batch,
against the JAX executor with ``use_pallas=True`` (interpret mode),
``use_pallas=False``, its sharded executor and its host engine: rows,
rungs, pruned and scanned counts and decline codes; a shape JAX serves
on its host engine reaches the port's host engine with JAX's reason
code. The
text / JSON / FST table is built twice, with the JAX package's text,
JSON and FST indexes and without: the port's per-value tables must give
what JAX's indexes give.

Tolerance: counts, integer sums, min/max and keys exact; float sums
rel 1e-5, abs 1e-6.
"""

import json

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.engine.errors import QueryError as JQueryError  # noqa: E402
from pinot_tpu.engine.plan import PlanError as JPlanError  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import SqlParseError as JSqlParseError  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import (  # noqa: E402
    DataType,
    FieldSpec,
    FieldType,
    IndexingConfig,
    Schema,
)
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine import fused_scan as tfs  # noqa: E402
from pinot_tpu_torch.engine.errors import QueryError  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.plan import _FILTER_PARAMS  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import SqlParseError  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402

from tests.test_torch_columns import build_stats  # noqa: E402
from tests.test_torch_executor import _assert_rows, carry  # noqa: E402
from tests.test_torch_general_rung import (  # noqa: E402,F401
    _check,
    _exact_columns,
    executors,
)

DAY_MS = 86_400_000
T0 = 1_700_006_400_000          # a UTC midnight
WORDS = [f"w{i:02d}" for i in range(40)] + ["quick", "brown", "fox",
                                            "realtime", "analytics"]


def _docs_frame(i, n, rng):
    """Segment ``i`` of two: 14 days of events from T0 + 14 i days."""
    titles = [" ".join(rng.choice(WORDS, rng.integers(3, 9)))
              for _ in range(150)]
    attrs = [json.dumps({"os": ["ios", "android", "web"][k % 3],
                         "ver": int(k % 7),
                         "tags": [f"t{j}" for j in range(k % 4)]})
             for k in range(60)]
    ts = T0 + i * 14 * DAY_MS + rng.integers(0, 14 * DAY_MS, n)
    return {"title": np.array(titles)[rng.integers(0, 150, n)].tolist(),
            "attrs": np.array(attrs)[rng.integers(0, 60, n)].tolist(),
            "jmv": [list(np.array(attrs)[rng.integers(0, 60, 2)])
                    for _ in range(n)],
            "ts": ts.tolist(),
            "day": (ts // DAY_MS).tolist(),
            "kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)].tolist(),
            "v": rng.integers(0, 500, n).tolist()}


def build_docs(out, indexed):
    schema = Schema("docs", [
        FieldSpec("title", DataType.STRING),
        FieldSpec("attrs", DataType.STRING),
        FieldSpec("jmv", DataType.STRING, single_value=False),
        FieldSpec("ts", DataType.LONG),
        FieldSpec("day", DataType.INT),
        FieldSpec("kind", DataType.STRING),
        FieldSpec("v", DataType.INT, FieldType.METRIC)])
    cfg = IndexingConfig(
        no_dictionary_columns=["ts"],
        text_index_columns=["title"] if indexed else [],
        json_index_columns=["attrs"] if indexed else [],
        fst_index_columns=["title", "kind"] if indexed else [])
    rng = np.random.default_rng(31)
    segs = []
    for i in range(2):
        SegmentBuilder(schema, f"docs_{i}", indexing_config=cfg).build(
            _docs_frame(i, 3000, rng), str(out))
        segs.append(load_segment(str(out / f"docs_{i}")))
    return segs, carry(segs, "docs")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp
    jssb = j_ssb.build_segments(0, str(tmp("sql_ssb")), num_segments=2,
                                seed=5, rows=24_000, star_tree=False,
                                workers=1)
    return {"ssb": (jssb, carry(jssb, "ssb_lineorder")),
            "stats": build_stats(tmp("sql_stats")),
            "docs": build_docs(tmp("sql_docs"), indexed=False),
            "docs_ix": build_docs(tmp("sql_docs_ix"), indexed=True)}


def _batch_check(data, key, sql):
    """The port's batch path against the JAX sharded executor: rows, the
    segments pruned, processed and scanned, and the batch's decisions
    (where the fused scan declines the batch, both record the code and
    serve on the jnp combine)."""
    jsegs, tsegs = data[key]
    want, jstats = JSharded(use_pallas=True).execute(j_compile(sql), jsegs)
    got, stats = ShardedQueryExecutor(device="cpu").execute(t_compile(sql),
                                                            tsegs)
    assert ({k: v for k, v in stats.decisions.items()
             if k.startswith(("pallas:", "sharded_combine:"))}
            == {k: v for k, v in jstats.decisions.items()
                if k.startswith(("pallas:", "sharded_combine:"))}), sql
    _assert_rows(got.rows, want.rows, _exact_columns(sql, tsegs[0]),
                 f"batch: {sql}")
    for f in ("num_segments_processed", "num_segments_pruned",
              "num_docs_scanned", "total_docs"):
        assert getattr(stats, f) == getattr(jstats, f), (f, sql)
    return stats


def _lut_runs(data, key, sql):
    """dictId runs of the plan's first lut / mv_lut leaf on segment 0."""
    plan = t_plan(t_compile(sql), data[key][1][0])
    slot = 0

    def find(node):
        nonlocal slot
        if node[0] in ("and", "or", "not"):
            return next((r for r in map(find, node[1]) if r is not None),
                        None)
        if node[0] in ("lut", "mv_lut"):
            return tfs._lut_runs(plan.params[slot], 1 << 30)
        slot += _FILTER_PARAMS[node[0]]
        return None
    return find(plan.spec[0])


# -- LIKE / REGEXP_LIKE ----------------------------------------------------------

# (table, sql, runs of the lut on segment 0 or None, the fused scan's
# decline on the segments that keep it)
PATTERN_SQL = [
    ("ssb", "SELECT d_year, p_brand1, sum(lo_revenue) FROM ssb_lineorder "
            "WHERE p_brand1 LIKE 'MFGR#22%' AND s_region = 'AMERICA' "
            "GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1 LIMIT 1000",
     1, None),
    ("ssb", "SELECT count(*), sum(lo_revenue) FROM ssb_lineorder "
            "WHERE REGEXP_LIKE(p_brand1, '^MFGR#2.*7$')", (9, 64), None),
    ("ssb", "SELECT d_year, sum(lo_revenue) FROM ssb_lineorder "
            "WHERE REGEXP_LIKE(p_brand1, '7$') GROUP BY d_year "
            "ORDER BY d_year", (65, 10 ** 6), "pallas_lut_too_many_runs"),
    ("ssb", "SELECT c_city, s_city, d_year, sum(lo_revenue) "
            "FROM ssb_lineorder WHERE REGEXP_LIKE(c_city, '^UNITED KI[15]$') "
            "AND s_city IN ('UNITED KI1', 'UNITED KI5') "
            "AND d_year BETWEEN 1992 AND 1997 GROUP BY c_city, s_city, d_year "
            "ORDER BY d_year ASC, sum(lo_revenue) DESC", 2, None),
    ("ssb", "SELECT c_nation, sum(lo_revenue) FROM ssb_lineorder "
            "WHERE c_nation NOT LIKE 'UNITED%' AND s_region = 'ASIA' "
            "GROUP BY c_nation ORDER BY c_nation", 1, None),
    ("ssb", "SELECT count(*) FROM ssb_lineorder WHERE c_city LIKE 'CHI_A%' "
            "OR p_brand1 LIKE '%#1_1_'", 1, None),
    ("ssb", "SELECT count(*) FROM ssb_lineorder "
            "WHERE REGEXP_LIKE(s_city, 'zzz')", 0, None),
    ("stats", "SELECT team, count(*) FROM stats WHERE REGEXP_LIKE(team, '^B') "
              "GROUP BY team ORDER BY team", 1, None),
    ("stats", "SELECT count(*) FROM stats WHERE year LIKE '19_5'", 1, None),
    ("stats", "SELECT league, count(*), sum(runs) FROM stats "
              "WHERE tags LIKE 't1%' GROUP BY league ORDER BY league",
     1, "pallas_mv_lut"),
    ("stats", "SELECT count(*) FROM stats WHERE NOT tags LIKE 't_' ", 1,
     "pallas_mv_lut"),
    ("stats", "SELECT count(*), sum(runs) FROM stats "
              "WHERE REGEXP_LIKE(tags, '[13]') AND team NOT LIKE 'N%'",
     2, "pallas_mv_lut"),
]


def _runs_ok(got, want):
    if isinstance(want, tuple):
        return want[0] <= len(got) <= want[1]
    return len(got) == want


@pytest.mark.parametrize("i", range(len(PATTERN_SQL)))
def test_patterns_match_jax(data, executors, i):  # noqa: F811
    key, sql, runs, decline = PATTERN_SQL[i]
    got_runs = _lut_runs(data, key, sql)
    assert _runs_ok(got_runs, runs), (sql, got_runs)
    _off, on = _check(data, executors, key, sql)
    codes = {k.rsplit(":", 1)[1] for k in on.decisions
             if k.startswith("pallas:")}
    assert codes == ({decline} if decline else set()), sql
    _batch_check(data, key, sql)


def test_run_counts_pick_the_fused_shapes(data):
    """1 run: an iv leaf; 9-64 runs: one ivs node; more: declined."""
    _, tsegs = data["ssb"]
    shapes = []
    for sql in (PATTERN_SQL[0][1], PATTERN_SQL[1][1], PATTERN_SQL[2][1]):
        plan = t_plan(t_compile(sql), tsegs[0])
        reasons = []
        pp = tfs.extract_plan(plan, tsegs[0], on_decline=reasons.append)
        shapes.append(pp.filter_tree if pp else reasons)

    def ops(node):
        out = {node[0]}
        if node[0] in ("and", "or", "not"):
            for c in node[1]:
                out |= ops(c)
        return out
    assert "ivs" not in ops(shapes[0]) and "iv" in ops(shapes[0])
    assert "ivs" in ops(shapes[1])
    assert shapes[2] == ["pallas_lut_too_many_runs"]


# -- TEXT_MATCH / JSON_MATCH --------------------------------------------------------

MATCH_SQL = [
    "SELECT kind, count(*) FROM docs WHERE TEXT_MATCH(title, 'quick') "
    "GROUP BY kind ORDER BY kind",
    "SELECT count(*), sum(v) FROM docs "
    "WHERE TEXT_MATCH(title, '\"realtime analytics\" OR fox')",
    "SELECT count(*) FROM docs WHERE TEXT_MATCH(title, 'w1* AND brown')",
    "SELECT count(*), sum(v) FROM docs "
    "WHERE JSON_MATCH(attrs, '\"$.os\" = ''ios'' AND \"$.tags[*]\" = ''t1''')",
    "SELECT kind, sum(v) FROM docs WHERE JSON_MATCH(attrs, "
    "'\"$.ver\" != 3 OR \"$.tags[*]\" IS NULL') GROUP BY kind ORDER BY kind",
    "SELECT count(*) FROM docs WHERE REGEXP_LIKE(title, '^w0[0-4] ') "
    "AND kind LIKE 'b'",
]


@pytest.mark.parametrize("indexed", [False, True], ids=["plain", "indexed"])
@pytest.mark.parametrize("i", range(len(MATCH_SQL)))
def test_text_and_json_match_jax(data, executors, i, indexed):  # noqa: F811
    """Without JAX indexes: rows, stats and declines; with them (text,
    JSON and FST indexes on the JAX side only): the same rows."""
    sql = MATCH_SQL[i]
    if not indexed:
        _check(data, executors, "docs", sql)
        _batch_check(data, "docs", sql)
        return
    jsegs, tsegs = data["docs_ix"]
    assert jsegs[0].metadata.column("title").has_text_index
    got, _ = ServerQueryExecutor(device="cpu").execute(t_compile(sql), tsegs)
    for ref in ("pallas", "host"):
        want, _ = executors[ref].execute(j_compile(sql), jsegs)
        assert got.rows == want.rows, (ref, sql)


# -- the time transforms ------------------------------------------------------------

TIME_SQL = [
    "SELECT sum(toEpochSeconds(ts)), sum(toEpochMinutes(ts)), "
    "sum(toEpochHours(ts)), sum(toEpochDays(ts)), count(*) FROM docs",
    "SELECT sum(fromEpochDays(day)), max(fromEpochHours(day)), "
    "min(fromEpochMinutes(day)), sum(fromEpochSeconds(day)) FROM docs",
    "SELECT sum(dateTrunc('HOUR', ts)), max(dateTrunc('week', ts)), "
    "min(dateTrunc('MILLISECOND', ts)), sum(dateTrunc('second', ts)), "
    "sum(dateTrunc('minute', ts)) FROM docs WHERE kind = 'a'",
    "SELECT sum(timeConvert(ts, 'MILLISECONDS', 'SECONDS')), "
    "sum(timeConvert(day, 'DAYS', 'HOURS')), "
    "max(timeConvert(ts, 'MILLISECONDS', 'MILLISECONDS')) FROM docs",
    "SELECT toEpochDays(ts), min(dateTrunc('DAY', ts)), count(*), sum(v) "
    "FROM docs GROUP BY toEpochDays(ts) ORDER BY toEpochDays(ts) LIMIT 100",
    "SELECT toEpochHours(ts), kind, count(*) FROM docs WHERE v < 100 "
    "GROUP BY toEpochHours(ts), kind ORDER BY count(*) DESC, "
    "toEpochHours(ts), kind LIMIT 20",
    "SELECT toEpochDays(ts), sum(v) FROM docs "
    f"WHERE ts BETWEEN {T0 + 3 * DAY_MS} AND {T0 + 5 * DAY_MS - 1} "
    "GROUP BY toEpochDays(ts) ORDER BY toEpochDays(ts)",
    "SELECT timeConvert(ts, 'MILLISECONDS', 'DAYS'), toEpochMinutes(ts) "
    "- toEpochHours(ts) * 60, count(*) FROM docs WHERE kind != 'b' "
    "GROUP BY timeConvert(ts, 'MILLISECONDS', 'DAYS'), "
    "toEpochMinutes(ts) - toEpochHours(ts) * 60 ORDER BY count(*) DESC, "
    "timeConvert(ts, 'MILLISECONDS', 'DAYS') LIMIT 10",
    "SELECT toEpochHours(ts) AS h, sum(v) AS s FROM docs "
    "GROUP BY h HAVING s > 2000 ORDER BY s DESC LIMIT 5",
    "SELECT toEpochSeconds(ts), count(*) FROM docs WHERE v < 2 "
    "GROUP BY toEpochSeconds(ts) ORDER BY count(*) DESC, "
    "toEpochSeconds(ts) LIMIT 5",
    "SELECT toEpochDays(day * 86400000), count(*) FROM docs "
    "GROUP BY toEpochDays(day * 86400000) ORDER BY 1 LIMIT 50",
]


@pytest.mark.parametrize("i", range(len(TIME_SQL)))
def test_time_transforms_match_jax(data, executors, i):  # noqa: F811
    sql = TIME_SQL[i]
    _check(data, executors, "docs", sql)
    _batch_check(data, "docs", sql)


def test_time_transform_names_keep_the_users_expression(data):
    """The rewrite happens at plan time only: the response names the
    user's expressions, as JAX's does."""
    jsegs, tsegs = data["docs"]
    table, _ = ServerQueryExecutor(device="cpu").execute(
        t_compile(TIME_SQL[4]), tsegs)
    want, _ = JSharded(use_pallas=True).execute(j_compile(TIME_SQL[4]),
                                                jsegs)
    assert table.schema.column_names == want.schema.column_names == [
        "toepochdays(ts)", "min(datetrunc('DAY',ts))", "count(*)", "sum(v)"]
    assert table.schema.column_types == want.schema.column_types


def test_time_window_prunes_to_one_segment(data):
    _, tsegs = data["docs"]
    _, stats = ServerQueryExecutor(device="cpu").execute(
        t_compile(TIME_SQL[6]), tsegs)
    assert (stats.num_segments_pruned, stats.num_segments_processed) == (1, 1)


# -- HAVING, OFFSET, OPTION -----------------------------------------------------------

CLAUSE_SQL = [
    "SELECT team, sum(runs) AS total, count(*) AS n FROM stats "
    "GROUP BY team HAVING total > 10000 AND n >= 200 ORDER BY total DESC",
    "SELECT team, league, sum(runs) FROM stats GROUP BY team, league "
    "HAVING max(runs) >= 149 OR NOT count(*) > 200 "
    "ORDER BY team, league",
    "SELECT team, count(*) FROM stats GROUP BY team "
    "HAVING team IN ('BOS', 'NYA', 'SFO') AND count(*) BETWEEN 100 AND 300 "
    "ORDER BY team",
    "SELECT team, avg(score) AS a FROM stats GROUP BY team "
    "HAVING a != 0 ORDER BY a DESC LIMIT 3 OFFSET 2",
    "SELECT year, count(*) FROM stats GROUP BY year ORDER BY year "
    "LIMIT 4, 5",
    "SELECT year, count(*) FROM stats GROUP BY year ORDER BY year "
    "LIMIT 5 OFFSET 40",
    "SELECT team, sum(runs) FROM stats WHERE year > 2000 GROUP BY team "
    "ORDER BY sum(runs) DESC LIMIT 4 OPTION(timeoutMs=60000, "
    "useStarTree=false, useIndexRung='false')",
    "SELECT count(*), sum(runs) FROM stats HAVING count(*) > 1000000",
    "SELECT count(*) FROM stats WHERE league = 'AL' LIMIT 1 OFFSET 3",
    "SELECT team, sum(runs) AS s FROM stats GROUP BY team HAVING s = 0",
]


@pytest.mark.parametrize("i", range(len(CLAUSE_SQL)))
def test_clauses_match_jax(data, executors, i):  # noqa: F811
    sql = CLAUSE_SQL[i]
    _check(data, executors, "stats", sql)
    _batch_check(data, "stats", sql)


def test_option_is_parsed_and_read(data):
    ctx = t_compile(CLAUSE_SQL[6])
    assert ctx.options == j_compile(CLAUSE_SQL[6]).options == {
        "timeoutMs": "60000", "useStarTree": "false",
        "useIndexRung": "false"}
    # no OPTION: no options, on both sides (nothing enforces timeoutMs)
    plain = "SELECT count(*) FROM t"
    assert t_compile(plain).options == j_compile(plain).options == {}


def test_option_variants_share_nothing_stale(data):
    """The plan cache keys on the SQL text, OPTION included: two queries
    that differ only in OPTION get their own (equal) plans and rows."""
    _, tsegs = data["stats"]
    ex = ServerQueryExecutor(device="cpu")
    base = "SELECT team, sum(runs) FROM stats GROUP BY team ORDER BY team"
    a, _ = ex.execute(t_compile(base), tsegs)
    b, _ = ex.execute(t_compile(base + " OPTION(timeoutMs=5)"), tsegs)
    c, _ = ex.execute(t_compile(base), tsegs)
    assert a.rows == b.rows == c.rows
    assert len({k[0] for k in ex._plans}) == 2


# -- refusals and errors -------------------------------------------------------------

HOST_SQL = [
    ("docs", "SELECT count(*) FROM docs "
             "WHERE JSON_MATCH(jmv, '\"$.os\" = ''ios''')"),
    ("docs", "SELECT count(*) FROM docs WHERE REGEXP_LIKE(ts, '7$')"),
    ("docs", "SELECT sum(dateTrunc('MONTH', ts)) FROM docs"),
    ("docs", "SELECT dateTrunc('YEAR', ts), count(*) FROM docs "
             "GROUP BY dateTrunc('YEAR', ts)"),
    ("docs", "SELECT dateTrunc('DAY', ts), count(*), sum(v) FROM docs "
             "GROUP BY dateTrunc('DAY', ts)"),
    ("docs", "SELECT fromEpochDays(day), count(*) FROM docs "
             "GROUP BY fromEpochDays(day)"),
    ("docs", "SELECT sum(timeConvert(ts, 'MILLISECONDS', 'WEEKS')) FROM docs"),
    ("stats", "SELECT count(*) FROM stats WHERE REGEXP_LIKE(salary, '^1')"),
    ("stats", "SELECT count(*) FROM stats WHERE toEpochDays(big) > 3"),
]


@pytest.mark.parametrize("i", range(len(HOST_SQL)))
def test_host_shapes_raise_with_the_jax_code(data, i):
    """The JAX planner sends each shape to its host engine; the port's
    host engine serves it on every path with the same code recorded per
    segment and the JAX rows, or raises the JAX host engine's error (it
    raised NotPortedError with the code before the host engine was
    ported). The batch path plans the batch, meets the same code and takes
    the per-segment path, as the JAX sharded executor does."""
    from tests.test_torch_host_engine import assert_same_answer, run

    key, sql = HOST_SQL[i]
    jsegs, tsegs = data[key]
    with pytest.raises(JPlanError) as je:
        j_plan(j_compile(sql), jsegs[0])
    for ex, ref in ((ServerQueryExecutor(device="cpu"),
                     JExecutor(use_device=True, use_pallas=True)),
                    (ServerQueryExecutor(device="cpu", use_fused_scan=False),
                     JExecutor(use_device=True, use_pallas=False)),
                    (ShardedQueryExecutor(device="cpu"),
                     JSharded(use_pallas=True))):
        got = run(ex, t_compile, sql, tsegs)
        assert_same_answer(got, run(ref, j_compile, sql, jsegs), sql)
        if got[1] is not None:
            assert got[1].decisions[f"plan:device_kernel->host_engine:"
                                    f"{je.value.reason_code}"] == len(tsegs)


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM stats WHERE REGEXP_LIKE(team, '(')",
    "SELECT count(*) FROM stats WHERE TEXT_MATCH(team, '((')",
    "SELECT count(*) FROM stats WHERE TEXT_MATCH(team, '*')",
    "SELECT count(*) FROM stats WHERE JSON_MATCH(team, '\"$.a\" >')",
    "SELECT count(*) FROM stats WHERE JSON_MATCH(team, '\"$.a[0]\" = 1')",
])
def test_bad_patterns_are_query_errors(data, sql):
    jsegs, tsegs = data["stats"]
    with pytest.raises(JQueryError):
        j_plan(j_compile(sql), jsegs[0])
    with pytest.raises(QueryError) as e:
        ServerQueryExecutor(device="cpu").execute(t_compile(sql), tsegs)
    assert type(e.value) is QueryError


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM t WHERE a NOT = 1",
    "SELECT count(*) FROM t WHERE regexp_like(a)",
    "SELECT count(*) FROM t WHERE text_match(a, b)",
    "SELECT count(*) FROM t WHERE json_match(a, 'x', 'y')",
    "SELECT count(*) FROM t WHERE a LIKE b",
    "SELECT count(*) FROM t LIMIT x",
    "SELECT count(*) FROM t LIMIT 5 OFFSET",
    "SELECT count(*) FROM t LIMIT 5, ",
    "SELECT count(*) FROM t OPTION(timeoutMs 5)",
    "SELECT a, count(*) FROM t GROUP BY a HAVING",
    "SELECT count(*) FROM t WHERE a = 1 LIMIT 3 OFFSET 1 junk",
    "SELECT count(*) FROM t ORDER BY 3",
])
def test_parse_errors_carry_the_jax_message(sql):
    with pytest.raises(JSqlParseError) as je:
        j_compile(sql)
    with pytest.raises(SqlParseError) as e:
        t_compile(sql)
    assert str(e.value) == str(je.value)


def test_chip_smoke_phase9_on_cpu():
    """chip_smoke.py's phase 9 at a small size on the CPU: S1-S7 per
    segment and over the batch of 4 time-bounded SSB segments, the time
    buckets over 8 segments of events, TEXT_MATCH and JSON_MATCH, each
    against its numpy oracle with its decline codes and rungs."""
    import chip_smoke
    from pinot_tpu_torch.tools import ssb as t_ssb

    segs, frames = t_ssb.build_segments(0.02, num_segments=4, seed=42)
    sqls, wants = t_ssb.sql_queries(frames)
    ex = ServerQueryExecutor(device="cpu")
    q33, _ = ex.execute(t_compile(t_ssb.QUERIES["Q3.3"] + " LIMIT 100000"),
                        segs)
    kept = chip_smoke._kept_segments(
        {sid: t_compile(q) for sid, q in sqls.items()}, segs, frames)
    run = chip_smoke.phase_sql(segs, sqls, wants, kept, ex,
                               ShardedQueryExecutor(device="cpu"), reps=1,
                               q33_rows=q33.rows)
    assert run["paths"]["S2"]["kept_segments"] == 4
    assert 9 <= run["paths"]["S3"]["lut_runs"][0] <= 64
    assert run["paths"]["S4"]["lut_runs"][0] > 64
    assert run["paths"]["S1"]["lut_runs"] == [1]
    times = chip_smoke.phase_time(seed=3, reps=1, segments=8,
                                  rows_per_segment=20_000, device="cpu")
    assert times["paths"]["T3"]["kept_segments"] in (1, 2)
    text = chip_smoke.phase_text(seed=3, reps=1, n=30_000, device="cpu")
    assert text["paths"]["X1"]["decline"] is None
    # phase 11a: the queries the fused scan declines, over their batches
    combine = chip_smoke.phase_combine(run["combine_jobs"]
                                       + times["combine_jobs"], reps=1,
                                       device="cpu")
    assert sorted(combine["queries"]) == ["S4", "T1b", "T2", "T3", "T4"]
    assert combine["queries"]["S4"]["kept_segments"] > 1
