"""The host engine in the port against the JAX package.

The plans the JAX executor sends to its host engine (a ``PlanError`` from
its planner, recorded as ``plan:device_kernel->host_engine:<code>``),
selection and DISTINCT, on the same segments carried across with
``columns_of`` / ``segment_from_arrays``:

- tests/test_torch_columns.py's stats table (tests/test_engine.py's, with
  raw, multi-value and null columns);
- an events table (tests/test_theta_idset_withtime.py's and
  tests/test_gapfill_stunion.py's columns: unique times, WKT points, an
  MV column) for the theta, idset, withtime, stunion and ST_ cases;
- the user-events table (tools/usertable.py), with phase 10's U8-U10.

Every query runs through the port per segment (fused scan on and off)
and through ``ShardedQueryExecutor`` beside the JAX executor
(``use_pallas=True`` and ``False``) and the JAX sharded executor: rows,
column names and types, the host-engine and selection decision keys with
their counts, the group-by rung and the docs scanned. Where the JAX
package raises, the port raises an error of the same class and message.
Tolerance: counts, keys, distinct counts and sketches exact; float cells
rel 1e-5, abs 1e-6 (tests/test_pallas.py:101).
"""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JaxExecutor  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu.tools import usertable as j_user  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.tools import usertable as t_user  # noqa: E402

from tests.test_torch_columns import build_stats  # noqa: E402
from tests.test_torch_executor import carry  # noqa: E402

# decision points of the host engine and the device top-k (the JAX
# executor also records its index rung's, which the port does not have)
HOST_POINTS = ("plan:", "selection:", "sharded_combine:")


def host_decisions(stats):
    return {k: v for k, v in stats.decisions.items()
            if k.startswith(HOST_POINTS)}


def run(ex, compile_, sql, segs):
    """-> (table, stats), or (the error's class name and message, None)."""
    try:
        return ex.execute(compile_(sql), segs)
    except Exception as e:  # noqa: BLE001 - compared by class and message
        return (type(e).__name__, str(e)), None


def _cell_equal(g, w):
    if isinstance(w, float) and isinstance(g, float):
        return g == pytest.approx(w, rel=1e-5, abs=1e-6, nan_ok=True)
    return g == w and type(g) is type(w)


def assert_same_answer(got, want, what):
    """``run``'s outcomes of the port and the JAX package agree."""
    (gt, gs), (wt, ws) = got, want
    if ws is None or gs is None:
        assert gt == wt, what
        return
    assert gt.schema.column_names == wt.schema.column_names, what
    assert gt.schema.column_types == wt.schema.column_types, what
    assert len(gt.rows) == len(wt.rows), (what, gt.rows, wt.rows)
    for gr, wr in zip(gt.rows, wt.rows):
        assert len(gr) == len(wr) and all(
            _cell_equal(g, w) for g, w in zip(gr, wr)), (what, gr, wr)
    assert host_decisions(gs) == host_decisions(ws), what
    assert gs.group_by_rung == ws.group_by_rung, what
    assert (gs.num_docs_scanned, gs.num_segments_processed,
            gs.total_docs) == (ws.num_docs_scanned, ws.num_segments_processed,
                               ws.total_docs), what


def check_paths(jsegs, tsegs, sql, paths):
    """``sql`` through each (port executor, JAX executor) pair: -> the
    port's outcomes (where the fused scan declines a segment batch, both
    batch paths serve on their jnp combine)."""
    out = {}
    for name, (port, jax_ex) in paths.items():
        got = run(port, t_compile, sql, tsegs)
        out[name] = got
        assert_same_answer(got, run(jax_ex, j_compile, sql, jsegs),
                           f"{name}: {sql}")
    return out


@pytest.fixture(scope="module")
def paths():
    return {
        "fused": (ServerQueryExecutor(device="cpu"),
                  JaxExecutor(use_device=True, use_pallas=True)),
        "general": (ServerQueryExecutor(device="cpu", use_fused_scan=False),
                    JaxExecutor(use_device=True, use_pallas=False)),
        "batch": (ShardedQueryExecutor(device="cpu"),
                  JSharded(use_pallas=True)),
    }


def build_events(out):
    """tests/test_theta_idset_withtime.py's events with WKT points and an
    MV column (tests/test_gapfill_stunion.py's), in two segments."""
    rng = np.random.default_rng(23)
    n = 4000
    frame = {
        "user": [f"u{i}" for i in rng.integers(0, 1500, n)],
        "grp": [f"g{i}" for i in rng.integers(0, 3, n)],
        "val": rng.integers(0, 1000, n).tolist(),
        "ts": rng.permutation(n).tolist(),
        "loc": [f"POINT ({x} {y})" for x, y in
                zip(rng.integers(0, 6, n), rng.integers(0, 6, n))],
        "tags": [[f"x{j}" for j in rng.choice(6, rng.integers(1, 3),
                                              replace=False)]
                 for _ in range(n)],
    }
    schema = Schema("events", [
        FieldSpec("user", DataType.STRING),
        FieldSpec("grp", DataType.STRING),
        FieldSpec("val", DataType.LONG, FieldType.METRIC),
        FieldSpec("ts", DataType.LONG),
        FieldSpec("loc", DataType.STRING),
        FieldSpec("tags", DataType.STRING, single_value=False)])
    segs = []
    for i, sl in enumerate([slice(0, n // 2), slice(n // 2, n)]):
        SegmentBuilder(schema, f"ev_{i}").build(
            {k: v[sl] for k, v in frame.items()}, str(out))
        segs.append(load_segment(str(out / f"ev_{i}")))
    return segs, carry(segs, "events")


USER_ROWS, USER_SEGS, USER_SEED = 40_000, 4, 7


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    jusers = j_user.build_segments(
        str(tmp_path_factory.mktemp("torch_host_users")),
        num_segments=USER_SEGS, rows=USER_ROWS, seed=USER_SEED, workers=1)
    return {"stats": build_stats(tmp_path_factory.mktemp("torch_host")),
            "events": build_events(tmp_path_factory.mktemp("torch_host_ev")),
            "users": (jusers, carry(jusers, "user_events"))}


# (table, SQL): every shape the JAX executor sends to its host engine
HOST_SQL = [
    # host-only families, scalar and grouped
    ("stats", "SELECT mode(runs), percentile90(score), percentileest50(runs), "
              "percentiletdigest95(score) FROM stats WHERE year >= 2000"),
    ("stats", "SELECT team, mode(year), percentile(runs, 75) FROM stats "
              "GROUP BY team ORDER BY team"),
    ("stats", "SELECT league, sumprecision(runs), sumprecision(score, 5), "
              "percentiletdigest50(salary) FROM stats GROUP BY league "
              "ORDER BY league"),
    ("stats", "SELECT sumprecision(salary), mode(ratio) FROM stats "
              "WHERE team = 'NYA'"),
    ("events", "SELECT distinctcountthetasketch(user), "
               "distinctcountrawthetasketch(grp), idset(val) FROM events "
               "WHERE grp = 'g1'"),
    ("events", "SELECT grp, distinctcountthetasketch(user) FROM events "
               "GROUP BY grp ORDER BY grp"),
    ("events", "SELECT lastwithtime(val, ts, 'LONG'), "
               "firstwithtime(user, ts, 'STRING') FROM events"),
    ("events", "SELECT grp, lastwithtime(val, ts, 'DOUBLE'), "
               "firstwithtime(val, ts, 'INT') FROM events GROUP BY grp "
               "ORDER BY grp"),
    ("events", "SELECT stunion(loc) FROM events WHERE val < 40"),
    ("events", "SELECT grp, st_union(loc) FROM events WHERE val < 30 "
               "GROUP BY grp ORDER BY grp"),
    ("events", "SELECT count(*) FROM events "
               "WHERE stdistance(loc, 'POINT (2 2)') < 1.5"),
    ("events", "SELECT count(*), sum(val) FROM events "
               "WHERE inIdSet(val, idset_literal) = 1"),
    # grouped DISTINCTCOUNT, DISTINCTCOUNT on raw and MV columns
    ("stats", "SELECT team, distinctcount(year), distinctcount(league) "
              "FROM stats GROUP BY team ORDER BY team"),
    ("stats", "SELECT distinctcount(salary), distinctcount(ratio) "
              "FROM stats"),
    ("stats", "SELECT distinctcountmv(tags), distinctcounthllmv(nums) "
              "FROM stats"),
    ("events", "SELECT grp, distinctcountmv(tags), distinctcounthllmv(tags) "
               "FROM events GROUP BY grp ORDER BY grp"),
    # group-by on raw float and raw int spans
    ("stats", "SELECT ratio, count(*), sum(runs) FROM stats GROUP BY ratio "
              "ORDER BY ratio LIMIT 20"),
    ("stats", "SELECT salary, count(*) FROM stats WHERE runs < 5 "
              "GROUP BY salary ORDER BY salary LIMIT 10"),
    # grouped MV aggregations
    ("stats", "SELECT team, summv(nums), countmv(tags), avgmv(nums), "
              "minmaxrangemv(nums) FROM stats GROUP BY team ORDER BY team"),
    ("stats", "SELECT maxmv(nums), percentilemv(nums, 90), "
              "percentiletdigestmv(nums, 50) FROM stats WHERE league = 'AL'"),
    # expression predicates; pattern predicates on raw columns
    ("stats", "SELECT count(*), sum(runs) FROM stats "
              "WHERE runs * 2 + year > 2100"),
    ("stats", "SELECT team, count(*) FROM stats WHERE abs(score - 50) < 5 "
              "GROUP BY team ORDER BY team"),
    ("stats", "SELECT count(*) FROM stats WHERE REGEXP_LIKE(salary, '^1')"),
    ("stats", "SELECT league, count(*) FROM stats WHERE bonus LIKE '1%' "
              "GROUP BY league ORDER BY league"),
    # virtual columns
    ("stats", "SELECT $segmentName, count(*), max($docId) FROM stats "
              "GROUP BY $segmentName ORDER BY $segmentName"),
    ("stats", "SELECT count(*) FROM stats WHERE $docId < 100 "
              "AND team = 'BOS'"),
    ("stats", "SELECT team, count(*) FROM stats WHERE $hostName != 'h' "
              "GROUP BY team ORDER BY team"),
    # group keys past the device's key space; calendar transforms
    ("stats", "SELECT dateTrunc('DAY', big), count(*) FROM stats "
              "GROUP BY dateTrunc('DAY', big) "
              "ORDER BY count(*) DESC, dateTrunc('DAY', big) LIMIT 5"),
    ("stats", "SELECT dateTrunc('MONTH', salary * 1000000), count(*) "
              "FROM stats GROUP BY dateTrunc('MONTH', salary * 1000000) "
              "ORDER BY dateTrunc('MONTH', salary * 1000000) LIMIT 50"),
    ("stats", "SELECT sum(year(salary * 1000000)) FROM stats"),
    # scalar functions as keys and values
    ("stats", "SELECT upper(team), count(*) FROM stats GROUP BY upper(team) "
              "ORDER BY upper(team)"),
    ("stats", "SELECT team, sum(abs(runs - 70)) FROM stats GROUP BY team "
              "ORDER BY team"),
    # null columns and HAVING through the host engine
    ("stats", "SELECT nick, mode(bonus) FROM stats WHERE nick IS NOT NULL "
              "GROUP BY nick ORDER BY nick"),
    ("stats", "SELECT team, percentile50(runs) FROM stats GROUP BY team "
              "HAVING percentile50(runs) > 70 ORDER BY team"),
    # refused by both: an MV group key, JSON_MATCH on an MV column
    ("stats", "SELECT tags, count(*) FROM stats GROUP BY tags"),
    ("stats", "SELECT summv(tags) FROM stats"),
    # the user-events table
    ("users", "SELECT device, percentile95(latency_ms), mode(revenue) "
              "FROM user_events WHERE country = 'US' GROUP BY device "
              "ORDER BY device"),
    ("users", "SELECT distinctcount(latency_ms) FROM user_events "
              "WHERE event_type = 'refund'"),
]

# selection and DISTINCT (the device top-k's cases: tests/test_torch_
# selection.py)
SELECT_SQL = [
    ("stats", "SELECT team, runs, tags FROM stats WHERE year > 2010 "
              "LIMIT 7 OFFSET 3"),
    ("stats", "SELECT * FROM stats WHERE nick IS NULL LIMIT 4"),
    ("stats", "SELECT team, runs + 1, upper(league) FROM stats LIMIT 3"),
    ("stats", "SELECT team AS t, nums FROM stats WHERE tags = 't2' "
              "LIMIT 5"),
    ("stats", "SELECT DISTINCT team, league FROM stats"),
    ("stats", "SELECT DISTINCT tags FROM stats LIMIT 100"),
    ("stats", "SELECT DISTINCT year FROM stats WHERE team = 'BOS' "
              "ORDER BY year DESC LIMIT 5"),
    ("stats", "SELECT league, team FROM stats GROUP BY league, team "
              "ORDER BY team DESC, league LIMIT 6"),
    ("stats", "SELECT team FROM stats GROUP BY team HAVING team > 'C' "
              "ORDER BY team"),
    ("stats", "SELECT DISTINCT $segmentName FROM stats"),
    ("stats", "SELECT DISTINCT ratio, league FROM stats WHERE runs < 20 "
              "LIMIT 1000"),
    ("stats", "SELECT team, score FROM stats ORDER BY score DESC, team "
              "LIMIT 8"),
    ("stats", "SELECT team, big FROM stats ORDER BY big LIMIT 5"),
    ("stats", "SELECT team, runs FROM stats ORDER BY runs * 2 DESC, team "
              "LIMIT 6"),
    ("stats", "SELECT nick, bonus FROM stats ORDER BY bonus DESC LIMIT 5"),
    ("stats", "SELECT $docId, team FROM stats WHERE runs = 7 "
              "ORDER BY $docId DESC LIMIT 5"),
    ("users", "SELECT DISTINCT device, event_type FROM user_events "
              "ORDER BY device, event_type LIMIT 100"),
    ("users", "SELECT user_id, latency_ms FROM user_events "
              "WHERE country = 'JP' LIMIT 5 OFFSET 2"),
]


def _idset_sql(data, sql):
    """Fill ``idset_literal`` with JAX's own IDSET of the g0 values."""
    if "idset_literal" not in sql:
        return sql
    jsegs, _ = data["events"]
    t, _ = JaxExecutor(use_device=False).execute(
        j_compile("SELECT idset(val) FROM events WHERE grp = 'g0'"), jsegs)
    return sql.replace("idset_literal", f"'{t.rows[0][0]}'")


@pytest.mark.parametrize("i", range(len(HOST_SQL)))
def test_host_shapes_match_jax(data, paths, i):
    key, sql = HOST_SQL[i]
    jsegs, tsegs = data[key]
    sql = _idset_sql(data, sql)
    got = check_paths(jsegs, tsegs, sql, paths)
    table, stats = got["general"]
    if stats is None:
        return  # both packages raise, alike
    codes = {k for k in stats.decisions if k.startswith("plan:")}
    assert codes, sql   # the host engine served
    assert all(k.startswith("plan:device_kernel->host_engine:")
               for k in codes), sql


@pytest.mark.parametrize("i", range(len(SELECT_SQL)))
def test_selection_and_distinct_match_jax(data, paths, i):
    key, sql = SELECT_SQL[i]
    jsegs, tsegs = data[key]
    got = check_paths(jsegs, tsegs, sql, paths)
    table, stats = got["general"]
    assert stats is not None and table.rows, sql


def test_phase10_user_queries_match_jax_and_oracle(data, paths):
    """U8-U10 (tools/usertable.py host_queries) on the user-events table:
    the JAX package's rows and decisions on every path, and the port's
    numpy oracle over the port generator's own frames."""
    jsegs, tsegs = data["users"]
    user = j_user.tail_users(USER_ROWS, USER_SEGS, USER_SEED)[3]
    for qid, sql in t_user.host_queries(user).items():
        got = check_paths(jsegs, tsegs, sql, paths)
        _, stats = got["fused"]
        assert stats.topk_launches == (USER_SEGS if qid == "U8" else 0), qid
        assert stats.scan_launches == stats.general_launches == 0, qid
    segs, frames = t_user.build_segments(USER_SEGS, USER_ROWS, USER_SEED)
    ex = ServerQueryExecutor(device="cpu")
    wants = t_user.host_answers(frames, user,
                                [s.segment_name for s in segs])
    for qid, sql in t_user.host_queries(user).items():
        table, _ = ex.execute(t_compile(sql), segs)
        assert [list(r) for r in table.rows] == wants[qid], qid


def test_decision_codes_per_shape(data, paths):
    """The reason codes the host engine is reached with, one per shape
    (ROADMAP queue 1 item 1(b)), recorded once per segment."""
    _, tsegs = data["stats"]
    ex = paths["general"][0]
    for sql, code in (
            ("SELECT mode(runs) FROM stats", "agg_not_device_supported"),
            ("SELECT team, distinctcount(year) FROM stats GROUP BY team",
             "agg_not_device_supported"),
            ("SELECT distinctcount(salary) FROM stats",
             "distinctcount_raw_column"),
            ("SELECT ratio, count(*) FROM stats GROUP BY ratio",
             "group_raw_float_column"),
            ("SELECT team, summv(nums) FROM stats GROUP BY team",
             "agg_not_device_supported"),
            ("SELECT count(*) FROM stats WHERE runs + 1 > 10",
             "expression_predicate"),
            ("SELECT $segmentName, count(*) FROM stats "
             "GROUP BY $segmentName", "group_virtual_column"),
            ("SELECT dateTrunc('DAY', big), count(*) FROM stats "
             "GROUP BY dateTrunc('DAY', big)",
             "group_expression_span_over_limit"),
            ("SELECT sum(dateTrunc('MONTH', salary)) FROM stats",
             "transform_unsupported")):
        _, stats = ex.execute(t_compile(sql), tsegs)
        assert host_decisions(stats) == {
            f"plan:device_kernel->host_engine:{code}": len(tsegs)}, sql
        assert stats.general_launches == stats.scan_launches == 0, sql
    _, stats = ex.execute(t_compile("SELECT DISTINCT team FROM stats"),
                          tsegs)
    assert stats.decisions == {
        "plan:device_kernel->host_engine:distinct_host_only": 1}


def test_raw_hll_returns_the_sketch(data, paths):
    """distinctcountrawhll returns the serialized registers as hex, as the
    JAX package does, on the device rungs (it returned the estimate before
    the host engine's finalize was ported)."""
    jsegs, tsegs = data["stats"]
    sql = "SELECT distinctcountrawhll(team), distinctcounthll(team) FROM stats"
    got = check_paths(jsegs, tsegs, sql, paths)
    table, stats = got["fused"]
    assert isinstance(table.rows[0][0], str) and table.rows[0][1] == 7
    assert not host_decisions(stats)


def test_not_ported_only_on_the_batch_fused_declines(data):
    """No module of the port raises NotPortedError any more: the batch
    plans the fused scan declines are served by the jnp combine, equal to
    the JAX sharded executor (rows, stats, the decline recorded once), as
    every per-segment path serves them."""
    import pathlib

    import pinot_tpu_torch
    from pinot_tpu.parallel import ShardedQueryExecutor as JSharded

    root = pathlib.Path(pinot_tpu_torch.__file__).parent
    assert not [f for f in root.rglob("*.py")
                if "NotPortedError" in f.read_text()]
    jsegs, tsegs = data["stats"]
    bex = ShardedQueryExecutor(device="cpu")
    for sql, code in (
            ("SELECT team, distinctcounthll(league) FROM stats "
             "GROUP BY team", "pallas_distinct_agg"),
            ("SELECT count(*) FROM stats WHERE tags = 't1'",
             "pallas_mv_eq")):
        got = run(bex, t_compile, sql, tsegs)
        want = run(JSharded(use_pallas=True), j_compile, sql, jsegs)
        assert_same_answer(got, want, sql)
        assert got[1].decisions == want[1].decisions == {
            f"pallas:pallas_combine->jnp_combine:{code}": 1}
        assert got[1].batch_general_launches == 1
        for ex in (ServerQueryExecutor(device="cpu"),
                   ServerQueryExecutor(device="cpu", use_fused_scan=False)):
            ex.execute(t_compile(sql), tsegs)


def test_chip_smoke_phase10_on_cpu():
    """chip_smoke.py's phase 10 at a small size on the CPU: H1-H7 on 4
    time-bounded SSB segments and U8-U10 on 2 user-events segments, each
    against its numpy oracle with its decisions and top-k calls (the
    top-k's timings are taken only on the card)."""
    import chip_smoke
    from pinot_tpu_torch.tools import ssb as t_ssb

    segs, frames = t_ssb.build_segments(0.05, num_segments=4, seed=42)
    texts, wants = t_ssb.host_queries(frames)
    kept = chip_smoke._kept_segments(
        {q: t_compile(sql) for q, sql in texts.items()}, segs, frames)
    assert [len(kept[q]) for q in ("H1", "H4", "H6")] == [2, 4, 2]
    main = {"segs": segs, "ex": ServerQueryExecutor(device="cpu"),
            "host_texts": texts, "host_wants": wants, "host_kept": kept}
    users = chip_smoke.phase_users(seed=3, reps=1, segments=2,
                                   rows_per_segment=15_000, device="cpu")
    run = chip_smoke.phase_host(main, users,
                                ShardedQueryExecutor(device="cpu"), reps=1)
    assert {q: p["path"] for q, p in run["paths"].items()} == {
        q: p[0] for q, p in chip_smoke.HOST_PATH.items()}
    assert run["paths"]["U8"]["topk_calls"] == 2
    assert run["topk"] == []
