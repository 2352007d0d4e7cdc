"""Raw, multi-value and null columns in the port against the JAX package.

The segments are tests/test_engine.py's stats table (raw LONG ``salary``,
MV STRING ``tags`` with null rows, MV INT ``nums``, DOUBLE ``score``) plus
a nullable SV dimension ``nick``, a nullable raw LONG ``bonus``, a raw
DOUBLE ``ratio`` and a raw LONG ``big`` past 2^31, built by the JAX
package and carried across with ``columns_of`` / ``segment_from_arrays``.

- every new filter leaf, value op and MV aggregate against the JAX jnp
  body, leaf by leaf;
- SQL end to end against the JAX ServerQueryExecutor with
  ``use_pallas=False`` (port: ``use_fused_scan=False``) and, for the
  queries the fused scan serves with raw value columns, with
  ``use_pallas=True`` in interpret mode: rows, rung per segment and
  decline codes;
- the port's host engine, reached with the JAX reason code, for each
  shape the JAX package serves on its host engine.

Tolerance: counts, integer sums, min/max and keys exact; float sums
rel 1e-5, abs 1e-6.
"""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine.plan import PlanError as JPlanError  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import (  # noqa: E402
    DataType,
    FieldSpec,
    FieldType,
    IndexingConfig,
    Schema,
)
from pinot_tpu_torch.engine import fused_scan as tfs  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.engine.staging import StagedSegment  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import columns_of  # noqa: E402

from tests.test_torch_executor import carry  # noqa: E402
from tests.test_torch_general_rung import (  # noqa: E402,F401
    _check,
    _pallas_decisions,
    executors,
)
from tests.test_torch_kernels import (  # noqa: E402
    _assert_tree_equal,
    _run_jax,
    _run_port,
)

N = 3000
RAW = ["salary", "bonus", "ratio", "big"]


def stats_frame():
    rng = np.random.default_rng(7)
    teams = ["ATL", "BOS", "CHC", "NYA", "SFO", "LAD", "HOU"]
    tags = [[f"t{j}" for j in rng.choice(5, size=rng.integers(0, 4),
                                         replace=False)] for _ in range(N)]
    nick = np.array(["ace", "bud", "cap", "doc"])[rng.integers(0, 4, N)]
    bonus = rng.integers(0, 500, N)
    return {
        "team": [teams[i] for i in rng.integers(0, len(teams), N)],
        "league": [("AL", "NL")[i] for i in rng.integers(0, 2, N)],
        "year": rng.integers(1990, 2021, N).tolist(),
        "tags": [t or None for t in tags],
        "nums": [rng.integers(0, 30, rng.integers(1, 5)).tolist()
                 for _ in range(N)],
        "runs": rng.integers(0, 150, N).tolist(),
        "score": np.round(rng.normal(50, 12, N), 3).tolist(),
        "salary": rng.integers(10_000, 5_000_000, N).tolist(),
        "nick": [None if i % 9 == 0 else str(v) for i, v in enumerate(nick)],
        "bonus": [None if i % 11 == 0 else int(v)
                  for i, v in enumerate(bonus)],
        "ratio": np.round(rng.random(N), 2).tolist(),
        "big": (rng.integers(0, 1 << 40, N) - (1 << 39)).tolist(),
    }


def stats_schema():
    S, M = DataType.STRING, FieldType.METRIC
    return Schema("stats", [
        FieldSpec("team", S), FieldSpec("league", S),
        FieldSpec("year", DataType.INT),
        FieldSpec("tags", S, single_value=False),
        FieldSpec("nums", DataType.INT, single_value=False),
        FieldSpec("runs", DataType.LONG, M),
        FieldSpec("score", DataType.DOUBLE, M),
        FieldSpec("salary", DataType.LONG, M),
        FieldSpec("nick", S),
        FieldSpec("bonus", DataType.LONG, M),
        FieldSpec("ratio", DataType.DOUBLE, M),
        FieldSpec("big", DataType.LONG, M)])


def build_stats(out, name="stats"):
    """Two JAX segments over the row halves, and their port copies."""
    cols = stats_frame()
    segs = []
    for i, sl in enumerate([slice(0, N // 2), slice(N // 2, N)]):
        SegmentBuilder(stats_schema(), f"{name}_{i}",
                       indexing_config=IndexingConfig(
                           no_dictionary_columns=RAW)).build(
            {k: v[sl] for k, v in cols.items()}, str(out))
        segs.append(load_segment(str(out / f"{name}_{i}")))
    return segs, carry(segs, "stats")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return {"stats": build_stats(tmp_path_factory.mktemp("torch_columns"))}


def test_columns_carry_across(data):
    jsegs, tsegs = data["stats"]
    for jseg, tseg in zip(jsegs, tsegs):
        for col, jcm in jseg.metadata.columns.items():
            tcm = tseg.metadata.column(col)
            assert (tcm.has_dictionary, tcm.single_value, tcm.has_nulls,
                    tcm.max_num_multi_values, tcm.min_value, tcm.max_value) \
                == (jcm.has_dictionary, jcm.single_value, jcm.has_nulls,
                    jcm.max_num_multi_values, jcm.min_value,
                    jcm.max_value), col
            jds, tds = jseg.data_source(col), tseg.data_source(col)
            if jcm.single_value:
                np.testing.assert_array_equal(tds.forward_index,
                                              jds.forward_index, col)
            else:
                for t, j in zip(tds.dense_mv(), jds.dense_mv()):
                    np.testing.assert_array_equal(t, j, col)
            if jcm.has_nulls:
                np.testing.assert_array_equal(tds.null_bitmap,
                                              jds.null_bitmap, col)
        # a round trip through the port's own columns_of changes nothing
        again = carry([tseg], "stats")[0]
        for col in tseg.metadata.columns:
            a, b = columns_of(again)[col], columns_of(tseg)[col]
            for f in ("dictionary", "dict_ids", "values", "mv_counts",
                      "null"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), (col, f)
                if x is not None:
                    np.testing.assert_array_equal(x, y, f"{col}.{f}")
    assert tsegs[0].metadata.column("tags").has_nulls
    assert not tsegs[0].metadata.column("salary").has_dictionary


def test_staged_raw_columns_keep_their_dtype(data):
    """Raw integers stage in their stats dtype (i64 past 2^31), raw floats
    in f64 for the general rung and f32 as fused-scan values."""
    import torch

    _, tsegs = data["stats"]
    staged = StagedSegment(tsegs[0], device="cpu")
    assert staged.column("salary").fwd.dtype == torch.int32
    assert staged.column("big").fwd.dtype == torch.int64
    assert staged.column("ratio").fwd.dtype == torch.float64
    assert staged.value_column("big").dtype == torch.int64
    assert staged.value_column("ratio").dtype == torch.float32
    tags = staged.column("tags")
    assert tags.mv.shape == (tsegs[0].padded_capacity, 3)
    assert tags.null is not None and tags.fwd is None
    assert staged.packed_column("salary") is None


S0 = "stats"
# (case id, sql): every new filter leaf, value op and MV aggregation
LEAF_CASES = [
    ("veq, vneq", "SELECT count(*), sum(runs) FROM stats "
                  "WHERE salary != 2500000 AND bonus = 17"),
    ("vrange exclusive, int", "SELECT count(*), sum(salary), min(bonus) "
                              "FROM stats WHERE salary > 100000 "
                              "AND salary < 3000000"),
    ("vrange inclusive, float", "SELECT count(*), sum(ratio), max(ratio) "
                                "FROM stats WHERE ratio BETWEEN 0.25 AND 0.5"),
    ("vrange open, i64", "SELECT count(*), sum(big), min(big), max(big) "
                         "FROM stats WHERE big >= 0"),
    ("vin, vnotin", "SELECT count(*), avg(salary) FROM stats "
                    "WHERE bonus IN (1, 2, 3, 400) OR bonus NOT IN (5, 6)"),
    ("literal past the staged dtype", "SELECT count(*) FROM stats "
                                      "WHERE salary = 99999999999 "
                                      "OR salary > 99999999999"),
    ("mv_eq", "SELECT count(*), sum(runs) FROM stats WHERE tags = 't1'"),
    ("mv_lut and exclusive NOT IN", "SELECT count(*) FROM stats "
                                    "WHERE tags IN ('t0', 't3') "
                                    "AND nums NOT IN (4, 5)"),
    ("mv_range, exclusive !=", "SELECT count(*) FROM stats "
                               "WHERE nums BETWEEN 5 AND 10 AND tags != 't2'"),
    ("isnull, isnotnull", "SELECT count(*), sum(runs) FROM stats "
                          "WHERE nick IS NULL OR (bonus IS NOT NULL "
                          "AND tags IS NULL)"),
    ("isnull folded on a column without nulls", "SELECT count(*) FROM stats "
                                                "WHERE year IS NULL "
                                                "OR team IS NOT NULL"),
    ("divide, mod, floordiv", "SELECT sum(salary / 7), sum(runs % 7), "
                              "sum(floordiv(salary, 1000)), "
                              "max(score / 3) FROM stats WHERE league = 'AL'"),
    ("MV aggregations", "SELECT countmv(nums), summv(nums), minmv(nums), "
                        "maxmv(nums), avgmv(nums) FROM stats "
                        "WHERE team IN ('BOS', 'NYA')"),
    ("MV aggregations, no match", "SELECT countmv(nums), minmv(nums), "
                                  "maxmv(nums) FROM stats WHERE runs > 1000"),
    ("graw keys", "SELECT bonus, count(*), sum(salary) FROM stats "
                  "WHERE league = 'NL' GROUP BY bonus"),
    ("graw and gdict keys, raw values", "SELECT bonus, team, sum(big), "
                                        "avg(ratio), minmaxrange(salary) "
                                        "FROM stats GROUP BY bonus, team"),
    ("gexpr with mod and floordiv", "SELECT year % 5, floordiv(runs, 10), "
                                    "count(*) FROM stats "
                                    "GROUP BY year % 5, floordiv(runs, 10)"),
]


@pytest.mark.parametrize("case", LEAF_CASES, ids=[c[0] for c in LEAF_CASES])
def test_body_equals_jax_leaf_by_leaf(data, case):
    what, sql = case
    jsegs, tsegs = data["stats"]
    for jseg, tseg in zip(jsegs, tsegs):
        jp = j_plan(j_compile(sql), jseg)
        tp = t_plan(t_compile(sql), tseg)
        assert tp.spec == jp.spec, what
        assert len(tp.params) == len(jp.params)
        for a, b in zip(tp.params, jp.params):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype, what
        _assert_tree_equal(_run_port(tseg, tp, None), _run_jax(jseg, jp, None),
                           tp.spec, what)


def test_leaf_cases_cover_the_new_ops(data):
    _, tsegs = data["stats"]
    ops = set()

    def walk(node):
        ops.add(node[0])
        if node[0] in ("and", "or", "not"):
            for c in node[1]:
                walk(c)

    def values(v):
        if v is not None:
            ops.add(v[0] if v[0] != "fn" else v[1])
            for a in (v[2] if v[0] == "fn" else ()):
                values(a)

    for _, sql in LEAF_CASES:
        spec = t_plan(t_compile(sql), tsegs[0]).spec
        walk(spec[0])
        for a in spec[1]:
            if len(a) == 4:
                values(a[2])
                if a[1]:
                    ops.add(a[0] + "mv")
        ops.update(g[0] for g in spec[2])
    assert {"veq", "vneq", "vrange", "vin", "vnotin", "false", "mv_eq",
            "mv_lut", "mv_range", "isnull", "isnotnull", "divide", "mod",
            "floordiv", "colmv", "countmv", "summv", "minmv", "maxmv",
            "avgmv", "graw", "gexpr", "gdict"} <= ops


# end to end: general-rung queries (the fused scan declines them) and the
# raw-value queries the fused scan serves
END_TO_END_SQL = [
    "SELECT team, count(*), sum(salary), min(salary), max(salary) "
    "FROM stats WHERE league = 'AL' GROUP BY team ORDER BY team",
    "SELECT sum(salary), avg(ratio), count(*) FROM stats",
    "SELECT league, sum(big), avg(bonus) FROM stats WHERE year > 2000 "
    "GROUP BY league ORDER BY league",
    "SELECT count(*), sum(runs) FROM stats WHERE salary BETWEEN 100000 "
    "AND 900000 AND team = 'BOS'",
    "SELECT team, count(*), max(score) FROM stats WHERE tags = 't1' "
    "GROUP BY team ORDER BY team",
    "SELECT count(*) FROM stats WHERE tags NOT IN ('t0', 't1')",
    "SELECT count(*), sum(runs) FROM stats WHERE nick IS NULL",
    "SELECT league, count(*) FROM stats WHERE bonus IS NOT NULL "
    "GROUP BY league ORDER BY league",
    "SELECT countmv(nums), summv(nums), minmv(nums), maxmv(nums), "
    "avgmv(nums) FROM stats WHERE league = 'NL'",
    "SELECT bonus, count(*) FROM stats WHERE team = 'SFO' GROUP BY bonus "
    "ORDER BY count(*) DESC, bonus LIMIT 10",
    "SELECT min(big), max(big) FROM stats WHERE ratio < 0.3",
    "SELECT sum(salary / 3), sum(runs % 4) FROM stats WHERE nums = 7",
    "SELECT count(*), sum(runs) FROM stats WHERE salary = 99999999999 "
    "OR team = 'BOS'",
]


@pytest.mark.parametrize("i", range(len(END_TO_END_SQL)))
def test_sql_matches_jax(data, executors, i):  # noqa: F811
    _check(data, executors, "stats", END_TO_END_SQL[i])


def test_raw_value_columns_ride_the_fused_scan(data, executors):  # noqa: F811
    """Raw SV numeric value columns reach the fused scan as value columns,
    per segment, a plan with no packed column among them."""
    for sql in END_TO_END_SQL[:3]:
        off, on = _check(data, executors, "stats", sql)
        assert not _pallas_decisions(on) and on.general_launches == 0, sql
        assert off.general_launches == 2, sql
    _, tsegs = data["stats"]
    tp = t_plan(t_compile(END_TO_END_SQL[1]), tsegs[0])
    inp = tfs.scan_inputs(tp, StagedSegment(tsegs[0], device="cpu"))
    assert inp.words == [] and inp.pp.value_names == ["salary", "ratio"]


# shapes the JAX package serves on its host engine: the port's host engine
# serves them, reached with the JAX planner's reason code
HOST_SQL = [
    "SELECT team, summv(nums) FROM stats GROUP BY team",
    "SELECT minmaxrangemv(nums) FROM stats",
    "SELECT distinctcount(salary) FROM stats",
    "SELECT distinctcount(tags) FROM stats",
    "SELECT distinctcountmv(tags) FROM stats",
    "SELECT distinctcounthll(salary) FROM stats",
    "SELECT distinctcounthll(tags) FROM stats",
    "SELECT sum(nums + 1) FROM stats",
    "SELECT tags, count(*) FROM stats GROUP BY tags",
    "SELECT ratio, count(*) FROM stats GROUP BY ratio",
    "SELECT salary, count(*) FROM stats GROUP BY salary",
    "SELECT count(*) FROM stats WHERE runs + 1 > 10",
    "SELECT sum(abs(runs)) FROM stats",
    "SELECT sum(tags) FROM stats",
    "SELECT summv(tags) FROM stats",
    "SELECT mode(runs) FROM stats",
    "SELECT percentile95(runs) FROM stats",
    "SELECT percentiletdigest(runs, 50) FROM stats",
    "SELECT distinctcountthetasketch(team) FROM stats",
    "SELECT idset(team) FROM stats",
    "SELECT sumprecision(runs) FROM stats",
    "SELECT lastwithtime(runs, year, 'LONG') FROM stats",
    "SELECT stunion(team) FROM stats",
]


@pytest.mark.parametrize("sql", HOST_SQL)
def test_host_served_shapes_raise_with_the_jax_code(data, sql):
    """The JAX planner sends each shape to its host engine; the port's
    host engine serves it with the same code recorded per segment and the
    JAX rows (it raised NotPortedError with that code before the host
    engine was ported), or raises the JAX host engine's error."""
    from pinot_tpu.engine import ServerQueryExecutor as JExecutor

    from tests.test_torch_host_engine import assert_same_answer, run

    jsegs, tsegs = data["stats"]
    with pytest.raises(JPlanError) as je:
        j_plan(j_compile(sql), jsegs[0])
    for fused in (True, False):
        got = run(ServerQueryExecutor(device="cpu", use_fused_scan=fused),
                  t_compile, sql, tsegs)
        assert_same_answer(got, run(JExecutor(use_device=True,
                                              use_pallas=fused),
                                    j_compile, sql, jsegs), sql)
        if got[1] is not None:
            assert got[1].decisions[f"plan:device_kernel->host_engine:"
                                    f"{je.value.reason_code}"] == len(tsegs)


def test_time_transforms_raise_not_ported(data, executors):  # noqa: F811
    """The epoch transforms are rewritten at plan time into device integer
    ops, as the JAX planner rewrites them. toEpochDays over the raw LONG
    ``big`` as a value gives JAX's row on both rungs (the fused scan
    declines its floordiv with JAX's code); dateTrunc('DAY', big) as a
    group key spans 2^40 values, which the JAX planner sends to its host
    engine: the port's host engine serves it with the same code (it
    raised NotPortedError before the host engine was ported)."""
    from tests.test_torch_host_engine import assert_same_answer, run

    jsegs, tsegs = data["stats"]
    sql = "SELECT sum(toEpochDays(big)) FROM stats"
    _off, on = _check(data, executors, "stats", sql)
    assert set(on.decisions) == {
        "pallas:pallas_kernel->jnp_kernel:pallas_agg_value_op_unsupported"}
    sql = ("SELECT dateTrunc('DAY', big), count(*) FROM stats "
           "GROUP BY dateTrunc('DAY', big)")
    with pytest.raises(JPlanError) as je:
        j_plan(j_compile(sql), jsegs[0])
    assert je.value.reason_code == "group_expression_span_over_limit"
    got = run(ServerQueryExecutor(device="cpu"), t_compile, sql, tsegs)
    assert_same_answer(got, run(executors["pallas"], j_compile, sql, jsegs),
                       sql)
    assert got[1].decisions == {
        "plan:device_kernel->host_engine:group_expression_span_over_limit":
            len(tsegs)}


def test_isnull_leaf_leaves_the_staged_bitmap_alone(data):
    """A filter that is one isnull leaf is the staged null bitmap itself;
    masking it to the segment's docs must not write into it."""
    import torch

    from pinot_tpu_torch.engine import kernels as tk

    _, tsegs = data["stats"]
    tp = t_plan(t_compile("SELECT count(*) FROM stats WHERE nick IS NULL"),
                tsegs[0])
    assert tp.spec[0] == ("isnull", "nick")
    staged = StagedSegment(tsegs[0], device="cpu")
    before = staged.column("nick").null.clone()
    body = tk.build_kernel_body(tp.spec)
    out = body({c: staged.column(c).tree() for c in tp.columns},
               tk.device_params(tp, torch.device("cpu")), 10, 0,
               torch.device("cpu"))
    assert int(out["num_matched"]) == int(before[:10].sum())
    assert torch.equal(staged.column("nick").null, before)


def test_port_builder_equals_the_jax_builder(data):
    """The port's in-memory SegmentBuilder (raw columns, MV lists with
    null rows, None in SV columns) builds the JAX builder's columns from
    the same rows: dictionaries, dictIds, dense MV and counts, raw values,
    null bitmaps and stats."""
    from pinot_tpu_torch.segment import SegmentBuilder as TBuilder
    from pinot_tpu_torch.spi import DataType as TType
    from pinot_tpu_torch.spi import FieldSpec as TField
    from pinot_tpu_torch.spi import Schema as TSchema

    jsegs, _ = data["stats"]
    frame = {k: v[:N // 2] for k, v in stats_frame().items()}
    schema = TSchema("stats", [
        TField(fs.name, TType.from_string(fs.data_type.label),
               fs.field_type.value, single_value=fs.single_value)
        for fs in stats_schema().field_specs])
    tseg = TBuilder(schema, "stats_0", no_dictionary_columns=RAW).build(frame)
    want, got = columns_of(jsegs[0]), columns_of(tseg)
    assert set(got) == set(want)
    for col, w in want.items():
        g = got[col]
        assert (g.min_value, g.max_value) == (w.min_value, w.max_value), col
        for f in ("dictionary", "dict_ids", "values", "mv_counts", "null"):
            x, y = getattr(g, f), getattr(w, f)
            assert (x is None) == (y is None), (col, f)
            if x is not None:
                np.testing.assert_array_equal(x, y, f"{col}.{f}")
