"""The slice end to end: SQL -> port ServerQueryExecutor(device="cpu") ->
rows, against the JAX executor with the fused Pallas kernel (interpret
mode) and the JAX host executor, on the same segments; and the port's SSB
generator against the JAX package's.

Tolerance: counts, integer sums, keys and row order exact; cells that
aggregate floats rel 1e-5, abs 1e-6 (tests/test_pallas.py:101): the JAX
kernel sums floats as Neumaier f32 pairs, the port in f64.
"""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JaxExecutor  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import columns_of, segment_from_arrays  # noqa: E402
from pinot_tpu_torch.tools import ssb as t_ssb  # noqa: E402

from tests.test_torch_plan import GRAFT_SQL, PL_QUERIES, build_pl_sales  # noqa: E402

ROWS = 18_000
SEED = 5


def carry(jsegs, table):
    return [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                table_name=table) for j in jsegs]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    import __graft_entry__

    jssb = j_ssb.build_segments(
        0, str(tmp_path_factory.mktemp("torch_ex_ssb")), num_segments=2,
        seed=SEED, rows=ROWS, star_tree=False, workers=1)
    jpl = build_pl_sales(tmp_path_factory.mktemp("torch_ex_pl"))
    jgraft = __graft_entry__._build_segments(
        2, 2048, str(tmp_path_factory.mktemp("torch_ex_graft")))
    return {"ssb": (jssb, carry(jssb, "ssb_lineorder")),
            "pl": (jpl, carry(jpl, "pl_sales")),
            "graft": (jgraft, carry(jgraft, "sales"))}


@pytest.fixture(scope="module")
def executors():
    return {"port": ServerQueryExecutor(device="cpu"),
            "pallas": JaxExecutor(use_device=True, use_pallas=True),
            "host": JaxExecutor(use_device=False)}


def _exact_columns(sql, tseg):
    ctx = t_compile(sql)
    acc = {str(fn): spec[3] for fn, spec in
           zip(ctx.aggregations, t_plan(ctx, tseg).spec[1])}
    return [acc.get(str(e), "key") != "f32" for e in ctx.select_expressions]


def _assert_rows(got, want, exact, what, same_types=True):
    """``same_types=False`` against the JAX host engine, whose expression
    group keys are floats where the device paths' are ints."""
    assert len(got) == len(want), what
    for gr, wr in zip(got, want):
        for g, w, ex in zip(gr, wr, exact):
            if isinstance(w, float) and not ex:
                assert g == pytest.approx(w, rel=1e-5, abs=1e-6), (what, gr, wr)
            else:
                assert g == w, (what, gr, wr)
                assert type(g) is type(w) or not same_types, (what, gr, wr)


def _check(data, executors, key, sql):
    jsegs, tsegs = data[key]
    got, stats = executors["port"].execute(t_compile(sql), tsegs)
    exact = _exact_columns(sql, tsegs[0])
    for ref in ("pallas", "host"):
        want, jstats = executors[ref].execute(j_compile(sql), jsegs)
        assert got.schema.column_names == want.schema.column_names
        _assert_rows(got.rows, want.rows, exact, f"{ref}: {sql}")
        # the same segments pruned and processed, the same docs counted
        assert (stats.num_segments_processed, stats.num_segments_pruned,
                stats.total_docs) == (jstats.num_segments_processed,
                                      jstats.num_segments_pruned,
                                      jstats.total_docs), (ref, sql)
    return stats


@pytest.mark.parametrize("qid", sorted(j_ssb.QUERIES))
def test_ssb_rows_match_jax(data, executors, qid):
    stats = _check(data, executors, "ssb", j_ssb.QUERIES[qid] + " LIMIT 100000")
    # the plain version on the CPU is no kernel launch
    assert stats.probe_launches == 0 and stats.scan_launches == 0


@pytest.mark.parametrize("i", range(len(PL_QUERIES)))
def test_pl_sales_rows_match_jax(data, executors, i):
    _check(data, executors, "pl", PL_QUERIES[i])


def test_graft_entry_sql_matches_jax(data, executors):
    _check(data, executors, "graft", GRAFT_SQL)


def test_ssb_rows_match_oracle(data, executors):
    """The port's answers equal the port's own numpy oracle over frames the
    port generated for the same seed as the JAX segments."""
    _, tsegs = data["ssb"]
    frames = [t_ssb.generate_segment_frame(i, 2, n, seed=SEED)
              for i, n in enumerate(t_ssb.segment_rows(2, ROWS))]
    for qid, sql in t_ssb.QUERIES.items():
        table, _ = executors["port"].execute(t_compile(sql + " LIMIT 100000"),
                                             tsegs)
        want = t_ssb.merge_answers([t_ssb.numpy_answer(f, qid)
                                    for f in frames])
        if isinstance(want, int):
            assert table.rows == [[float(want)]], qid
        else:
            assert {tuple(r[:-1]): r[-1] for r in table.rows} == \
                {k: float(v) for k, v in want.items()}, qid


@pytest.mark.parametrize("i", [0, 1, 3])
def test_generator_frames_equal_jax(i):
    n = 4000
    want = j_ssb.generate_segment_frame(i, 4, n, seed=9)
    got = t_ssb.decode_frame(t_ssb.generate_segment_frame(i, 4, n, seed=9))
    assert set(got) == set(want)
    for col in want:
        np.testing.assert_array_equal(got[col], np.asarray(want[col]), col)


def test_generated_segments_equal_jax_built(data):
    """segment_from_frame (dictIds straight from codes) builds the same
    dictionaries and forward indexes as the JAX SegmentBuilder."""
    jsegs, _ = data["ssb"]
    tsegs, _ = t_ssb.build_segments(0, num_segments=2, rows=ROWS, seed=SEED)
    for jseg, tseg in zip(jsegs, tsegs):
        assert tseg.num_docs == jseg.num_docs
        jc, tc = columns_of(jseg), columns_of(tseg)
        assert sorted(tc) == sorted(jc)
        for col in jc:
            np.testing.assert_array_equal(tc[col].dictionary,
                                          jc[col].dictionary, col)
            np.testing.assert_array_equal(tc[col].dict_ids, jc[col].dict_ids,
                                          col)
            assert tc[col].min_value == jc[col].min_value


def test_not_ported_shapes_raise_with_reason(data, executors):
    """Shapes the fused scan declines are served by the general rung; a
    plan the JAX package sends to its host engine reaches the port's host
    engine with the JAX reason code and the JAX rows (it raised
    NotPortedError with that code before the host engine was ported)."""
    from tests.test_torch_host_engine import assert_same_answer, run

    jsegs, tsegs = data["ssb"]
    ex = ServerQueryExecutor(device="cpu")
    for sql, reason in (
            ("SELECT count(DISTINCT c_city) FROM ssb_lineorder",
             "pallas_distinct_agg"),
            ("SELECT max(lo_extendedprice * lo_discount) FROM ssb_lineorder",
             "pallas_minmax_not_f32_exact")):
        _, stats = ex.execute(t_compile(sql), tsegs)
        assert stats.general_launches == len(tsegs)
        assert set(stats.decisions) == {
            f"pallas:pallas_kernel->jnp_kernel:{reason}"}
    sql = ("SELECT c_city, count(DISTINCT s_city) FROM ssb_lineorder "
           "GROUP BY c_city")
    got = run(ex, t_compile, sql, tsegs)
    assert_same_answer(got, run(executors["pallas"], j_compile, sql, jsegs),
                       sql)
    assert got[1].decisions == {
        "plan:device_kernel->host_engine:agg_not_device_supported":
            len(tsegs)}
    assert got[1].general_launches == got[1].scan_launches == 0
