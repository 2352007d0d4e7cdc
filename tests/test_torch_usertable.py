"""The user-events table (raw ``latency_ms``, MV ``tags``) in the port
against the JAX package: the query mix U1-U7 of
``pinot_tpu_torch/tools/usertable.py`` on 4 user segments of 20 k rows
built by the JAX package and carried across; the port's own generator
(dtypes, MV counts, ``tail_users``); the batch path, where U2 is one
launch of the fused scan and the plans it declines one call of the jnp
combine; and chip_smoke's phases 8, 8b, 11a and 11b at a small size.

The JAX segments carry the table's indexes and the carried port segments
do not (``tests/test_torch_index_rung.py`` holds the index rung on
segments that carry them), so the JAX side runs with
``OPTION(useIndexRung=false)``: the scan rungs are what the port is held
to here (rows, rung per segment, decline codes). Tolerance: counts,
integer sums, min/max and keys exact; float cells (avg) rel 1e-5, abs
1e-6.
"""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JaxExecutor  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.tools import usertable as j_user  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.tools import usertable as t_user  # noqa: E402

from tests.test_torch_executor import _assert_rows, carry  # noqa: E402

ROWS = 80_000
SEGS = 4
SEED = 7
NO_INDEX = " OPTION(useIndexRung=false)"

# the rung and the fused scan's decline per query (None: the fused scan
# serves every segment)
EXPECT = {"U1": None, "U2": None, "U3": "pallas_vrange",
          "U4": "pallas_mv_eq", "U5": "pallas_mv_lut",
          "U6": "pallas_raw_group_key",
          "U7": "pallas_vin"}


@pytest.fixture(scope="module")
def users(tmp_path_factory):
    jsegs = j_user.build_segments(str(tmp_path_factory.mktemp("torch_user")),
                                  num_segments=SEGS, rows=ROWS, seed=SEED,
                                  workers=1)
    user = j_user.tail_users(ROWS, SEGS, SEED)[3]
    return jsegs, carry(jsegs, "user_events"), t_user.queries(user)


@pytest.fixture(scope="module")
def executors():
    return {"port_on": ServerQueryExecutor(device="cpu"),
            "port_off": ServerQueryExecutor(device="cpu",
                                            use_fused_scan=False),
            "pallas": JaxExecutor(use_device=True, use_pallas=True),
            "jnp": JaxExecutor(use_device=True, use_pallas=False)}


def _exact(table):
    return [not n.startswith("avg") for n in table.schema.column_names]


def _rungs_per_segment(ex, compile_, sql, segs):
    return [ex.execute(compile_(sql), [s])[1].group_by_rung for s in segs]


@pytest.mark.parametrize("qid", sorted(EXPECT))
def test_query_mix_matches_jax(users, executors, qid):
    jsegs, tsegs, sqls = users
    sql = sqls[qid]
    reason = EXPECT[qid]
    for port, ref in (("port_on", "pallas"), ("port_off", "jnp")):
        want, jstats = executors[ref].execute(j_compile(sql + NO_INDEX),
                                              jsegs)
        got, stats = executors[port].execute(t_compile(sql + NO_INDEX),
                                             tsegs)
        assert got.schema.column_names == want.schema.column_names
        _assert_rows(got.rows, want.rows, _exact(want), f"{port}: {sql}")
        assert stats.num_docs_scanned == jstats.num_docs_scanned, port
        if port == "port_off":
            assert stats.general_launches == SEGS and not stats.scan_launches
            continue
        codes = {k.rsplit(":", 1)[1] for k in stats.decisions}
        jcodes = {k.rsplit(":", 1)[1] for k in jstats.decisions
                  if k.startswith("pallas:")}
        assert codes == jcodes == ({reason} if reason else set()), qid
        assert stats.general_launches == (SEGS if reason else 0), qid
        if jstats.num_segments_processed == SEGS:
            assert stats.group_by_rung == jstats.group_by_rung, qid
        else:   # the JAX executor pruned: compare the segments it ran
            jr = _rungs_per_segment(executors[ref], j_compile,
                                    sql + NO_INDEX, jsegs)
            tr = _rungs_per_segment(executors[port], t_compile, sql, tsegs)
            assert [t for t, j in zip(tr, jr) if j] == [j for j in jr if j]


def test_u2_raw_metric_through_the_batch(users):
    """U2's raw latency_ms rides the fused scan over the whole batch in one
    scan; the plans the fused scan declines are one call of the jnp
    combine over the batch, equal to the JAX sharded executor's (its jnp
    combine): rows, docs scanned and the decline recorded once."""
    from pinot_tpu.parallel import ShardedQueryExecutor as JSharded

    jsegs, tsegs, sqls = users
    ex = ShardedQueryExecutor(device="cpu")
    got, stats = ex.execute(t_compile(sqls["U2"]), tsegs)
    want, _ = JaxExecutor(use_device=False).execute(j_compile(sqls["U2"]),
                                                    jsegs)
    _assert_rows(got.rows, want.rows, _exact(want), "U2 batch",
                 same_types=False)
    assert not stats.decisions and stats.general_launches == 0
    assert stats.num_segments_processed == SEGS
    jex = JSharded(use_pallas=True)
    for qid in ("U3", "U4", "U5", "U6", "U7"):
        sql = sqls[qid] + NO_INDEX
        got, stats = ex.execute(t_compile(sql), tsegs)
        want, jstats = jex.execute(j_compile(sql), jsegs)
        _assert_rows(got.rows, want.rows, _exact(want), f"{qid} batch")
        assert stats.decisions == jstats.decisions == {
            f"pallas:pallas_combine->jnp_combine:{EXPECT[qid]}": 1}, qid
        assert (stats.num_docs_scanned, stats.num_segments_matched,
                stats.group_by_rung) == (jstats.num_docs_scanned,
                                         jstats.num_segments_matched,
                                         jstats.group_by_rung), qid
        assert (stats.batch_general_launches, stats.general_launches) == \
            (1, 0), qid


def test_generator_shapes_and_tail_users():
    frame = t_user.generate_frame(0, 2, 5000, seed=3)
    tags, counts = frame["tags"]
    assert tags.shape == (5000, t_user.MAX_TAGS)
    assert counts.min() == 1 and counts.max() == 3
    lat = frame["latency_ms"]
    assert lat.dtype == np.int64 and lat.min() >= 1
    assert frame["country"].max() < len(t_user.COUNTRIES)
    assert t_user.tail_users(40_000, 2, seed=3) == \
        j_user.tail_users(40_000, 2, seed=3)
    segs, frames = t_user.build_segments(num_segments=2, rows=9_000, seed=3)
    seg = segs[0]
    md = seg.metadata
    assert not md.column("latency_ms").has_dictionary
    assert not md.column("tags").single_value
    assert md.column("tags").max_num_multi_values == 3
    assert md.column("latency_ms").min_value == int(
        frames[0]["latency_ms"].min())
    dense, cnt = seg.data_source("tags").dense_mv()
    assert cnt[:seg.num_docs].tolist() == frames[0]["tags"][1].tolist()
    d = seg.data_source("tags").dictionary
    got = [sorted(d.get_values(dense[i, :cnt[i]])) for i in range(50)]
    want = [sorted(t_user.TAGS[c] for c in frames[0]["tags"][0][i, :cnt[i]])
            for i in range(50)]
    assert got == want
    country = seg.data_source("country")
    assert country.dictionary.get_values(
        country.forward_index[:20]) == [t_user.COUNTRIES[c]
                                        for c in frames[0]["country"][:20]]


def test_numpy_oracle_matches_the_port():
    """The smoke's oracle (numpy over the generator's arrays alone) gives
    the port's rows on segments the port's generator built."""
    segs, frames = t_user.build_segments(num_segments=2, rows=30_000, seed=5)
    user = t_user.tail_users(30_000, 2, seed=5)[2]
    ex = ServerQueryExecutor(device="cpu")
    for qid, sql in t_user.queries(user).items():
        table, _ = ex.execute(t_compile(sql), segs)
        t_user.check_rows(qid, table.rows, t_user.numpy_answer(frames, qid,
                                                               user))
    with pytest.raises(AssertionError):
        t_user.check_rows("U3", [[1, 2.0]], [[1, 3]])


def test_smoke_user_phases_on_the_cpu():
    """chip_smoke.py's phase 8 and 8b, and phase 11 on phase 8's table, at
    a small size on the CPU: every oracle check, decline code and rung per
    segment as on the card (launch counts are read only on the card);
    11a U3-U7 over the batch on the jnp combine, equal to the per-segment
    rows, and 11b I1-I5 on the index rung of every segment, equal to the
    scan rungs."""
    import chip_smoke

    run = chip_smoke.phase_users(seed=3, reps=1, segments=2,
                                 rows_per_segment=15_000, device="cpu")
    assert set(run["per_query"]) == set(EXPECT)
    assert {q: p["decline"] for q, p in run["paths"].items()} == EXPECT
    combine = chip_smoke.phase_combine(run["combine_jobs"], reps=1,
                                       device="cpu")
    assert {q: r["decline"] for q, r in combine["queries"].items()} == {
        q: c for q, c in EXPECT.items() if c}
    assert {q: r["kept_segments"] for q, r in combine["queries"].items()} \
        == dict.fromkeys(("U3", "U4", "U5", "U6", "U7"), 2)
    index = chip_smoke.phase_index(run, reps=1, device="cpu")
    assert {q: r["kept_segments"] for q, r in index["queries"].items()} == \
        dict.fromkeys(("I1", "I2", "I3", "I4", "I5"), 2)
    cols = chip_smoke.phase_columns(seed=3, reps=1, n=30_000, device="cpu")
    assert set(cols["per_query"]) == {"N1", "N2", "M1", "V1"}
