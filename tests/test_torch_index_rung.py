"""The index rung in the port against the JAX package's: the cases of
tests/test_index_rung.py that need no mutable segment, on the user-events
table built by the JAX package with its indexes
(``pinot_tpu/tools/usertable.py`` ``user_indexing_config``) and carried
across into port segments built with the port's same config.

Each query runs through port ServerQueryExecutor(device="cpu") (the index
rung where it applies), the same SQL with ``OPTION(useIndexRung=false)``
(the scan rungs) and the JAX executor (use_pallas=False: its index rung,
then its jnp rung) and host engine on the JAX segments. Equal: rows, the
``index:`` decisions with their counts, ``num_docs_scanned``,
``num_segments_pruned`` and ``group_by_rung``. Rows are integer counts and
sums, compared exactly.
"""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.common import tracing  # noqa: E402
from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu.tools import usertable as j_user  # noqa: E402
from pinot_tpu_torch.engine import index_exec  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.staging import INDEX_SLICE_CAP  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import (  # noqa: E402
    columns_of,
    segment_from_arrays,
)
from pinot_tpu_torch.spi import IndexingConfig  # noqa: E402
from pinot_tpu_torch.tools import usertable as t_user  # noqa: E402

ROWS = 60_000
N_SEGS = 2

SERVED = "index:scan->index_gather:index_served"
DECLINED = "index:index_gather->scan:{}"
NO_INDEX = " OPTION(useIndexRung=false)"


def carry_indexed(jsegs, table, cfg):
    return [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                table_name=table, indexing=cfg)
            for j in jsegs]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_index_rung")
    jsegs = j_user.build_segments(str(out), num_segments=N_SEGS, rows=ROWS,
                                  workers=1)
    frame = {}
    per = ROWS // N_SEGS
    for i in range(N_SEGS):
        f = j_user.generate_frame(i, N_SEGS, per)
        for k, v in f.items():
            if k == "tags":
                frame.setdefault(k, []).extend(v)
            else:
                frame[k] = (v if k not in frame
                            else np.concatenate([frame[k], v]))
    tsegs = carry_indexed(jsegs, "user_events", t_user.user_indexing_config())
    return {"jsegs": jsegs, "tsegs": tsegs, "frame": frame,
            "port": ServerQueryExecutor(device="cpu"),
            "jax": JExecutor(use_device=True, use_pallas=False),
            "host": JExecutor(use_device=False)}


def _rows(result):
    return sorted(tuple(r) for r in result.rows)


def _index_keys(stats):
    return {k: v for k, v in stats.decisions.items()
            if k.startswith("index:")}


def _run3(setup, sql):
    """-> (port index run (rows, stats), port scan-rung rows, host-oracle
    rows), each held to the JAX executor's index run."""
    r_i, s_i = setup["port"].execute(t_compile(sql), setup["tsegs"])
    r_s, s_s = setup["port"].execute(t_compile(sql + NO_INDEX),
                                     setup["tsegs"])
    j_i, js_i = setup["jax"].execute(j_compile(sql), setup["jsegs"])
    r_h, _ = setup["host"].execute(j_compile(sql), setup["jsegs"])
    assert _rows(r_i) == _rows(j_i), sql
    assert _index_keys(s_i) == _index_keys(js_i), (sql, s_i.decisions,
                                                   js_i.decisions)
    for f in ("num_docs_scanned", "num_segments_pruned", "group_by_rung"):
        assert getattr(s_i, f) == getattr(js_i, f), (f, sql)
    assert not _index_keys(s_s)
    return (r_i, s_i), _rows(r_s), _rows(r_h)


def _tail_user(frame, lo=3, hi=50):
    uniq, cnt = np.unique(frame["user_id"], return_counts=True)
    for u, c in zip(uniq.tolist(), cnt.tolist()):
        if lo <= c <= hi:
            return int(u), int(c)
    raise AssertionError("no tail user in range")


def test_indexes_carried_across(setup):
    """The port segments carry the JAX segments' indexes."""
    for j, t in zip(setup["jsegs"], setup["tsegs"]):
        for col in ("user_id", "country", "event_type", "tags"):
            jc, tc = j.metadata.column(col), t.metadata.column(col)
            assert tc.has_inverted_index and jc.has_inverted_index
            np.testing.assert_array_equal(
                t.data_source(col).inverted_index[0],
                j.data_source(col).inverted_index[0])
        assert t.metadata.column("latency_ms").has_range_index
        np.testing.assert_array_equal(t.data_source("latency_ms").range_order,
                                      j.data_source("latency_ms").range_order)


# -- parity across filter shapes --------------------------------------------

def test_eq_point_group_by_parity(setup):
    u, c = _tail_user(setup["frame"])
    (r_i, s_i), scan, oracle = _run3(
        setup, f"SELECT event_type, count(*), sum(revenue) FROM user_events "
               f"WHERE user_id = {u} GROUP BY event_type")
    assert _rows(r_i) == scan == oracle
    assert s_i.group_by_rung == "index"
    assert s_i.num_docs_scanned == c
    assert s_i.decisions.get(SERVED) == N_SEGS
    assert s_i.index_launches == N_SEGS and s_i.general_launches == 0


def test_string_in_and_range_parity(setup):
    u, _ = _tail_user(setup["frame"])
    for sql in (
        f"SELECT country, count(*), sum(num_items) FROM user_events "
        f"WHERE user_id IN ({u}, 987654321) GROUP BY country",
        f"SELECT count(*), sum(revenue) FROM user_events "
        f"WHERE user_id = {u} AND latency_ms BETWEEN 10 AND 200",
        f"SELECT count(*) FROM user_events WHERE user_id = {u} "
        f"AND event_type IN ('click', 'purchase')",
        f"SELECT device, count(*) FROM user_events WHERE user_id = {u} "
        f"AND country = 'US' GROUP BY device",
        # exclusive bounds, the range tested on the user's docs
        f"SELECT count(*) FROM user_events WHERE user_id = {u} "
        f"AND latency_ms > 40 AND latency_ms < 90",
    ):
        (r_i, s_i), scan, oracle = _run3(setup, sql)
        assert _rows(r_i) == scan == oracle, sql
        assert s_i.decisions.get(SERVED) == N_SEGS, (sql, s_i.decisions)


def test_mv_postings_union_parity(setup):
    u, _ = _tail_user(setup["frame"])
    (r_i, s_i), scan, oracle = _run3(
        setup, f"SELECT count(*) FROM user_events WHERE user_id = {u} "
               f"AND tags = 'tag3'")
    assert _rows(r_i) == scan == oracle
    assert s_i.decisions.get(SERVED) == N_SEGS


def test_dict_encoded_sum_parity(setup):
    """``dictvals`` is not gathered: the dictionary-encoded revenue sums by
    its gathered dictIds."""
    u, c = _tail_user(setup["frame"])
    frame = setup["frame"]
    (r_i, s_i), scan, oracle = _run3(
        setup, f"SELECT sum(revenue), sum(num_items), min(revenue), "
               f"max(revenue) FROM user_events WHERE user_id = {u}")
    assert _rows(r_i) == scan == oracle
    m = frame["user_id"] == u
    assert _rows(r_i)[0][0] == float(frame["revenue"][m].sum())
    assert s_i.num_docs_scanned == c


def test_empty_match_is_index_served(setup):
    (r_i, s_i), scan, oracle = _run3(
        setup, "SELECT count(*), sum(revenue) FROM user_events "
               "WHERE user_id = 987654321")
    assert _rows(r_i) == scan == oracle
    assert s_i.num_docs_scanned == 0
    served = s_i.decisions.get(SERVED, 0)
    assert served >= 1
    assert served + s_i.num_segments_pruned == N_SEGS


def test_parity_fuzz_random_conjunctions(setup):
    frame = setup["frame"]
    rng = np.random.default_rng(42)
    uniq = np.unique(frame["user_id"])
    served = 0
    for _ in range(12):
        u = int(uniq[rng.integers(0, uniq.size)])
        lo = int(rng.integers(1, 150))
        hi = lo + int(rng.integers(10, 300))
        preds = [f"user_id = {u}"]
        m = frame["user_id"] == u
        if rng.random() < 0.5:
            preds.append(f"latency_ms BETWEEN {lo} AND {hi}")
            m = m & (frame["latency_ms"] >= lo) & (frame["latency_ms"] <= hi)
        if rng.random() < 0.5:
            preds.append("event_type IN ('view', 'cart')")
            m = m & np.isin(frame["event_type"], ["view", "cart"])
        sql = (f"SELECT count(*), sum(revenue) FROM user_events "
               f"WHERE {' AND '.join(preds)}")
        (r_i, s_i), scan, oracle = _run3(setup, sql)
        assert _rows(r_i) == scan == oracle, sql
        if s_i.decisions.get(SERVED) == N_SEGS:
            served += 1
            assert s_i.num_docs_scanned == int(m.sum()), sql
    assert served >= 8


# -- declines, each recorded with JAX's code --------------------------------

def test_over_threshold_declines_to_scan(setup):
    (r_i, s_i), scan, oracle = _run3(
        setup, "SELECT country, count(*) FROM user_events "
               "WHERE latency_ms >= 1 GROUP BY country")
    assert _rows(r_i) == scan == oracle
    assert s_i.group_by_rung != "index"
    assert s_i.decisions.get(
        DECLINED.format("index_selectivity_over_threshold")) == N_SEGS
    assert SERVED not in s_i.decisions


def test_missing_index_declines(setup):
    (r_i, s_i), scan, oracle = _run3(
        setup, "SELECT count(*) FROM user_events WHERE device = 'ios'")
    assert _rows(r_i) == scan == oracle
    assert s_i.decisions.get(DECLINED.format("index_missing_index")) == N_SEGS


def test_or_shape_declines(setup):
    u, _ = _tail_user(setup["frame"])
    (r_i, s_i), scan, oracle = _run3(
        setup, f"SELECT count(*) FROM user_events WHERE user_id = {u} "
               f"OR device = 'ios'")
    assert _rows(r_i) == scan == oracle
    assert s_i.decisions.get(DECLINED.format("index_filter_shape")) == N_SEGS


def test_every_reason_code_is_registered(setup):
    """Every index decision the port records uses a code the JAX package
    registers (``tracing.INDEX_DECISION_REASONS``), and the port's rung
    declines only through the codes its module names."""
    registered = tracing.INDEX_DECISION_REASONS
    u, _ = _tail_user(setup["frame"])
    seen = set()
    for sql in (
        f"SELECT count(*) FROM user_events WHERE user_id = {u}",
        "SELECT count(*) FROM user_events WHERE latency_ms >= 1",
        "SELECT count(*) FROM user_events WHERE device = 'web'",
        "SELECT count(*) FROM user_events WHERE device != 'web'",
        f"SELECT count(*) FROM user_events WHERE NOT user_id = {u}",
    ):
        _, s = setup["port"].execute(t_compile(sql), setup["tsegs"])
        seen |= {k.rsplit(":", 1)[1] for k in _index_keys(s)}
    assert seen and seen <= registered, seen
    assert {"index_served", "index_selectivity_over_threshold",
            "index_missing_index", "index_pred_type_unsupported",
            "index_filter_shape"} <= seen
    # the catch-all decline of a failed launch is a planned difference
    src = open(index_exec.__file__).read()
    assert '"index_exec_failed"' not in src and "except Exception" not in src
    # the consuming segment's gather records under the same point with the
    # codes JAX registers for it (``tracing.MUTABLE_DECLINE_REASONS``)
    from pinot_tpu_torch.engine import mutable_staging
    from pinot_tpu_torch.segment.mutable import MutableSegment

    seg = MutableSegment(t_user.user_schema(), "user_events__0__0")
    for row in t_user.frame_rows(t_user.generate_frame(0, 1, 4000)):
        seg.index(row)
    mutable = set()
    for sql in (
        f"SELECT count(*) FROM user_events WHERE user_id = {u}",
        "SELECT count(*) FROM user_events WHERE device = 'web'",
        "SELECT count(*) FROM user_events WHERE tags = 'tag3'",
        f"SELECT count(*) FROM user_events WHERE NOT user_id = {u}",
        "SELECT country, distinctcounthll(user_id) FROM user_events "
        "GROUP BY country",
    ):
        _, s = setup["port"].execute(t_compile(sql), [seg])
        mutable |= {k.rsplit(":", 1)[1] for k in s.decisions}
    assert mutable <= tracing.MUTABLE_DECLINE_REASONS, mutable
    assert {"mutable_index_served", "mutable_index_over_threshold",
            "mutable_index_unsupported_shape",
            "mutable_hll_lut_unstable"} <= mutable
    src = open(mutable_staging.__file__).read()
    assert '"mutable_exec_failed"' not in src \
        and '"mutable_index_exec_failed"' not in src \
        and "except Exception" not in src


def test_operator_opt_out_is_silent(setup):
    u, _ = _tail_user(setup["frame"])
    _, s = setup["port"].execute(t_compile(
        f"SELECT count(*) FROM user_events WHERE user_id = {u} "
        f"OPTION(useIndexRung=false)"), setup["tsegs"])
    assert not _index_keys(s) and s.index_launches == 0


# -- sorted-column route ----------------------------------------------------

def test_sorted_column_route(tmp_path):
    """A dictionary column whose values arrive sorted is ``is_sorted``;
    EQ / IN resolve to docId runs by binary search, with no index."""
    n = 20_000
    rng = np.random.default_rng(3)
    schema = Schema("sorted_t", [
        FieldSpec("k", DataType.INT, FieldType.DIMENSION),
        FieldSpec("v", DataType.INT, FieldType.METRIC),
    ])
    frame = {"k": np.sort(rng.integers(0, 2000, n)).astype(np.int64),
             "v": rng.integers(1, 100, n).astype(np.int64)}
    SegmentBuilder(schema, "sorted_0").build(frame, str(tmp_path))
    jseg = load_segment(str(tmp_path / "sorted_0"))
    tseg = carry_indexed([jseg], "sorted_t", IndexingConfig())[0]
    assert tseg.metadata.column("k").is_sorted
    assert jseg.metadata.column("k").is_sorted
    assert not tseg.metadata.column("v").is_sorted
    k = int(frame["k"][n // 2])
    for sql in (
        f"SELECT count(*), sum(v) FROM sorted_t WHERE k = {k}",
        f"SELECT count(*) FROM sorted_t WHERE k IN ({k}, {k + 1})",
        f"SELECT count(*) FROM sorted_t WHERE k IN ({k}, {k + 3}, {k + 9})",
        # two sorted routes: the narrower's docs tested against the other
        f"SELECT count(*), sum(v) FROM sorted_t WHERE k BETWEEN {k - 5} "
        f"AND {k + 5} AND k IN ({k}, {k + 3}, {k + 50})",
    ):
        got, s = ServerQueryExecutor(device="cpu").execute(t_compile(sql),
                                                           [tseg])
        want, js = JExecutor(use_device=True, use_pallas=False).execute(
            j_compile(sql), [jseg])
        host, _ = JExecutor(use_device=False).execute(j_compile(sql), [jseg])
        assert _rows(got) == _rows(want) == _rows(host), sql
        assert _index_keys(s) == _index_keys(js) == {SERVED: 1}, sql
        assert s.num_docs_scanned == js.num_docs_scanned


# -- the docId arrays on the device ------------------------------------------

def test_idx_slices_accounted_and_capped(setup):
    """The docId arrays count in the staged segment's bytes and stay
    bounded under filter churn (least recently used out past the cap);
    dropped, later queries rebuild them."""
    frame = setup["frame"]
    seg = setup["tsegs"][0]
    ex = ServerQueryExecutor(device="cpu")
    for u in np.unique(frame["user_id"])[:80].tolist():
        ex.execute(t_compile(f"SELECT count(*) FROM user_events "
                             f"WHERE user_id = {int(u)}"), [seg])
    staged = ex.stage(seg)
    assert staged.index_nbytes() > 0
    assert len(staged._index_slices) == INDEX_SLICE_CAP
    assert staged.nbytes() >= staged.index_nbytes()
    staged._index_slices.clear()
    assert staged.index_nbytes() == 0
    u, c = _tail_user(frame)
    r, s = ex.execute(t_compile(f"SELECT count(*) FROM user_events "
                                f"WHERE user_id = {u}"), setup["tsegs"])
    assert s.decisions.get(SERVED) == N_SEGS
    assert r.rows[0][0] == c


def test_eviction_churn_keeps_parity(setup):
    """Evicting the staged segments between index-served queries stages
    them and their docId arrays again; the rows stay the same."""
    u, _ = _tail_user(setup["frame"])
    sql = (f"SELECT event_type, count(*) FROM user_events "
           f"WHERE user_id = {u} GROUP BY event_type")
    ex = ServerQueryExecutor(device="cpu")
    before, _ = ex.execute(t_compile(sql), setup["tsegs"])
    ex.residency.clear()    # the staged images and their docId arrays
    after, s = ex.execute(t_compile(sql), setup["tsegs"])
    oracle, _ = setup["host"].execute(j_compile(sql), setup["jsegs"])
    assert _rows(before) == _rows(after) == _rows(oracle)
    assert s.decisions.get(SERVED) == N_SEGS


# -- the batch path ---------------------------------------------------------

def test_selective_filter_leaves_the_batch(setup):
    """A filter every segment's indexes keep under the threshold leaves
    the batch for the per-segment index rung with no batch decision (JAX
    ``_index_rung_fit``); a broad one stays on the batch, where no index
    decision is recorded. Both equal the JAX sharded executor."""
    u, c = _tail_user(setup["frame"])
    ex = ShardedQueryExecutor(device="cpu")
    jex = JSharded(use_pallas=False)
    for sql, served in (
            (f"SELECT event_type, count(*), sum(revenue) FROM user_events "
             f"WHERE user_id = {u} GROUP BY event_type", True),
            ("SELECT country, count(*) FROM user_events "
             "WHERE latency_ms >= 1 GROUP BY country", False)):
        got, s = ex.execute(t_compile(sql), setup["tsegs"])
        want, js = jex.execute(j_compile(sql), setup["jsegs"])
        assert _rows(got) == _rows(want), sql
        assert _index_keys(s) == _index_keys(js), sql
        assert s.num_docs_scanned == js.num_docs_scanned
        assert s.group_by_rung == js.group_by_rung
        if served:
            assert s.decisions == {SERVED: N_SEGS}
            assert (s.index_launches, s.batch_general_launches) == (N_SEGS, 0)
            assert s.num_docs_scanned == c
        else:
            assert not _index_keys(s) and s.index_launches == 0
            assert len(ex._batches) == 1
