"""Consuming segments in the port against the JAX package.

Both packages index the same numpy-seeded rows into their own
``MutableSegment``, or consume the same JSON messages from their own
``MemoryStream``; the port runs with ``device="cpu"`` (its consuming rung
``mutable_device``: the general rung's body over the staged chunks), the
JAX package under ``JAX_PLATFORMS=cpu`` with
``ServerQueryExecutor(use_device=True)`` (its jnp ``mutable_device``
rung) and ``use_device=False`` (its host engine). Cases are
tests/test_realtime_tier.py's (watermark parity at 7, 107 and 1607 rows,
a concurrent writer, the HLL decline) and tests/test_index_rung.py's
consuming-segment gather, with: the dictIds, the seal (the sealed
segment's columns and star-tree equal to the JAX segment sealed to disk
and loaded, the offsets in ``custom``), ``consume_until_committed``
(rows, offsets and states), the transformers, the batch and top-k
refusals, residency, the delta uploads, and a failed staging or launch
raising.

Tolerance (the port's rule): counts, integer sums, min/max and keys exact;
float cells ``rel=1e-5, abs=1e-6``. Group rows are compared as sets: a
consuming segment's dictionary is arrival-ordered.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.common import tracing  # noqa: E402
from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.engine.plan import PlanError as JPlanError  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.ingestion import MemoryStream as JStream  # noqa: E402
from pinot_tpu.ingestion import realtime as jrt  # noqa: E402
from pinot_tpu.ingestion.stream import StreamOffset as JOffset  # noqa: E402
from pinot_tpu.ingestion.transformers import (  # noqa: E402
    CompositeTransformer as JComposite,
)
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.query.functions import eval_row_filter as j_row_filter  # noqa: E402
from pinot_tpu.query.parser import (  # noqa: E402
    parse_filter_expression as j_parse_filter,
)
from pinot_tpu.segment import load_segment  # noqa: E402
from pinot_tpu.segment.mutable import MutableSegment as JMutable  # noqa: E402
from pinot_tpu.spi import data as jdata  # noqa: E402
from pinot_tpu.spi import table as jtable  # noqa: E402
from pinot_tpu.tools import usertable as j_usertable  # noqa: E402
from pinot_tpu_torch.engine import kernels, mutable_staging  # noqa: E402
from pinot_tpu_torch.engine.errors import PlanError  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.host_eval import read_values  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.ingestion import (  # noqa: E402
    CompletionReply,
    CompletionResponse,
    ConsumerState,
    LocalCompletionProtocol,
    MemoryStream,
    RealtimeSegmentDataManager,
    StreamOffset,
)
from pinot_tpu_torch.ingestion.transformers import (  # noqa: E402
    CompositeTransformer,
)
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel.batch import SegmentBatch  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.query.functions import eval_row_filter  # noqa: E402
from pinot_tpu_torch.query.parser import parse_filter_expression  # noqa: E402
from pinot_tpu_torch.segment import columns_of, star_trees_of  # noqa: E402
from pinot_tpu_torch.segment.mutable import MutableSegment  # noqa: E402
from pinot_tpu_torch.spi import data as tdata  # noqa: E402
from pinot_tpu_torch.spi import table as ttable  # noqa: E402
from pinot_tpu_torch.tools import usertable  # noqa: E402

CITIES = ["nyc", "sf", "la", "chi", "sea"]
# tests/test_realtime_tier.py:73 TestConsumingDeviceParity.QUERIES, then a
# RANGE group-by (the arrival-ordered dictionary's dictId LUT) and a
# distinct count
QUERIES = [
    "SELECT city, count(*), sum(clicks), max(price) FROM rt "
    "WHERE clicks > 10 GROUP BY city LIMIT 100",
    "SELECT city, avg(price) FROM rt WHERE city IN ('nyc', 'sf') "
    "GROUP BY city LIMIT 100",
    "SELECT count(*), sum(clicks) FROM rt",
    "SELECT count(*) FROM rt WHERE price > 100.0 AND price <= 200.0",
    "SELECT min(clicks), max(clicks) FROM rt WHERE city <> 'la'",
    "SELECT city, sum(price), minmaxrange(clicks) FROM rt "
    "WHERE clicks BETWEEN 20 AND 60 GROUP BY city LIMIT 100",
    "SELECT distinctcount(city), count(*) FROM rt WHERE ts >= 1600000000050",
]
MUT_SERVED = "index:mutable_device->index_gather:mutable_index_served"
MUT_DECLINED = "index:index_gather->mutable_device:{}"
HLL_DECLINED = "mutable:mutable_device->host_engine:mutable_hll_lut_unstable"


def _schema(pkg):
    D, F, T = pkg.DataType, pkg.FieldSpec, pkg.FieldType
    return pkg.Schema("rt", [
        F("city", D.STRING, T.DIMENSION),
        F("clicks", D.LONG, T.METRIC),
        F("price", D.DOUBLE, T.METRIC),
        F("ts", D.LONG, T.DATE_TIME),
    ])


def _rows_of(n, seed, start=0):
    rng = np.random.default_rng(seed)
    return [{"city": CITIES[int(rng.integers(len(CITIES)))],
             "clicks": int(rng.integers(100)),
             "price": float(rng.integers(1000)) / 4.0,
             "ts": 1_600_000_000_000 + start + i} for i in range(n)]


def _pair(name, capacity=100_000):
    return (JMutable(_schema(jdata), name, capacity=capacity),
            MutableSegment(_schema(tdata), name, capacity=capacity))


def _index(pair, rows):
    for r in rows:
        pair[0].index(dict(r))
        pair[1].index(dict(r))


def _assert_same(got, want, what):
    """Row sets equal: exact but float cells within rel 1e-5."""
    g = sorted(map(list, got), key=repr)
    w = sorted(map(list, want), key=repr)
    assert len(g) == len(w), (what, got, want)
    for gr, wr in zip(sorted(g, key=lambda r: repr(r[0])),
                      sorted(w, key=lambda r: repr(r[0]))):
        for a, b in zip(gr, wr):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-5, abs=1e-6), (what, gr,
                                                                   wr)
            else:
                assert a == b, (what, gr, wr)


@pytest.fixture(scope="module")
def executors():
    return {"port": ServerQueryExecutor(device="cpu"),
            "jax": JExecutor(use_device=True),
            "host": JExecutor(use_device=False)}


def _three(executors, sql, jsegs, tsegs):
    got, stats = executors["port"].execute(t_compile(sql), tsegs)
    want, jstats = executors["jax"].execute(j_compile(sql), jsegs)
    host, _ = executors["host"].execute(j_compile(sql), jsegs)
    _assert_same(got.rows, want.rows, sql)
    _assert_same(got.rows, host.rows, sql)
    return got, stats, jstats


# -- the segment ------------------------------------------------------------

def test_dict_ids_equal_jax():
    """Arrival-ordered dictIds, values and the MV flat ids are the JAX
    package's, row for row."""
    jseg = JMutable(j_usertable.user_schema(), "ue")
    tseg = MutableSegment(usertable.user_schema(), "ue")
    frame = usertable.generate_frame(0, 1, 3000, 11)
    for r in usertable.frame_rows(frame):
        jseg.index(dict(r))
        tseg.index(dict(r))
    assert jseg.num_docs == tseg.num_docs == 3000
    for c in usertable.user_schema().column_names:
        jd, td = jseg.data_source(c), tseg.data_source(c)
        assert jd.dictionary.get_values(range(len(jd.dictionary))) == \
            td.dictionary.get_values(range(len(td.dictionary))), c
        if td.metadata.single_value:
            np.testing.assert_array_equal(np.asarray(jd.forward_index),
                                          td.forward_index, err_msg=c)
        else:
            np.testing.assert_array_equal(np.asarray(jd.forward_index),
                                          td._col.fwd.view(), err_msg=c)
            np.testing.assert_array_equal(np.asarray(jd.mv_offsets),
                                          td._col.mv_offsets.view(),
                                          err_msg=c)
            dense, counts = td.dense_mv()
            off = np.asarray(jd.mv_offsets)
            np.testing.assert_array_equal(counts, np.diff(off))
            flat = np.asarray(jd.forward_index)
            for i in (0, 1, 2999):
                np.testing.assert_array_equal(
                    dense[i, :counts[i]], flat[off[i]:off[i + 1]])
        jm, tm = jd.metadata, td.metadata
        assert (tm.cardinality, tm.min_value, tm.max_value, tm.has_nulls,
                tm.max_num_multi_values) == (
            jm.cardinality, jm.min_value, jm.max_value, jm.has_nulls,
            jm.max_num_multi_values), c


def test_nulls_and_capacity_match_jax():
    """Null rows (None, NaN, an empty MV list, a declared null) store the
    default and set the bitmap from the first null on; a full segment
    refuses the next row."""
    D, F, T = tdata.DataType, tdata.FieldSpec, tdata.FieldType
    JD, JF, JT = jdata.DataType, jdata.FieldSpec, jdata.FieldType
    tseg = MutableSegment(tdata.Schema("n", [
        F("s", D.STRING), F("v", D.DOUBLE, T.METRIC),
        F("m", D.INT, single_value=False)]), "n", capacity=5)
    jseg = JMutable(jdata.Schema("n", [
        JF("s", JD.STRING), JF("v", JD.DOUBLE, JT.METRIC),
        JF("m", JD.INT, single_value=False)]), "n", capacity=5)
    rows = [{"s": "a", "v": 1.5, "m": [1, 2]},
            {"s": None, "v": float("nan"), "m": []},
            {"s": "b", "v": 2.0, "m": 3, "__nulls__": ["s"]},
            {"s": "c", "v": None, "m": None},
            {"s": "a", "v": 4.0, "m": [5, 5, 6]},
            {"s": "z", "v": 9.0, "m": [9]}]
    got = [tseg.index(dict(r)) for r in rows]
    assert got == [jseg.index(dict(r)) for r in rows] == [True] * 5 + [False]
    for c in ("s", "v", "m"):
        jd, td = jseg.data_source(c), tseg.data_source(c)
        np.testing.assert_array_equal(np.asarray(jd.null_bitmap),
                                      td.null_bitmap)
        assert [jseg.get_value(c, i) for i in range(5)] == \
            read_values(tseg, c, np.arange(5))


def test_mutable_dictionary_ranges():
    """No dictId interval (TypeError, as JAX); the range's ids by a scan
    of the values, equal to JAX's, numeric and string."""
    pair = _pair("rt_dict")
    _index(pair, _rows_of(500, 4))
    for col, lo, hi, li, hi_inc in (("clicks", 10, 60, True, False),
                                    ("price", None, 99.5, True, True),
                                    ("city", "la", "sf", False, True)):
        jd = pair[0].data_source(col).dictionary
        td = pair[1].data_source(col).dictionary
        with pytest.raises(TypeError):
            td.range_to_dict_id_interval(lo, hi, li, hi_inc)
        np.testing.assert_array_equal(
            td.matching_range_ids(lo, hi, li, hi_inc),
            jd.matching_range_ids(lo, hi, li, hi_inc))


def test_planner_refuses_the_segment_itself():
    """A consuming segment plans only through its watermark view: the
    planner refuses it with JAX's code (``mutable_segment``)."""
    pair = _pair("rt_plan")
    _index(pair, _rows_of(50, 2))
    sql = "SELECT count(*) FROM rt WHERE clicks > 3"
    with pytest.raises(JPlanError):
        j_plan(j_compile(sql), pair[0])
    with pytest.raises(PlanError) as e:
        t_plan(t_compile(sql), pair[1])
    assert e.value.reason_code == "mutable_segment"


# -- the consuming rung --------------------------------------------------------

def test_parity_at_every_watermark(executors):
    """tests/test_realtime_tier.py:84: at 7 rows (below the chunk floor),
    107 (the same chunk) and 1607 (a regrowth), every query equals the
    JAX rung and host engine, the group-bys on ``mutable_device`` in both
    packages, with the same decisions."""
    pair = _pair("rt__0__0__x")
    n = 0
    rng_rows = _rows_of(1607, 0)
    for step in (7, 100, 1500):
        _index(pair, rng_rows[n:n + step])
        n += step
        for sql in QUERIES:
            got, stats, jstats = _three(executors, sql, [pair[0]], [pair[1]])
            assert stats.group_by_rung == jstats.group_by_rung, (sql, n)
            if "GROUP BY" in sql:
                assert stats.group_by_rung == "mutable_device", (sql, n)
            assert stats.decisions == dict(jstats.decisions), (sql, n)
            assert stats.num_docs_scanned == jstats.num_docs_scanned
            assert stats.total_docs == jstats.total_docs == n
            # the chunk scan or the index gather, once
            assert stats.general_launches + stats.index_launches == 1
            assert stats.index_launches == int(MUT_SERVED in
                                               stats.decisions)
            assert not stats.scan_launches


def test_no_metadata_answer_on_a_consuming_segment(executors):
    """A filter-less COUNT / MIN / MAX scans (JAX :808-812): the live
    dictionary's min/max may hold a value whose row is not published."""
    pair = _pair("rt_meta")
    _index(pair, _rows_of(300, 5))
    got, stats, jstats = _three(
        executors, "SELECT count(*), min(clicks), max(price) FROM rt",
        [pair[0]], [pair[1]])
    assert stats.num_docs_scanned == jstats.num_docs_scanned == 300
    assert stats.general_launches == 1


def test_watermark_snapshot_is_stable_under_writes():
    """tests/test_realtime_tier.py:109: 30 counts under a writer never go
    backwards; quiesced, the count is ``num_docs``."""
    seg = MutableSegment(_schema(tdata), "rt__0__1__x", capacity=65536)
    ex = ServerQueryExecutor(device="cpu")
    q = t_compile("SELECT count(*) FROM rt")
    rows = _rows_of(20_000, 1)
    stop = threading.Event()

    def writer():
        for r in rows:
            if stop.is_set():
                break
            seg.index(dict(r))

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    counts = []
    try:
        for _ in range(30):
            counts.append(ex.execute(q, [seg])[0].rows[0][0])
    finally:
        stop.set()
        t.join(timeout=30)
    assert all(b >= a for a, b in zip(counts, counts[1:])), counts
    assert ex.execute(q, [seg])[0].rows[0][0] == seg.num_docs


def test_hll_declines_onto_the_host_engine(executors):
    """tests/test_realtime_tier.py:143: HLL is declined with
    ``mutable_hll_lut_unstable`` and the host engine serves it, in both
    packages."""
    pair = _pair("rt__0__2__x", capacity=4096)
    _index(pair, _rows_of(50, 2))
    sql = ("SELECT city, distinctcounthll(clicks) FROM rt GROUP BY city "
           "LIMIT 100")
    got, stats, jstats = _three(executors, sql, [pair[0]], [pair[1]])
    assert stats.group_by_rung == jstats.group_by_rung == "host"
    assert stats.decisions == {HLL_DECLINED: 1}
    assert dict(jstats.decisions) == stats.decisions
    assert stats.general_launches == 0


def test_empty_watermark_declines(executors):
    pair = _pair("rt_empty")
    got, stats, jstats = _three(executors, "SELECT count(*) FROM rt",
                                [pair[0]], [pair[1]])
    assert got.rows == [[0]]
    assert stats.decisions == dict(jstats.decisions) == {
        "mutable:mutable_device->host_engine:mutable_empty_watermark": 1}


def test_host_engine_reads_a_consuming_segment(executors):
    """Selection (the top-k refuses a consuming segment, JAX :123),
    DISTINCT and a RANGE on the host engine: equal to JAX's host engine,
    with the refusal recorded."""
    pair = _pair("rt_host")
    _index(pair, _rows_of(800, 9))
    for sql in ("SELECT city, clicks, ts FROM rt WHERE clicks BETWEEN 10 "
                "AND 30 ORDER BY clicks DESC, ts LIMIT 7",
                "SELECT DISTINCT city FROM rt WHERE price < 50.0 "
                "ORDER BY city LIMIT 10",
                "SELECT city, ts FROM rt WHERE city IN ('sf') LIMIT 5"):
        got, stats = executors["port"].execute(t_compile(sql), [pair[1]])
        host, _ = executors["host"].execute(j_compile(sql), [pair[0]])
        assert got.rows == host.rows, sql
        assert stats.topk_launches == 0 and stats.general_launches == 0
        if "ORDER BY clicks" in sql:
            assert stats.decisions == {
                "selection:device_topk->host_engine:"
                "selection_not_device_eligible": 1}


# -- the consuming segment's index gather (tests/test_index_rung.py) ----------

def _events_pair():
    """tests/test_index_rung.py:375 ``_mutable_segment`` in both packages."""
    def schema(pkg):
        D, F, T = pkg.DataType, pkg.FieldSpec, pkg.FieldType
        return pkg.Schema("events", [
            F("user", D.INT, T.DIMENSION),
            F("kind", D.STRING, T.DIMENSION),
            F("tags", D.STRING, T.DIMENSION, single_value=False),
            F("value", D.INT, T.METRIC)])

    rng = np.random.default_rng(11)
    jseg = JMutable(schema(jdata), "events__0")
    tseg = MutableSegment(schema(tdata), "events__0")
    users = rng.zipf(1.4, 12_000).clip(1, 400).astype(np.int64)
    kinds = rng.choice(["a", "b", "c"], 12_000)
    vals = rng.integers(1, 50, 12_000)
    for i in range(12_000):
        row = {"user": int(users[i]), "kind": str(kinds[i]),
               "tags": [f"t{int(users[i]) % 5}"], "value": int(vals[i])}
        jseg.index(dict(row))
        tseg.index(dict(row))
    return jseg, tseg, users


@pytest.fixture(scope="module")
def events():
    return _events_pair()


def test_mutable_index_gather_parity(executors, events):
    """tests/test_index_rung.py:373: a tail user's point filter on the
    growing postings, ``mutable_index_served``, rung ``mutable_device``,
    the docs scanned the user's rows; rows appended after the postings
    were built are gathered too."""
    jseg, tseg, users = events
    uniq, cnt = np.unique(users, return_counts=True)
    u = int(next(u for u, c in zip(uniq.tolist(), cnt.tolist())
                 if 5 <= c <= 60))
    c = int(cnt[uniq == u][0])
    sql = (f"SELECT kind, count(*), sum(value) FROM events WHERE user = {u} "
           "GROUP BY kind")
    got, stats, jstats = _three(executors, sql, [jseg], [tseg])
    assert stats.group_by_rung == jstats.group_by_rung == "mutable_device"
    assert stats.num_docs_scanned == jstats.num_docs_scanned == c
    assert stats.decisions.get(MUT_SERVED) == 1
    assert stats.decisions == dict(jstats.decisions)
    assert stats.index_launches == 1 and stats.general_launches == 0
    for _ in range(40):
        row = {"user": u, "kind": "a", "tags": ["t0"], "value": 1}
        jseg.index(dict(row))
        tseg.index(dict(row))
    got, stats, jstats = _three(executors, sql, [jseg], [tseg])
    assert stats.num_docs_scanned == jstats.num_docs_scanned == c + 40


@pytest.mark.parametrize("sql,reason", [
    ("SELECT kind, count(*) FROM events WHERE tags = 't1' GROUP BY kind",
     "mutable_index_unsupported_shape"),
    ("SELECT count(*) FROM events WHERE user = 3 OR kind = 'a'",
     "mutable_index_unsupported_shape"),
    ("SELECT count(*), sum(value) FROM events WHERE kind = 'b'",
     "mutable_index_over_threshold"),
    ("SELECT count(*) FROM events WHERE user BETWEEN 1 AND 399",
     "mutable_index_over_threshold"),
])
def test_mutable_index_declines_to_the_chunk_scan(executors, events, sql,
                                                  reason):
    """tests/test_index_rung.py:402 and the other declines: the chunk scan
    serves, the decline recorded as JAX records it."""
    jseg, tseg, _ = events
    got, stats, jstats = _three(executors, sql, [jseg], [tseg])
    assert stats.decisions.get(MUT_DECLINED.format(reason)) == 1
    assert stats.decisions == dict(jstats.decisions)
    assert stats.general_launches == 1 and stats.index_launches == 0


def test_mutable_index_opt_out_is_silent(executors, events):
    jseg, tseg, _ = events
    sql = ("SELECT count(*) FROM events WHERE user = 7 "
           "OPTION(useIndexRung=false)")
    got, stats, jstats = _three(executors, sql, [jseg], [tseg])
    assert not stats.decisions and not dict(jstats.decisions)


# -- staging -----------------------------------------------------------------

def test_delta_uploads_and_device_regrowth():
    """Only the rows past the staged watermark and the new dictionary
    values cross to the device; a capacity regrowth copies the history on
    the device; an earlier snapshot's tensors keep their rows."""
    seg = MutableSegment(_schema(tdata), "rt_delta")
    staged = mutable_staging.StagedMutableSegment(seg, device="cpu")
    rows = _rows_of(3000, 3)
    for r in rows[:600]:
        seg.index(dict(r))
    s1 = staged.snapshot()
    assert (s1.wm, s1.capacity) == (600, 1024)
    first = {k: v.clone() for k, v in s1.tree("clicks").items()}
    cards = {c: len(seg._cols[c].dictionary) for c in ("clicks", "price",
                                                       "ts")}
    before = staged.h2d_bytes
    for r in rows[600:2500]:
        seg.index(dict(r))
    s2 = staged.snapshot()
    assert (s2.wm, s2.capacity) == (2500, 4096)
    new_vals = sum(len(seg._cols[c].dictionary) - cards[c] for c in cards)
    # city, clicks, price, ts: int32 dictIds; LONG values 8 B, DOUBLE 4 B
    clicks_ts = (len(seg._cols["clicks"].dictionary) - cards["clicks"]
                 + len(seg._cols["ts"].dictionary) - cards["ts"])
    price = len(seg._cols["price"].dictionary) - cards["price"]
    assert new_vals == clicks_ts + price
    assert staged.h2d_bytes - before == 1900 * 4 * 4 + clicks_ts * 8 \
        + price * 4
    for k, v in first.items():
        torch.testing.assert_close(s1.tree("clicks")[k], v)
    fwd = s2.tree("city")["fwd"]
    np.testing.assert_array_equal(fwd[:2500].numpy(),
                                  seg._cols["city"].fwd.view(2500))
    assert not fwd[2500:].any()
    # nothing new: nothing uploaded
    mid = staged.h2d_bytes
    staged.snapshot()
    assert staged.h2d_bytes == mid


def test_refresh_copies_only_under_a_live_snapshot():
    """A refresh at one capacity writes into the staged tensors in place
    when no query holds them, and copies a tensor that a live snapshot
    holds first: that snapshot keeps its watermark's rows, and its copy
    counts in ``nbytes`` until it is dropped."""
    seg = MutableSegment(_schema(tdata), "rt_cow")
    staged = mutable_staging.StagedMutableSegment(seg, device="cpu")
    rows = _rows_of(900, 5)
    for r in rows[:300]:
        seg.index(dict(r))
    s1 = staged.snapshot()
    fwd1 = s1.tree("city")["fwd"]
    before = fwd1.clone()
    alone = staged.nbytes()
    for r in rows[300:600]:
        seg.index(dict(r))
    s2 = staged.snapshot()
    assert (s1.capacity, s2.capacity) == (1024, 1024)
    fwd2 = s2.tree("city")["fwd"]
    assert fwd2.data_ptr() != fwd1.data_ptr() and staged.copied_bytes > 0
    torch.testing.assert_close(fwd1, before)
    assert not fwd1[300:].any()
    np.testing.assert_array_equal(fwd2[:600].numpy(),
                                  seg._cols["city"].fwd.view(600))
    assert staged.nbytes() > alone
    del s1, fwd1
    assert staged.nbytes() == alone
    copied = staged.copied_bytes
    ptr = fwd2.data_ptr()
    del s2, fwd2
    for r in rows[600:]:
        seg.index(dict(r))
    s3 = staged.snapshot()
    assert staged.copied_bytes == copied
    assert s3.tree("city")["fwd"].data_ptr() == ptr
    np.testing.assert_array_equal(s3.tree("city")["fwd"][:900].numpy(),
                                  seg._cols["city"].fwd.view(900))


def test_residency_registers_and_restages(executors):
    """The resident ``mutable::<segment>`` is pinned by the query's lease
    and measured; eviction releases it and the next query stages it again
    from the host columns; prefetch skips a consuming segment."""
    pair = _pair("rt_res")
    _index(pair, _rows_of(900, 6))
    ex = ServerQueryExecutor(device="cpu")
    sql = "SELECT city, sum(clicks) FROM rt GROUP BY city"
    got, stats = ex.execute(t_compile(sql), [pair[1]])
    name = mutable_staging.resident_name("rt_res")
    assert name in ex.residency.resident_names()
    assert ex.residency.resident_nbytes(name) > 0
    assert stats.staging["misses"] == 1
    first = ex.residency._entries[name].resident
    ex.residency.evict(name)
    assert first.nbytes() == 0
    again, stats = ex.execute(t_compile(sql), [pair[1]])
    assert again.rows == got.rows and stats.staging["misses"] == 1
    second = ex.residency._entries[name].resident
    assert second is not first and second.h2d_bytes == first.h2d_bytes
    ex.residency.prefetch(pair[1])
    ex.residency.drain_prefetch()
    assert ex.residency.resident_names() == [name]


def test_failed_staging_or_launch_raises(monkeypatch):
    """No host fallback on a failure (the JAX ``mutable_exec_failed`` is
    not copied): a staging or a launch that raises fails the query."""
    seg = MutableSegment(_schema(tdata), "rt_fail")
    for r in _rows_of(100, 7):
        seg.index(dict(r))
    sql = t_compile("SELECT city, count(*) FROM rt GROUP BY city")

    def broken(*a, **k):
        raise RuntimeError("injected device failure")

    with monkeypatch.context() as m:
        m.setattr(mutable_staging.StagedMutableSegment, "snapshot", broken)
        with pytest.raises(RuntimeError, match="injected"):
            ServerQueryExecutor(device="cpu").execute(sql, [seg])
    ex = ServerQueryExecutor(device="cpu")
    with monkeypatch.context() as m:
        m.setattr(kernels.KernelCache, "get", lambda self, spec: broken)
        with pytest.raises(RuntimeError, match="injected"):
            ex.execute(sql, [seg])
    with monkeypatch.context() as m:
        m.setattr(mutable_staging.index_exec, "index_gather", broken)
        with pytest.raises(RuntimeError, match="injected"):
            ex.execute(t_compile("SELECT count(*) FROM rt "
                                 "WHERE city = 'sf' AND clicks = 3"), [seg])
    src = open(mutable_staging.__file__).read()
    assert "except Exception" not in src
    assert '"mutable_exec_failed"' not in src
    assert '"mutable_index_exec_failed"' not in src


# -- the batch refuses consuming segments -----------------------------------

def test_batch_refuses_and_sharded_routes_per_segment(executors):
    """A segment batch refuses a consuming segment (JAX
    ``parallel/batch.py:72``); ShardedQueryExecutor serves each on its
    rung with ``segments_not_batchable``, equal to the JAX sharded
    executor."""
    a, b = _pair("rt_b0"), _pair("rt_b1")
    _index(a, _rows_of(400, 12))
    _index(b, _rows_of(500, 13, start=400))
    with pytest.raises(ValueError, match="mutable"):
        SegmentBatch([a[1], b[1]])
    sql = "SELECT city, count(*), sum(clicks) FROM rt GROUP BY city"
    got, stats = ShardedQueryExecutor(device="cpu").execute(
        t_compile(sql), [a[1], b[1]])
    want, jstats = JSharded().execute(j_compile(sql), [a[0], b[0]])
    _assert_same(got.rows, want.rows, sql)
    key = ("sharded_combine:sharded_combine->per_segment:"
           "segments_not_batchable")
    assert stats.decisions.get(key) == 1
    assert stats.decisions == dict(jstats.decisions)
    assert stats.group_by_rung == jstats.group_by_rung == "mutable_device"
    assert stats.general_launches == 2 and stats.batch_general_launches == 0


# -- stream, transformers, consumer, seal ---------------------------------------

def test_stream_config_map_matches_jax():
    m = {"streamType": "kafka", "stream.kafka.topic.name": "events",
         "stream.kafka.decoder.class.name": "org.x.JSONMessageDecoder",
         "realtime.segment.flush.threshold.size": "50000",
         "realtime.segment.flush.threshold.time": "1d12h"}
    j = jtable.StreamIngestionConfig.from_stream_configs_map(m)
    t = ttable.StreamIngestionConfig.from_stream_configs_map(m)
    assert (t.stream_type, t.topic, t.decoder, t.segment_flush_threshold_rows,
            t.segment_flush_threshold_millis, t.properties) == (
        j.stream_type, j.topic, j.decoder, j.segment_flush_threshold_rows,
        j.segment_flush_threshold_millis, j.properties)
    assert ttable.TableConfig("t_REALTIME", "realtime") \
        .table_name_with_type == "t_REALTIME"


@pytest.mark.parametrize("expr", [
    "clicks > 10 AND city IN ('nyc', 'sf')",
    "NOT (price BETWEEN 1 AND 5) OR city = 'la'",
    "city <> 'sea' AND clicks <= 3",
    "REGEXP_LIKE(city, '^s') AND clicks IS NOT NULL",
])
def test_row_filter_matches_jax(expr):
    rows = _rows_of(200, 8) + [{"city": None, "clicks": None, "price": 2.0}]
    jf, tf = j_parse_filter(expr), parse_filter_expression(expr)
    assert [eval_row_filter(tf, r) for r in rows] == \
        [j_row_filter(jf, r) for r in rows]


def _ingest_tables(topic, flush_rows, **kw):
    """(JAX table config, port table config) of one realtime table."""
    ic = kw.get("ingestion")

    def table(pkg, prefix, indexing):
        return pkg.TableConfig(
            "rt", pkg.TableType.REALTIME, indexing_config=indexing,
            stream_config=pkg.StreamIngestionConfig(
                stream_type="memory", topic=prefix + topic,
                segment_flush_threshold_rows=flush_rows),
            ingestion_config=pkg.IngestionConfig(
                filter_function=ic["filter_function"],
                transform_configs=[pkg.TransformConfig(c, f) for c, f
                                   in ic["transform_configs"]])
            if ic else None)

    indexing = kw.get("indexing", (jtable.IndexingConfig(),
                                   ttable.IndexingConfig()))
    return (table(jtable, "j_", indexing[0]),
            table(ttable, "t_", indexing[1]))


def test_transformers_match_jax():
    """The default chain with a derived column (the schema's and the
    table's), a drop filter, type coercion, null defaults, sanitising and
    a nested object, row for row."""
    def schema(pkg):
        D, F, T = pkg.DataType, pkg.FieldSpec, pkg.FieldType
        return pkg.Schema("x", [
            F("name", D.STRING, max_length=4),
            F("n", D.INT, T.METRIC),
            F("twice", D.LONG, T.METRIC, transform_function="times(n, 2)"),
            F("geo.city", D.STRING),
            F("tags", D.STRING, single_value=False),
            F("label", D.STRING)])

    jcfg = jtable.TableConfig("x", ingestion_config=jtable.IngestionConfig(
        filter_function="n > 90", transform_configs=[
            jtable.TransformConfig("label", "upper(name)")]))
    tcfg = ttable.TableConfig("x", ingestion_config=ttable.IngestionConfig(
        filter_function="n > 90", transform_configs=[
            ttable.TransformConfig("label", "upper(name)")]))
    jt = JComposite.for_table(jcfg, schema(jdata))
    tt = CompositeTransformer.for_table(tcfg, schema(tdata))
    rng = np.random.default_rng(5)
    rows = []
    for i in range(300):
        r = {"name": "ab\x00cdefg"[:int(rng.integers(0, 8))],
             "n": [int(rng.integers(0, 100)), None, "7", "x"][i % 4],
             "geo": {"city": CITIES[i % 5]} if i % 3 else None,
             "tags": [["a", None], [], "b", None][i % 4]}
        rows.append(r)
    def outcome(transformer, row):
        try:
            return transformer.transform(json.loads(json.dumps(row)))
        except TypeError as e:   # a string compared with a number
            return type(e)

    got = [outcome(tt, r) for r in rows]
    assert got == [outcome(jt, r) for r in rows]
    assert sum(isinstance(g, dict) for g in got) > 100
    assert sum(g is None for g in got) > 0


def _protocols(reply: str):
    """(JAX protocol, port protocol): HOLD twice, then ``reply``."""
    def make(base, reply_cls, resp):
        class P(base):
            asked = 0

            def segment_consumed(self, segment_name, instance, offset):
                self.asked += 1
                return reply_cls(resp["HOLD" if self.asked <= 2 else reply])
        return P()

    return (make(jrt.LocalCompletionProtocol, jrt.CompletionReply,
                 jrt.CompletionResponse.__members__),
            make(LocalCompletionProtocol, CompletionReply,
                 CompletionResponse.__members__))


def _consumers(topic, messages, flush_rows, tmp_path, protocols=(None, None),
               **kw):
    jcfg, tcfg = _ingest_tables(topic, flush_rows, **kw)
    JStream.create("j_" + topic, 1)
    js = JStream.get("j_" + topic)
    for m in messages:
        js.produce(m, partition=0)
    MemoryStream.create("t_" + topic, 1).produce_many(messages)
    schema = kw.get("schema", (j_usertable.user_schema(),
                               usertable.user_schema()))
    jm = jrt.RealtimeSegmentDataManager(
        f"{topic}__0__0", jcfg, schema[0], 0, JOffset(0),
        protocol=protocols[0], output_dir=str(tmp_path))
    tm = RealtimeSegmentDataManager(f"{topic}__0__0", tcfg, schema[1], 0,
                                    StreamOffset(0), protocol=protocols[1])
    return jm, tm


def _same_result(jr, tr):
    assert (tr.state.value, tr.rows_indexed, tr.rows_dropped,
            tr.final_offset.value) == (
        jr.state.value, jr.rows_indexed, jr.rows_dropped,
        jr.final_offset.value)


@pytest.fixture(scope="module")
def sealed(tmp_path_factory):
    """usertable's rows as JSON messages, consumed and committed at 5000
    rows by both packages (JAX seals to disk; the segment is loaded)."""
    frame = usertable.generate_frame(0, 1, 6000, 7)
    messages = usertable.frame_messages(frame)
    jm, tm = _consumers("ue_seal", messages, 5000,
                        tmp_path_factory.mktemp("rt_seal"),
                        indexing=(j_usertable.user_indexing_config(),
                                  usertable.user_indexing_config()))
    jr, tr = jm.consume_until_committed(), tm.consume_until_committed()
    return jm, tm, jr, tr, load_segment(jr.segment_dir), frame


def test_consume_until_committed_matches_jax(sealed):
    jm, tm, jr, tr, jseg, _ = sealed
    _same_result(jr, tr)
    assert tr.state is ConsumerState.COMMITTED and tr.rows_indexed == 5000
    assert tr.segment is tm.sealed_segment and tm.seal_wall_ms > 0
    assert tr.metadata is tr.segment.metadata


def test_seal_offsets_in_custom(sealed):
    _, _, jr, tr, jseg, _ = sealed
    assert tr.segment.metadata.custom == jseg.metadata.custom == {
        "segment.realtime.startOffset": "0",
        "segment.realtime.endOffset": "5000",
        "segment.realtime.partition": 0}


def test_sealed_columns_equal_jax(sealed):
    """The port's in-memory seal equals the JAX segment sealed to disk and
    loaded: sorted dictionaries, dictIds, the raw latency_ms, MV rows,
    min/max; the consuming dictIds were equal before (arrival order)."""
    _, tm, _, tr, jseg, frame = sealed
    want, got = columns_of(jseg), columns_of(tr.segment)
    assert list(got) == list(want)
    for c, w in want.items():
        g = got[c]
        for k in ("dictionary", "dict_ids", "values", "mv_counts", "null"):
            a, b = getattr(g, k), getattr(w, k)
            assert (a is None) == (b is None), (c, k)
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{c}.{k}")
        assert (g.min_value, g.max_value) == (w.min_value, w.max_value), c
    md = tr.segment.metadata
    assert not md.columns["latency_ms"].has_dictionary
    assert md.columns["user_id"].has_inverted_index
    assert md.columns["latency_ms"].has_range_index
    np.testing.assert_array_equal(
        got["user_id"].dictionary[got["user_id"].dict_ids],
        frame["user_id"][:5000])


def test_sealed_star_tree_equal_jax(sealed):
    """The default star-tree stamped at the seal, equal to JAX's."""
    _, _, _, tr, jseg, _ = sealed
    want, got = star_trees_of(jseg), star_trees_of(tr.segment)
    assert len(got) == len(want) == 1
    assert got[0]["config"] == want[0]["config"]
    np.testing.assert_array_equal(got[0]["dims"], want[0]["dims"])
    np.testing.assert_array_equal(got[0]["nodes"], want[0]["nodes"])
    assert set(got[0]["metrics"]) == set(want[0]["metrics"])
    for k, v in want[0]["metrics"].items():
        np.testing.assert_array_equal(got[0]["metrics"][k], v)


def test_sealed_answers_equal_the_consuming_ones(sealed):
    """The sealed segment (star-tree, fused scan on the CPU's plain
    version, index rung) answers what the consuming segment answered at
    the final watermark, and JAX's loaded segment."""
    _, tm, _, tr, jseg, frame = sealed
    tail = usertable.tail_users(6000, 1, 7)
    user = tail[len(tail) // 2]
    ex = ServerQueryExecutor(device="cpu")
    jex = JExecutor(use_device=True)
    wants = usertable.realtime_answers(usertable.frame_prefix(frame, 5000),
                                       user)
    for qid, sql in usertable.realtime_queries(user).items():
        cons, _ = ex.execute(t_compile(sql), [tm.segment])
        usertable.check_rows(qid, cons.rows, wants[qid])
        for opt in ("", " OPTION(useStarTree=false)"):
            got, stats = ex.execute(t_compile(sql + opt), [tr.segment])
            usertable.check_rows(qid, got.rows, wants[qid])
            want, jstats = jex.execute(j_compile(sql + opt), [jseg])
            _assert_same(got.rows, want.rows, sql + opt)
            if qid in ("R1", "R2") and not opt:
                assert stats.group_by_rung == "startree_device"


def test_consumer_filter_transform_and_drops(tmp_path):
    """A table filter drops rows (counted), a transform config derives a
    column, bad messages drop: rows, offsets and dictIds as JAX's."""
    def schema(pkg):
        D, F, T = pkg.DataType, pkg.FieldSpec, pkg.FieldType
        return pkg.Schema("rt", [
            F("city", D.STRING), F("clicks", D.LONG, T.METRIC),
            F("loud", D.STRING)])

    rows = _rows_of(700, 10)
    messages = [json.dumps(r) for r in rows] + ["not json", "[1, 2]"]
    ingestion = {"filter_function": "clicks < 20",
                 "transform_configs": [("loud", "upper(city)")]}
    jm, tm = _consumers("rt_filter", messages, 10_000, tmp_path,
                        schema=(schema(jdata), schema(tdata)),
                        ingestion=ingestion)
    for _ in range(3):
        jm.run_once()
        tm.run_once()
    assert (tm.rows_indexed, tm.rows_dropped, tm.current_offset.value) == (
        jm.rows_indexed, jm.rows_dropped, jm.current_offset.value)
    assert tm.rows_dropped > 2
    for c in ("city", "clicks", "loud"):
        np.testing.assert_array_equal(
            tm.segment.data_source(c).forward_index,
            np.asarray(jm.segment.data_source(c).forward_index))
    assert tm.segment.data_source("loud").dictionary.get_values(
        range(3)) == jm.segment.data_source("loud").dictionary.get_values(
        range(3))


@pytest.mark.parametrize("reply", ["COMMIT", "KEEP", "DISCARD"])
def test_completion_replies_match_jax(tmp_path, reply):
    """HOLD twice, then COMMIT / KEEP / DISCARD: the same states, rows and
    offsets as JAX's consumer; only a COMMIT seals."""
    frame = usertable.generate_frame(1, 2, 2500, 3)
    messages = usertable.frame_messages(frame)
    jm, tm = _consumers(f"rt_reply_{reply}", messages, 1200, tmp_path,
                        protocols=_protocols(reply))
    jr, tr = jm.consume_until_committed(), tm.consume_until_committed()
    _same_result(jr, tr)
    assert (tr.segment is not None) == (reply == "COMMIT")
    assert tm.protocol.asked == jm.protocol.asked == 3


def test_chip_smoke_phase_14_small():
    """chip_smoke.py's phase 14 (its oracle, rungs, delta bytes, the
    writer's counts, upsert, the seal) at 8000 + 2000 rows on the CPU."""
    import chip_smoke

    run = chip_smoke.phase_realtime(seed=3, reps=1, rows=8000, device="cpu")
    assert [s["watermark"] for s in run["steps"]] == [700, 1000, 5000, 8000]
    assert [s["capacity"] for s in run["steps"]] == [1024, 1024, 8192, 8192]
    assert len(run["h2d"]) == 3 and all(h["bytes"] > 0 for h in run["h2d"])
    # the writer may still be consuming at the 30th count; the count
    # after it has committed is every row
    counts = run["writer_counts"]
    assert counts == sorted(counts) and counts[-1] <= 10_000
    assert run["rows"] == run["final_count"] == 10_000
    assert run["refresh"]["copy"]["copied_bytes"] > 0 == \
        run["refresh"]["in_place"]["copied_bytes"]
    assert run["upsert"]["live_users"] > 0
    assert run["custom"]["segment.realtime.endOffset"] == "10000"
    assert set(run["sealed_fused"]) == set(chip_smoke.SEALED_FUSED)
    assert run["launches"] == {"fused_scan": 0, "fused_scan_probe": 0}
    assert os.path.basename(chip_smoke.__file__) == "chip_smoke.py"


def test_reason_codes_are_jax_registered(executors, events):
    """Every code the consuming rung records is in the JAX package's
    ``mutable`` namespace."""
    jseg, tseg, _ = events
    seen = set()
    for sql in ("SELECT count(*) FROM events WHERE user = 7",
                "SELECT count(*) FROM events WHERE kind = 'a'",
                "SELECT count(*) FROM events WHERE tags = 't2'",
                "SELECT kind, distinctcounthll(user) FROM events "
                "GROUP BY kind"):
        _, s = executors["port"].execute(t_compile(sql), [tseg])
        seen |= {k.rsplit(":", 1)[1] for k in s.decisions}
    assert seen <= tracing.MUTABLE_DECLINE_REASONS, seen
    assert {"mutable_index_served", "mutable_index_over_threshold",
            "mutable_index_unsupported_shape",
            "mutable_hll_lut_unstable"} <= seen
