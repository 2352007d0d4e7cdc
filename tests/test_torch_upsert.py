"""Upsert valid-doc filtering in the port against the JAX package.

tests/test_upsert.py's device-path table (3000 rows over 900 keys, one
live doc per key) is built and made upsert-managed by the JAX package; its
valid-doc snapshot is carried across with the columns
(``segment_from_arrays(valid_doc_ids=...)``). The port's general rung ANDs
the snapshot into every filter (the ``validdocs`` leaf, which the fused
scan declines as the JAX Pallas kernel does), leaf by leaf against the JAX
jnp body and end to end against the JAX executors. A bitmap changed
between two queries is seen by the second; a segment batch refuses upsert
segments and the sharded executor serves them per segment. Consuming
upsert segments (tests/test_upsert.py:201-276), and a realtime table's
upsert config consumed and sealed by the port's consumer beside the JAX
server's wiring, are held to the JAX package too.

Tolerance: every cell exact (counts and integer sums and maxima).
"""

import json

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pinot_tpu.engine import ServerQueryExecutor as JaxExecutor  # noqa: E402
from pinot_tpu.engine import kernels as jk  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.engine.staging import StagedSegment as JStaged  # noqa: E402
from pinot_tpu.ingestion import MemoryStream as JStream  # noqa: E402
from pinot_tpu.ingestion import realtime as jrt  # noqa: E402
from pinot_tpu.ingestion.stream import StreamOffset as JOffset  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment.mutable import MutableSegment as JMutable  # noqa: E402
from pinot_tpu.segment.upsert import (  # noqa: E402
    PartitionUpsertMetadataManager,
    attach_valid_docs,
)
from pinot_tpu.segment.upsert import (  # noqa: E402
    TableUpsertMetadataManager as JTableUpsert,
)
from pinot_tpu.server.data_manager import (  # noqa: E402
    RealtimeTableDataManager as JRealtimeTDM,
)
from pinot_tpu.server.data_manager import (  # noqa: E402
    _LiveValidDocs as JLiveValidDocs,
)
from pinot_tpu.spi import table as jtable  # noqa: E402
from pinot_tpu_torch.engine import mutable_staging  # noqa: E402
from pinot_tpu_torch.engine import kernels as tk  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.engine.staging import StagedSegment  # noqa: E402
from pinot_tpu_torch.ingestion import (  # noqa: E402
    MemoryStream,
    RealtimeSegmentDataManager,
    StreamOffset,
)
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel.batch import SegmentBatch  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import (  # noqa: E402
    columns_of,
    segment_from_arrays,
)
from pinot_tpu_torch.segment import upsert as tup  # noqa: E402
from pinot_tpu_torch.segment.mutable import MutableSegment  # noqa: E402
from pinot_tpu_torch.spi import data as tdata  # noqa: E402
from pinot_tpu_torch.spi import table as ttable  # noqa: E402

from tests.test_torch_kernels import _assert_tree_equal  # noqa: E402
from tests.test_upsert import build_seg, make_schema  # noqa: E402

QUERIES = ["SELECT count(*) FROM users",
           "SELECT sum(score) FROM users WHERE status = 'a'",
           "SELECT status, count(*), max(score) FROM users "
           "GROUP BY status ORDER BY status"]

CPU = torch.device("cpu")


def carry_upsert(jseg):
    n = jseg.num_docs
    return segment_from_arrays(jseg.segment_name, n, columns_of(jseg),
                               table_name="users",
                               valid_doc_ids=np.asarray(
                                   jseg.valid_doc_ids[:n]))


@pytest.fixture(scope="module")
def upsert(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_upsert")
    rng = np.random.default_rng(13)
    n = 3000
    rows = [{"uid": f"u{i % 900}", "status": ["a", "b"][i % 2],
             "score": int(rng.integers(0, 100)), "ts": i} for i in range(n)]
    jseg = build_seg(out, "up_0", rows)
    attach_valid_docs(jseg, PartitionUpsertMetadataManager(
        ["uid"], "ts").add_segment(jseg))
    return jseg, carry_upsert(jseg)


def test_snapshot_carries_across(upsert):
    jseg, tseg = upsert
    assert tseg.valid_doc_ids.dtype == bool
    np.testing.assert_array_equal(tseg.valid_doc_ids,
                                  np.asarray(jseg.valid_doc_ids[:3000]))
    assert int(tseg.valid_doc_ids.sum()) == 900


@pytest.mark.parametrize("sql", QUERIES)
def test_validdocs_leaf_equals_jax_body(upsert, sql):
    """The planner puts the placeholder first and ANDs ``validdocs`` into
    the filter in both packages; filled with each staged snapshot, the
    bodies agree leaf by leaf."""
    jseg, tseg = upsert
    jp, tp = j_plan(j_compile(sql), jseg), t_plan(t_compile(sql), tseg)
    assert tp.spec == jp.spec
    assert tp.spec[0][1][0] == ("validdocs",)
    assert tp.params[0] is None and jp.params[0] is None
    jst = JStaged(jseg)
    jbody = jk.build_kernel_body(jp.spec, sparse_k=jk.sparse_mode(jp.spec))
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jbody)(
        {c: jst.column(c).tree() for c in jp.columns},
        (jst.valid_mask(),) + tuple(jp.params[1:]),
        np.int32(jseg.num_docs), jnp.int32(0)))
    tst = StagedSegment(tseg, device="cpu")
    params = tk.device_params(tp, CPU)
    assert params[0] is None
    tbody = tk.build_kernel_body(tp.spec, sparse_k=tk.sparse_mode(tp.spec))
    out = tbody({c: tst.column(c).tree() for c in tp.columns},
                (tst.valid_mask(),) + params[1:], tseg.num_docs, 0, CPU)
    got = {k: (tuple(x.numpy() for x in v) if isinstance(v, tuple)
               else v.numpy()) for k, v in out.items()}
    _assert_tree_equal(got, want, tp.spec, sql)


@pytest.mark.parametrize("sql", QUERIES)
def test_rows_match_jax_and_see_only_live_docs(upsert, sql):
    jseg, tseg = upsert
    want, jstats = JaxExecutor(use_device=True, use_pallas=True).execute(
        j_compile(sql), [jseg])
    host, _ = JaxExecutor(use_device=False).execute(j_compile(sql), [jseg])
    assert want.rows == host.rows
    for fused in (True, False):
        got, stats = ServerQueryExecutor(
            device="cpu", use_fused_scan=fused).execute(t_compile(sql),
                                                        [tseg])
        assert got.rows == want.rows, (fused, sql)
        assert stats.general_launches == 1 and stats.scan_launches == 0
        assert stats.num_docs_scanned == jstats.num_docs_scanned
        if fused:
            # the fused scan declines the validdocs leaf as the JAX Pallas
            # kernel does, and a filtered query's index rung declines the
            # upsert segment
            assert stats.decisions == jstats.decisions
            assert "pallas:pallas_kernel->jnp_kernel:pallas_validdocs" in \
                stats.decisions
    t, _ = ServerQueryExecutor(device="cpu").execute(
        t_compile("SELECT count(*) FROM users"), [tseg])
    assert t.rows[0][0] == 900


def test_snapshot_tracks_new_invalidation(upsert):
    """A doc invalidated between two queries is gone from the second: the
    snapshot is taken per query, the plan is cached."""
    _, tseg = upsert
    seg = segment_from_arrays("up_copy", tseg.num_docs, columns_of(tseg),
                              table_name="users",
                              valid_doc_ids=tseg.valid_doc_ids.copy())
    ex = ServerQueryExecutor(device="cpu")
    q = t_compile("SELECT count(*) FROM users")
    assert ex.execute(q, [seg])[0].rows[0][0] == 900
    seg.valid_doc_ids[np.nonzero(seg.valid_doc_ids)[0][:5]] = False
    assert ex.execute(q, [seg])[0].rows[0][0] == 895
    # a bitmap attached after a plan was cached gets a plan with the leaf
    plain = segment_from_arrays("up_plain", tseg.num_docs, columns_of(tseg),
                                table_name="users")
    assert ex.execute(q, [plain])[0].rows[0][0] == 3000
    plain.valid_doc_ids = tseg.valid_doc_ids.copy()
    assert ex.execute(q, [plain])[0].rows[0][0] == 900


def test_batch_refuses_upsert_segments(upsert):
    _, tseg = upsert
    other = carry_upsert(upsert[0])
    with pytest.raises(ValueError, match="upsert"):
        SegmentBatch([tseg, other])
    ex = ShardedQueryExecutor(device="cpu")
    table, stats = ex.execute(t_compile(QUERIES[2]), [tseg, other])
    assert stats.decisions == {
        "sharded_combine:sharded_combine->per_segment:"
        "segments_not_batchable": 1,
        "pallas:pallas_kernel->jnp_kernel:pallas_validdocs": 2}
    assert stats.sharded_scan_launches == 0 and stats.general_launches == 2
    single, _ = ServerQueryExecutor(device="cpu").execute(
        t_compile(QUERIES[2]), [tseg])
    assert table.rows == [[s, 2 * c, m] for s, c, m in single.rows]


# -- consuming upsert segments (tests/test_upsert.py:201-276) ------------------

def _t_schema():
    D, F, T = tdata.DataType, tdata.FieldSpec, tdata.FieldType
    return tdata.Schema("users", [F("uid", D.STRING), F("status", D.STRING),
                                  F("score", D.LONG, T.METRIC),
                                  F("ts", D.LONG, T.DATE_TIME)])


class _Consuming:
    """One consuming upsert segment in each package, fed the same rows."""

    def __init__(self, name):
        self.jseg = JMutable(make_schema(), name, capacity=65536)
        self.tseg = MutableSegment(_t_schema(), name, capacity=65536)
        self.jpm = PartitionUpsertMetadataManager(["uid"], "ts")
        self.tpm = tup.PartitionUpsertMetadataManager(["uid"], "ts")
        attach_valid_docs(self.jseg, JLiveValidDocs(self.jpm, name))
        tup.attach_valid_docs(self.tseg, tup._LiveValidDocs(self.tpm, name))

    def index(self, row):
        for seg, pm in ((self.jseg, self.jpm), (self.tseg, self.tpm)):
            seg.index(dict(row))
            pm.add_record(seg.segment_name, seg.num_docs - 1,
                          pm.key_of_row(row), row["ts"])

    def run(self, sql):
        """(port rows and stats, JAX rung rows and stats, JAX host rows)."""
        got, stats = ServerQueryExecutor(device="cpu").execute(
            t_compile(sql), [self.tseg])
        want, jstats = JaxExecutor(use_device=True).execute(j_compile(sql),
                                                            [self.jseg])
        host, _ = JaxExecutor(use_device=False).execute(j_compile(sql),
                                                        [self.jseg])
        return got, stats, want, jstats, host


def _consuming(n_rows, n_keys, seed=7, name="mut_up_0"):
    c = _Consuming(name)
    rng = np.random.default_rng(seed)
    latest = {}
    for i in range(n_rows):
        row = {"uid": f"u{int(rng.integers(0, n_keys))}",
               "status": ["a", "b"][int(rng.integers(0, 2))],
               "score": int(rng.integers(0, 100)), "ts": i}
        c.index(row)
        latest[row["uid"]] = row
    return c, latest


CONSUMING_SQL = ["SELECT status, count(*), sum(score), max(score) FROM users "
                 "GROUP BY status",
                 "SELECT uid, max(ts) FROM users WHERE status = 'a' "
                 "GROUP BY uid LIMIT 500",
                 "SELECT count(*), sum(score) FROM users",
                 "SELECT count(*) FROM users WHERE uid = 'u7'"]


@pytest.mark.parametrize("sql", CONSUMING_SQL)
def test_consuming_upsert_matches_jax(sql):
    """Writes quiesced: the port's consuming rung equals JAX's rung and
    host engine, on the device rung in both (group-bys on
    ``mutable_device``); the index gather declines the upsert segment."""
    c, latest = _consuming(2000, 300)
    got, stats, want, jstats, host = c.run(sql)
    assert sorted(map(repr, got.rows)) == sorted(map(repr, want.rows)) \
        == sorted(map(repr, host.rows))
    assert stats.group_by_rung == jstats.group_by_rung
    if "GROUP BY" in sql:
        assert stats.group_by_rung == "mutable_device"
    assert stats.decisions == dict(jstats.decisions)
    if "WHERE" in sql:
        assert stats.decisions == {
            "index:index_gather->mutable_device:"
            "mutable_index_unsupported_shape": 1}
    assert stats.general_launches == 1 and stats.index_launches == 0
    if sql == CONSUMING_SQL[2]:
        assert got.rows[0][0] == len(latest)


def test_consuming_invalidation_between_queries():
    """tests/test_upsert.py:248: a newer row for a key flips its old doc;
    the version-keyed device mask is taken again (the count stays 50)."""
    c = _Consuming("mut_up_1")
    for i in range(50):
        c.index({"uid": f"u{i}", "status": "a", "score": i, "ts": i})
    q = "SELECT count(*), sum(score) FROM users"
    got, *_ = c.run(q)
    assert got.rows[0][0] == 50
    c.index({"uid": "u5", "status": "a", "score": 1, "ts": 10_000})
    got, _, want, _, host = c.run(q)
    assert got.rows == want.rows == host.rows
    assert got.rows[0] == [50, float(sum(range(50)) - 5 + 1)]


def test_consuming_invalidation_at_an_unchanged_watermark():
    """A newer record of a key lands in another segment: the consuming
    segment's doc goes invalid with no new row. The snapshot's mask cache
    is keyed on the bitmap's version, so the next query sees it at the
    same watermark, as JAX's."""
    c, latest = _consuming(600, 80, name="mut_up_2")
    ex = ServerQueryExecutor(device="cpu")
    q = t_compile("SELECT status, count(*) FROM users GROUP BY status")
    before, _ = ex.execute(q, [c.tseg])
    resident = ex.residency._entries[
        mutable_staging.resident_name("mut_up_2")].resident
    uploaded = resident.h2d_bytes
    for pm in (c.jpm, c.tpm):
        pm.add_record("mut_up_3", 0, ("u3",), 10_000)
    after, stats = ex.execute(q, [c.tseg])
    want, _ = JaxExecutor(use_device=True).execute(j_compile(q.sql),
                                                   [c.jseg])
    assert sorted(after.rows) == sorted(want.rows) != sorted(before.rows)
    assert sum(r[1] for r in after.rows) == len(latest) - 1
    assert c.tseg.num_docs == 600
    # only the new mask crossed (the capacity's bools), no column rows
    assert resident.h2d_bytes - uploaded == 1024
    again, _ = ex.execute(q, [c.tseg])
    assert again.rows == after.rows and resident.h2d_bytes - uploaded == 1024


def test_upsert_managers_agree():
    """Random records into both managers (consuming rows, then a sealed
    segment's keys): bitmaps, versions and key counts equal; the live
    views read alike, past the bitmap too."""
    c, _ = _consuming(900, 120, seed=3, name="mut_up_4")
    for seg in ("mut_up_4", "other"):
        np.testing.assert_array_equal(c.tpm.valid_docs(seg),
                                      c.jpm.valid_docs(seg))
        assert c.tpm.valid_docs_version(seg) == c.jpm.valid_docs_version(seg)
    assert c.tpm.num_keys == c.jpm.num_keys
    jv, tv = c.jseg.valid_doc_ids, c.tseg.valid_doc_ids
    assert tv.version == jv.version
    np.testing.assert_array_equal(tv[:2000], jv[:2000])
    assert [tv[i] for i in (0, 5, 899, 5000)] == \
        [jv[i] for i in (0, 5, 899, 5000)]
    empty = tup._LiveValidDocs(c.tpm, "nothing")
    np.testing.assert_array_equal(empty[:7], np.ones(7, dtype=bool))
    c.tpm.remove_segment("mut_up_4")
    c.jpm.remove_segment("mut_up_4")
    assert c.tpm.num_keys == c.jpm.num_keys == 0


# -- upsert from the table config (the JAX server's wiring) --------------------

def _upsert_table(pkg, topic, flush_rows, mode="FULL", cmp="ts"):
    return pkg.TableConfig(
        "users", pkg.TableType.REALTIME,
        upsert_config=pkg.UpsertConfig(pkg.UpsertMode[mode], cmp)
        if mode else None,
        stream_config=pkg.StreamIngestionConfig(
            stream_type="memory", topic=topic,
            segment_flush_threshold_rows=flush_rows))


def _upsert_messages(n, n_keys, seed):
    """JSON rows whose ``ts`` runs out of arrival order, so the comparison
    column invalidates some arrivals themselves."""
    rng = np.random.default_rng(seed)
    return [json.dumps({"uid": f"u{int(rng.integers(n_keys))}",
                        "status": ["a", "b"][int(rng.integers(2))],
                        "score": int(rng.integers(100)),
                        "ts": int(i + rng.integers(-40, 40))})
            for i in range(n)]


@pytest.mark.parametrize("mode,cmp,want", [
    (None, "ts", None), ("NONE", "ts", None),
    ("FULL", "ts", (["uid"], "ts")), ("FULL", None, (["uid"], None))])
def test_table_upsert_manager_from_the_config(mode, cmp, want):
    """JAX's server builds the table's manager from the config
    (``pinot_tpu/server/server.py:200-226``); the port's consumer does."""
    pk = tdata.Schema("users", _t_schema().field_specs,
                      primary_key_columns=["uid"])
    mgr = tup.table_upsert_manager(_upsert_table(ttable, "t", 10, mode, cmp),
                                   pk)
    got = None if mgr is None else (mgr.primary_key_columns,
                                     mgr.comparison_column)
    assert got == want


@pytest.mark.parametrize("mode,pk", [("PARTIAL", ["uid"]), ("FULL", None)])
def test_table_upsert_manager_refuses(mode, pk):
    """PARTIAL is not served as FULL, and an upsert table needs a key."""
    schema = tdata.Schema("users", _t_schema().field_specs,
                          primary_key_columns=pk)
    with pytest.raises(ValueError):
        tup.table_upsert_manager(_upsert_table(ttable, "t", 10, mode),
                                 schema)


def test_upsert_config_consumes_and_seals_like_jax(tmp_path):
    """The same JSON rows into a consuming upsert segment: the port's from
    its table config, JAX's wired by its realtime table data manager
    (``add_consuming``). Equal bitmaps and answers mid-stream; the sealed
    port segment takes the bitmap over and answers as JAX's consuming one
    at the commit."""
    n = 1500
    messages = _upsert_messages(n, 200, seed=11)
    JStream.create("j_up_cfg", 1)
    for m in messages[:700]:
        JStream.get("j_up_cfg").produce(m, partition=0)
    tstream = MemoryStream.create("t_up_cfg", 1)
    tstream.produce_many(messages[:700])
    jtdm = JRealtimeTDM("users_REALTIME", upsert_manager=JTableUpsert(
        ["uid"], "ts"))
    jm = jrt.RealtimeSegmentDataManager(
        "users__0__0", _upsert_table(jtable, "j_up_cfg", n), make_schema(),
        0, JOffset(0), output_dir=str(tmp_path))
    jtdm.add_consuming(jm)
    tm = RealtimeSegmentDataManager(
        "users__0__0", _upsert_table(ttable, "t_up_cfg", n),
        tdata.Schema("users", _t_schema().field_specs,
                     primary_key_columns=["uid"]), 0, StreamOffset(0))
    jpm, tpm = jtdm.upsert_manager.partition(0), tm.upsert_manager.partition(0)
    try:
        for m in (jm, tm):
            assert m.run_once().value == "INITIAL_CONSUMING"
        assert tm.segment.num_docs == jm.segment.num_docs == 700
        np.testing.assert_array_equal(tpm.valid_docs("users__0__0"),
                                      jpm.valid_docs("users__0__0"))
        ex = ServerQueryExecutor(device="cpu")
        for sql in CONSUMING_SQL:
            got, _ = ex.execute(t_compile(sql), [tm.segment])
            want, _ = JaxExecutor(use_device=True).execute(j_compile(sql),
                                                           [jm.segment])
            assert sorted(map(repr, got.rows)) == \
                sorted(map(repr, want.rows)), sql
        for m in messages[700:]:
            JStream.get("j_up_cfg").produce(m, partition=0)
        tstream.produce_many(messages[700:])
        jr, tr = jm.consume_until_committed(), tm.consume_until_committed()
        assert (tr.state.value, tr.rows_indexed) == (jr.state.value,
                                                     jr.rows_indexed)
        sealed = tr.segment
        valid = jpm.valid_docs("users__0__0")[:n]
        assert valid.sum() < n
        np.testing.assert_array_equal(sealed.valid_doc_ids[:n], valid)
        for sql in CONSUMING_SQL:
            got, _ = ex.execute(t_compile(sql), [sealed])
            want, _ = JaxExecutor(use_device=True).execute(j_compile(sql),
                                                           [jm.segment])
            assert sorted(map(repr, got.rows)) == \
                sorted(map(repr, want.rows)), sql
    finally:
        JStream.delete("j_up_cfg")
        MemoryStream.delete("t_up_cfg")
