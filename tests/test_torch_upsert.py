"""Upsert valid-doc filtering in the port against the JAX package.

tests/test_upsert.py's device-path table (3000 rows over 900 keys, one
live doc per key) is built and made upsert-managed by the JAX package; its
valid-doc snapshot is carried across with the columns
(``segment_from_arrays(valid_doc_ids=...)``). The port's general rung ANDs
the snapshot into every filter (the ``validdocs`` leaf, which the fused
scan declines as the JAX Pallas kernel does), leaf by leaf against the JAX
jnp body and end to end against the JAX executors. A bitmap changed
between two queries is seen by the second; a segment batch refuses upsert
segments and the sharded executor serves them per segment.

Tolerance: every cell exact (counts and integer sums and maxima).
"""

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
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment.upsert import (  # noqa: E402
    PartitionUpsertMetadataManager,
    attach_valid_docs,
)
from pinot_tpu_torch.engine import kernels as tk  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.engine.staging import StagedSegment  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel.batch import SegmentBatch  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import (  # noqa: E402
    columns_of,
    segment_from_arrays,
)

from tests.test_torch_kernels import _assert_tree_equal  # noqa: E402
from tests.test_upsert import build_seg  # noqa: E402

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
