"""The server's instance surface in the port against the JAX package.

``execute_instance`` returns the mergeable ``DataTable`` the broker
reduces (oracle: ``tests/test_thread_safety.py``,
``tests/test_launcher.py:366``, ``:382``). The same SSB segments (JAX-built,
carried across with ``columns_of``) and the same SQL go through the port's
``ServerQueryExecutor(device="cpu")`` per segment and its
``ShardedQueryExecutor`` over the batch, and through the JAX executor
(``use_pallas=False``) and the JAX sharded executor, for every response
type: the response type, keys, counts and integer states exact, float
states within rel 1e-5, abs 1e-6 (tests/test_pallas.py:101); the schema,
``num_hidden`` and ``sorted_rows`` equal. Then the worker pool (the
config key, the pool's life, rows at 1 and 4 threads, decisions merged in
segment order, the admission lease carried into the tasks), the query
single-flight, and the first kernel build from several threads.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JaxExecutor  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine import _build, fused_scan, kernels  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import columns_of, segment_from_arrays  # noqa: E402
from pinot_tpu_torch.spi.config import (  # noqa: E402
    CommonConstants,
    PinotConfiguration,
)

ROWS = 18_000
SEED = 5
REL, ABS = 1e-5, 1e-6

INSTANCE_QUERIES = {
    "agg": "SELECT count(*), sum(lo_revenue), min(lo_discount), "
           "max(lo_quantity), avg(lo_extendedprice), "
           "minmaxrange(lo_supplycost) FROM ssb_lineorder "
           "WHERE d_year = 1993",
    "agg_empty": "SELECT count(*), sum(lo_revenue) FROM ssb_lineorder "
                 "WHERE d_year = 1800",
    "Q2.1": j_ssb.QUERIES["Q2.1"] + " LIMIT 100000",
    "Q3.2": j_ssb.QUERIES["Q3.2"] + " LIMIT 100000",
    "Q4.1": j_ssb.QUERIES["Q4.1"] + " LIMIT 100000",
    "groups_avg": "SELECT c_region, s_region, avg(lo_revenue), "
                  "min(lo_supplycost), count(*) FROM ssb_lineorder "
                  "GROUP BY c_region, s_region LIMIT 1000",
    "select": "SELECT d_year, c_region, lo_revenue FROM ssb_lineorder "
              "WHERE lo_quantity < 5 LIMIT 6 OFFSET 3",
    "select_ordered": "SELECT d_year, lo_revenue FROM ssb_lineorder "
                      "WHERE lo_discount = 2 ORDER BY lo_revenue DESC, "
                      "lo_supplycost, lo_extendedprice LIMIT 7 OFFSET 2",
    "select_ordered_visible": "SELECT lo_revenue, d_year FROM "
                              "ssb_lineorder ORDER BY lo_revenue, d_year "
                              "LIMIT 5",
    "distinct": "SELECT DISTINCT c_region, d_year FROM ssb_lineorder "
                "ORDER BY d_year DESC, c_region LIMIT 12",
    "distinct_having": "SELECT DISTINCT d_year FROM ssb_lineorder "
                       "HAVING d_year > 1994 ORDER BY d_year LIMIT 10",
}


def carry(jsegs, table):
    return [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                table_name=table) for j in jsegs]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    jsegs = j_ssb.build_segments(
        0, str(tmp_path_factory.mktemp("torch_instance")), num_segments=2,
        seed=SEED, rows=ROWS, star_tree=False, workers=1)
    return jsegs, carry(jsegs, "ssb_lineorder")


@pytest.fixture(scope="module")
def executors():
    return {"segment": (ServerQueryExecutor(device="cpu"),
                        JaxExecutor(use_device=True, use_pallas=False)),
            "batch": (ShardedQueryExecutor(device="cpu"),
                      JSharded(use_pallas=False))}


def _same_cell(a, b, what):
    if isinstance(b, float) or isinstance(a, float):
        assert a == pytest.approx(b, rel=REL, abs=ABS), what
    elif isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same_cell(x, y, what)
    else:
        assert a == b and type(a) is type(b), what


def assert_same_datatable(got, want, what=""):
    """The port's DataTable against the JAX one: exact but for float
    states."""
    assert got.response_type.value == want.response_type.value, what
    assert got.exceptions == want.exceptions, what
    t = want.response_type.value
    if t == "AGGREGATION":
        g, w = got.agg_states(), want.agg_states()
        assert len(g) == len(w), what
        for a, b in zip(g, w):
            _same_cell(a, b, what)
    elif t == "GROUP_BY":
        g, w = got.group_by_groups(), want.group_by_groups()
        assert list(g) == list(w), what
        for k in w:
            for a, b in zip(g[k], w[k]):
                _same_cell(a, b, (what, k))
        assert got.schema_types() == want.schema_types(), what
    else:
        assert got.data_schema().to_dict() == want.data_schema().to_dict(), \
            what
        assert got.num_hidden == want.num_hidden, what
        assert got.selection_sorted == want.selection_sorted, what
        g, w = got.rows(), want.rows()
        assert len(g) == len(w), what
        for rg, rw in zip(g, w):
            for a, b in zip(rg, rw):
                _same_cell(a, b, what)
    gs, ws = got.stats, want.stats
    assert (gs.num_docs_scanned, gs.total_docs, gs.num_segments_queried,
            gs.num_groups_limit_reached) == \
        (ws.num_docs_scanned, ws.total_docs, ws.num_segments_queried,
         ws.num_groups_limit_reached), what


@pytest.mark.parametrize("path", ["segment", "batch"])
@pytest.mark.parametrize("qid", sorted(INSTANCE_QUERIES))
def test_execute_instance_matches_jax(data, executors, path, qid):
    jsegs, tsegs = data
    port, jax_ex = executors[path]
    sql = INSTANCE_QUERIES[qid]
    want = jax_ex.execute_instance(j_compile(sql), jsegs)
    got = port.execute_instance(t_compile(sql), tsegs)
    assert_same_datatable(got, want, (path, qid))
    if qid == "select_ordered":
        assert got.num_hidden == 2 and got.selection_sorted
    if qid.startswith("distinct"):
        assert got.response_type.value == "DISTINCT"


@pytest.mark.parametrize("qid", ["Q2.1", "select_ordered", "distinct",
                                 "agg"])
def test_execute_instance_per_segment_matches_jax(data, executors, qid):
    """One segment a call: a server holding one segment."""
    jsegs, tsegs = data
    port, jax_ex = executors["segment"]
    sql = INSTANCE_QUERIES[qid]
    for j, t in zip(jsegs, tsegs):
        assert_same_datatable(port.execute_instance(t_compile(sql), [t]),
                              jax_ex.execute_instance(j_compile(sql), [j]),
                              (qid, t.segment_name))


@pytest.mark.parametrize("make", ["segment", "batch"])
def test_groups_limit_trim_matches_jax(data, make):
    """The group-by trimmed to num_groups_limit, flagged on both sides."""
    jsegs, tsegs = data
    port = (ServerQueryExecutor(device="cpu", num_groups_limit=7)
            if make == "segment"
            else ShardedQueryExecutor(device="cpu", num_groups_limit=7))
    jax_ex = (JaxExecutor(use_device=True, use_pallas=False,
                          num_groups_limit=7) if make == "segment"
              else JSharded(use_pallas=False, num_groups_limit=7))
    sql = INSTANCE_QUERIES["Q2.1"]
    got = port.execute_instance(t_compile(sql), tsegs)
    want = jax_ex.execute_instance(j_compile(sql), jsegs)
    assert got.num_rows() == 7 and got.stats.num_groups_limit_reached
    assert_same_datatable(got, want, make)


def test_unordered_selection_is_trimmed_to_offset_plus_limit(data):
    _, tsegs = data
    got = ServerQueryExecutor(device="cpu").execute_instance(
        t_compile(INSTANCE_QUERIES["select"]), tsegs)
    assert got.num_rows() == 9 and not got.selection_sorted


def test_instance_stats_survive_the_wire(data):
    from pinot_tpu_torch.common.datatable import DataTable

    _, tsegs = data
    got = ShardedQueryExecutor(
        device="cpu", use_fused_scan=False).execute_instance(
        t_compile(INSTANCE_QUERIES["Q2.1"]), tsegs)
    back = DataTable.from_bytes(got.to_bytes())
    assert back.stats.to_dict() == got.stats.to_dict()
    assert back.stats.batch_general_launches == 1
    assert back.stats.decisions == got.stats.decisions != {}
    assert back.stats.lease is None and "lease" not in got.stats.to_dict()


# -- the worker pool ----------------------------------------------------------

def _pool_config(threads, key=CommonConstants.WORKER_THREADS_KEY):
    return PinotConfiguration({key: threads}, use_env=False)


@pytest.mark.parametrize("key", [CommonConstants.WORKER_THREADS_KEY,
                                 "PINOT_SERVER_QUERY_WORKER_THREADS",
                                 "pinot-server-query-worker-threads"])
def test_worker_threads_from_the_config(key):
    ex = ServerQueryExecutor(device="cpu", config=_pool_config(3, key))
    assert ex.worker_threads == 3
    assert ServerQueryExecutor(
        device="cpu", config=_pool_config(0)).worker_threads == 1


def test_worker_threads_default_is_one():
    """A planned difference: JAX's default is min(cpu count, 8); the
    port's per-segment work is host Python under the GIL, so it runs one
    segment at a time unless the config asks for more."""
    ex = ServerQueryExecutor(device="cpu", config=PinotConfiguration(
        use_env=False))
    assert ex.worker_threads == CommonConstants.DEFAULT_WORKER_THREADS == 1


def test_pool_persists_across_queries_and_close_rebuilds(data):
    _, tsegs = data
    ex = ServerQueryExecutor(device="cpu", config=_pool_config(4))
    ctx = t_compile(INSTANCE_QUERIES["Q2.1"])
    ex.execute(ctx, tsegs)
    pool = ex._segment_pool
    assert pool is not None and pool.num_workers == 4
    ex.execute(t_compile(INSTANCE_QUERIES["Q3.2"]), tsegs)
    assert ex._segment_pool is pool
    ex.close()
    assert ex._segment_pool is None
    rows = ex.execute(ctx, tsegs)[0].rows
    assert ex._segment_pool is not None and ex._segment_pool is not pool
    assert rows == ServerQueryExecutor(device="cpu").execute(
        ctx, tsegs)[0].rows
    ex.close()


@pytest.mark.parametrize("qid", ["Q2.1", "Q4.1", "agg", "groups_avg"])
def test_rows_and_decisions_equal_at_one_and_four_threads(data, qid):
    jsegs, tsegs = data
    sql = INSTANCE_QUERIES[qid]
    out = {}
    for threads in (1, 4):
        ex = ServerQueryExecutor(device="cpu", config=_pool_config(threads))
        table, stats = ex.execute(t_compile(sql), tsegs)
        out[threads] = (table.rows, list(stats.decisions.items()),
                        stats.num_docs_scanned, stats.group_by_rung,
                        stats.scan_launches)
        ex.close()
    # decisions merge in segment order: the same keys in the same order
    assert out[1] == out[4]
    want, _ = JaxExecutor(use_device=True, use_pallas=False).execute(
        j_compile(sql), jsegs)
    for rg, rw in zip(out[4][0], want.rows):
        for a, b in zip(rg, rw):
            _same_cell(a, b, qid)


def test_decisions_merge_in_segment_order(data):
    """Each segment records its own decline; the pool's private stats
    merge back in segment order, as a serial run records them."""
    _, tsegs = data
    sql = ("SELECT d_year, percentile(lo_revenue, 50) FROM ssb_lineorder "
           "WHERE lo_quantity < 20 GROUP BY d_year LIMIT 100")
    runs = []
    for threads in (1, 4):
        ex = ServerQueryExecutor(device="cpu", config=_pool_config(threads))
        table, stats = ex.execute(t_compile(sql), tsegs)
        runs.append((table.rows, list(stats.decisions.items()),
                     stats.rung_segments))
        ex.close()
    assert runs[0] == runs[1]
    assert runs[0][1], "the host-engine route records its decision"


def test_lease_is_carried_into_the_pool_tasks(data):
    """A query that admission sends to the host engine makes no device
    launch on 4 threads: each task's stats carry the query's lease."""
    jsegs, tsegs = data
    cfg = PinotConfiguration({CommonConstants.WORKER_THREADS_KEY: 4,
                              CommonConstants.HBM_SLICING_ENABLED_KEY:
                                  "false"}, use_env=False)
    ex = ServerQueryExecutor(device="cpu", hbm_budget_bytes=4096,
                             config=cfg)
    sql = INSTANCE_QUERIES["Q2.1"]
    counters = (fused_scan.SCAN_COUNTER, fused_scan.PROBE_COUNTER,
                kernels.RUNG_COUNTER)
    before = [c.launches for c in counters]
    table, stats = ex.execute(t_compile(sql), tsegs)
    assert [c.launches for c in counters] == before
    assert stats.scan_launches == stats.general_launches == 0
    assert any(k.startswith("residency:device->host_engine:")
               for k in stats.decisions), stats.decisions
    assert stats.rung_segments == {"host": 2}
    want, _ = JaxExecutor(use_device=False).execute(j_compile(sql), jsegs)
    assert table.rows == want.rows
    ex.close()


def test_sliced_lease_stays_serial(data, monkeypatch):
    """A sliced lease runs its segments in turn, releasing each slice:
    no task reaches the pool."""
    _, tsegs = data
    ex = ServerQueryExecutor(device="cpu", config=_pool_config(4))
    ctx = t_compile(INSTANCE_QUERIES["Q2.1"])
    want = ex.execute(ctx, tsegs)[0].rows
    ex.close()
    ws, largest, _ = ServerQueryExecutor(device="cpu").residency \
        .working_set(tsegs, ctx.referenced_columns())
    ex = ServerQueryExecutor(device="cpu", config=_pool_config(4),
                             hbm_budget_bytes=(ws + largest) // 2)
    monkeypatch.setattr(ex, "_worker_pool", lambda: pytest.fail(
        "a sliced lease reached the pool"))
    table, stats = ex.execute(ctx, tsegs)
    assert any(k.startswith("residency:resident_device->sliced_device")
               for k in stats.decisions), stats.decisions
    assert table.rows == want
    assert stats.staging["slices"] == len(tsegs)


def test_first_build_from_several_threads_builds_once(monkeypatch):
    """The first launch from several workers builds the library once:
    ``load_library`` holds its lock across the build."""
    calls = []

    def build(name):
        calls.append(name)
        time.sleep(0.05)
        return "lib.so"

    class Lib:
        def __init__(self, path):
            self.path = path

    monkeypatch.setattr(_build, "build_library", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    monkeypatch.setattr(_build, "_declare", lambda name, lib: None)
    monkeypatch.setattr(_build, "_loaded", {})
    got = []
    barrier = threading.Barrier(8)

    def load():
        barrier.wait(10)
        got.append(_build.load_library("fused_scan"))

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert calls == ["fused_scan"]
    assert len(got) == 8 and all(g is got[0] for g in got)


# -- the query single-flight --------------------------------------------------

def _gated_run(ex, gate, entered):
    real = ex._run_query

    def run(ctx, segments, body, *opened):
        entered.append(1)
        gate.wait(10)
        return real(ctx, segments, body, *opened)

    ex._run_query = run


def test_concurrent_identical_execute_runs_once(data):
    _, tsegs = data
    ex = ServerQueryExecutor(device="cpu")
    ctx = t_compile(INSTANCE_QUERIES["Q2.1"])
    gate, entered = threading.Event(), []
    _gated_run(ex, gate, entered)
    outs = []
    threads = [threading.Thread(target=lambda: outs.append(
        ex.execute(ctx, tsegs))) for _ in range(6)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while ex.query_flight.hits < 5 and time.monotonic() < deadline:
        time.sleep(0.005)
    gate.set()
    for t in threads:
        t.join(30)
    assert len(entered) == 1 and ex.query_flight.hits == 5
    assert len(outs) == 6 and all(o is outs[0] for o in outs)


@pytest.mark.parametrize("kind", ["upsert", "mutable"])
def test_upsert_and_mutable_segments_never_share(data, kind):
    from pinot_tpu_torch.segment.mutable import MutableSegment
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema

    _, tsegs = data
    if kind == "upsert":
        seg = carry([tsegs[0]], "ssb_lineorder")[0]
        seg.valid_doc_ids = np.ones(seg.num_docs, dtype=bool)
        ctx = t_compile(INSTANCE_QUERIES["agg"])
    else:
        seg = MutableSegment(Schema("m", [
            FieldSpec("k", DataType.STRING),
            FieldSpec("v", DataType.INT, FieldType.METRIC)]), "m_0")
        for i in range(10):
            seg.index({"k": "ab"[i % 2], "v": i})
        ctx = t_compile("SELECT k, sum(v) FROM m GROUP BY k")
    ex = ServerQueryExecutor(device="cpu")
    assert ex._query_flight_key(ctx, [seg]) is None
    gate, entered = threading.Event(), []
    _gated_run(ex, gate, entered)
    threads = [threading.Thread(target=lambda: ex.execute(ctx, [seg]))
               for _ in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while len(entered) < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    gate.set()
    for t in threads:
        t.join(30)
    assert len(entered) == 3 and ex.query_flight.hits == 0


def test_flight_key_is_object_identity(data):
    _, tsegs = data
    ex = ServerQueryExecutor(device="cpu")
    sql = INSTANCE_QUERIES["agg"]
    a, b = t_compile(sql), t_compile(sql)
    assert ex._query_flight_key(a, tsegs) == ex._query_flight_key(a, tsegs)
    assert ex._query_flight_key(a, tsegs) != ex._query_flight_key(b, tsegs)
    reloaded = carry([tsegs[0]], "ssb_lineorder") + tsegs[1:]
    assert ex._query_flight_key(a, tsegs) != \
        ex._query_flight_key(a, reloaded)


def test_instance_surface_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedQueryExecutor()
