"""The port's tracing (``pinot_tpu_torch/common/tracing.py`` and the
instrumented executors, servers and broker) against the JAX package's
(``pinot_tpu/common/tracing.py``, oracle: tests/test_trace.py).

The same segments (built by the JAX package and carried across) and the
same SQL go through both packages: span trees are compared by name and
nesting (never by ms) for one segment, a segment group-by, the sharded
combine and a cluster query. Also: the recorder's contract, the untraced
path, sampling, the slow log and the registry ring, an exception on the
device path (it still raises, its tree closed), traced DataTable bytes
between the packages, the ledger's reason histogram beside JAX's, the
reason registry's conformance scan over the port's modules, and
chip_smoke's phase 18 at a small size.
"""

import os
import threading
import time

import numpy as np
import pytest

from pinot_tpu.common import tracing as jtr
from pinot_tpu.common.datatable import DataTable as JDataTable
from pinot_tpu.engine import QueryStats as JStats
from pinot_tpu.engine import ServerQueryExecutor as JExecutor
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.segment import SegmentBuilder, load_segment
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema
from pinot_tpu.spi.config import CommonConstants as JCC
from pinot_tpu.spi.config import PinotConfiguration as JConfig
from pinot_tpu_torch.common import tracing as ttr
from pinot_tpu_torch.common.datatable import DataTable as TDataTable
from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.engine import executor as executor_mod
from pinot_tpu_torch.engine.executor import ServerQueryExecutor
from pinot_tpu_torch.engine.results import QueryStats
from pinot_tpu_torch.parallel.executor import ShardedQueryExecutor
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration
from tests.test_torch_executor import carry

RNG_SEED = 11
N = 1024
NUM_SEGMENTS = 3
REGIONS = ["east", "west", "north", "south"]

GROUP_SQL = ("SELECT region, sum(qty), count(*) FROM sales "
             "GROUP BY region ORDER BY region")
TRACED_SQL = GROUP_SQL + " OPTION(trace=true)"
AGG_SQL = "SELECT sum(qty), max(qty) FROM sales WHERE qty > 10"


def _schema():
    return Schema("sales", [FieldSpec("region", DataType.STRING),
                            FieldSpec("qty", DataType.LONG,
                                      FieldType.METRIC)])


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """(JAX segments, the same segments carried into the port)."""
    out = tmp_path_factory.mktemp("torch_trace_segs")
    rng = np.random.default_rng(RNG_SEED)
    built = []
    for i in range(NUM_SEGMENTS):
        b = SegmentBuilder(_schema(), f"sales_{i}")
        b.build({"region": [REGIONS[j] for j in rng.integers(0, 4, N)],
                 "qty": rng.integers(1, 50, N).tolist()}, str(out))
        built.append(load_segment(str(out / f"sales_{i}")))
    return built, carry(built, "sales")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    yield
    TELEMETRY.reset()


def _cfg(pkg, **keys):
    if pkg == "jax":
        return JConfig({getattr(JCC, k): v for k, v in keys.items()},
                       use_env=False)
    return PinotConfiguration(
        {getattr(CommonConstants, k): v for k, v in keys.items()},
        use_env=False)


def _shape(d):
    """Name and nesting of a span tree; the children of ScatterGather and
    Reduce (server trees and folds, in arrival order) sorted by instance."""
    kids = d.get("children", [])
    if d["name"] in ("ScatterGather", "Reduce"):
        kids = sorted(kids, key=lambda c: (c.get("instance", ""),
                                           c["name"]))
    return (d["name"], tuple(_shape(c) for c in kids))


def _walk(d):
    yield d
    for c in d.get("children", []):
        yield from _walk(c)


def _names(children):
    return [c["name"] for c in children]


# -- the recorder ----------------------------------------------------------------

def _recorder_cases(mod):
    """The same open / close sequences on one package's recorder ->
    (shapes of the finished trees, flat operators)."""
    out = []
    legacy: list = []
    rec = mod.SpanRecorder(legacy=legacy)
    with pytest.raises(RuntimeError):
        with rec.span("Outer", k=1):
            with rec.span("Inner"):
                raise RuntimeError("boom")
    out.append(rec.open_depth)
    root = rec.span_begin("Root")
    rec.span_begin("Abandoned")          # never closed by its owner
    rec.add_completed("Queue", wall_ms=2.0, queue_ms=2.0)
    rec.span_end(root, answer=42)
    out.append(rec.span_end(root))      # a second close is a no-op
    rec.adopt([{"name": "Adopted", "ms": 1.0}])
    rec.span_begin("Left")
    rec.close_all()
    out.append(rec.open_depth)
    out.append([_shape(s) for s in rec.spans])
    out.append([e["operator"] for e in legacy])
    sp = rec.spans[1]
    out.append((sp["answer"], sp["children"][0]["name"],
                sp["children"][0]["children"][0]["queueMs"]))
    return out


def test_recorder_contract_equal_to_jax():
    """Exceptions close their spans, an abandoned child is swept closed by
    its parent, a second close is a no-op, ``close_all`` closes the rest,
    and each close emits one flat entry: as in the JAX package."""
    got = _recorder_cases(ttr)
    assert got == _recorder_cases(jtr)
    assert got[3][0] == ("Outer", (("Inner", ()),))


def test_flatten_and_broker_root_equal_to_jax():
    tree = [{"name": "ServerQuery", "ms": 5.0, "table": "t", "children": [
        {"name": "Kernel", "ms": 4.0, "kernel": "fused_scan"}]}]
    assert ttr.flatten_spans(tree) == jtr.flatten_spans(tree)
    args = ({"COMPILATION": 1.0, "ROUTING": 0.5, "SCATTER_GATHER": 12.0,
             "REDUCE": 0.5}, tree, 14.0)
    folds = [{"name": "Fold", "rows": 2, "ms": 0.2, "instance": "s0"}]
    assert ttr.build_broker_root(*args, admission_wait_ms=0.3,
                                 reduce_folds=folds) == \
        jtr.build_broker_root(*args, admission_wait_ms=0.3,
                              reduce_folds=folds)


# -- span trees beside the JAX package's -------------------------------------------

@pytest.mark.parametrize("n_segs,sql", [(1, TRACED_SQL),
                                        (NUM_SEGMENTS, TRACED_SQL),
                                        (NUM_SEGMENTS,
                                         AGG_SQL + " OPTION(trace=true)")])
def test_per_segment_tree_equal_to_jax(segs, n_segs, sql):
    """One segment and a segment group-by (and aggregation): Admission,
    Lease, one SegmentGroupBy / SegmentAggregate a segment with its
    Stage and Kernel, at one worker thread; the children's ms inside the
    root's."""
    jsegs, tsegs = segs
    je = JExecutor(use_pallas=True, config=_cfg("jax",
                                                WORKER_THREADS_KEY="1"))
    _, js = je.execute(j_compile(sql), jsegs[:n_segs])
    _, ts = ServerQueryExecutor(device="cpu").execute(t_compile(sql),
                                                      tsegs[:n_segs])
    assert len(ts.spans) == 1
    assert _shape(ts.spans[0]) == _shape(js.spans[0])
    root = ts.spans[0]
    assert root["name"] == "ServerQuery" and root["table"] == "sales"
    assert _names(root["children"])[:2] == ["Admission", "Lease"]
    per_seg = root["children"][2:]
    assert [c["segment"] for c in per_seg] == \
        [s.segment_name for s in tsegs[:n_segs]]
    assert all(c["path"] == "device" for c in per_seg)
    kernels = [k for k in _walk(root) if k["name"] == "Kernel"]
    assert [k["kernel"] for k in kernels] == ["fused_scan"] * n_segs
    # the plain version on the CPU counts no launch
    assert all(k["served"] and k["launches"] == 0 for k in kernels)
    assert sum(c["ms"] for c in root["children"]) <= root["ms"] * 1.05
    assert {"ServerQuery", "Kernel"} <= {e["operator"] for e in ts.trace}


def test_per_segment_tree_at_eight_worker_threads(segs):
    """At 8 worker threads each segment's spans are recorded in its
    worker's stats and adopted under the root: the same shape (their ms
    overlap, so the root's sum is not checked)."""
    jsegs, tsegs = segs
    js = JExecutor(use_pallas=True, config=_cfg(
        "jax", WORKER_THREADS_KEY="8")).execute(j_compile(TRACED_SQL),
                                                jsegs)[1]
    ts = ServerQueryExecutor(device="cpu", config=_cfg(
        "port", WORKER_THREADS_KEY="8")).execute(t_compile(TRACED_SQL),
                                                 tsegs)[1]
    assert _shape(ts.spans[0]) == _shape(js.spans[0])


def test_general_rung_tree_equal_to_jax(segs):
    """The fused scan off: one Stage and one general Kernel a segment, as
    JAX's jnp kernel with Pallas off."""
    jsegs, tsegs = segs
    js = JExecutor(use_pallas=False).execute(j_compile(TRACED_SQL),
                                             jsegs)[1]
    ex = ServerQueryExecutor(device="cpu", use_fused_scan=False)
    ts = ex.execute(t_compile(TRACED_SQL), tsegs)[1]
    assert _shape(ts.spans[0]) == _shape(js.spans[0])
    kernels = [k for k in _walk(ts.spans[0]) if k["name"] == "Kernel"]
    assert [(k["kernel"], k["launches"]) for k in kernels] == \
        [("general", 1)] * NUM_SEGMENTS
    assert ts.general_launches == NUM_SEGMENTS


def test_sharded_combine_tree_equal_to_jax(segs):
    """The batch path: Admission, Lease, ShardedCombine with the
    launcher's queue wait as queueMs."""
    jsegs, tsegs = segs
    js = JSharded(use_pallas=True).execute(j_compile(TRACED_SQL), jsegs)[1]
    ts = ShardedQueryExecutor(device="cpu").execute(t_compile(TRACED_SQL),
                                                    tsegs)[1]
    assert _shape(ts.spans[0]) == _shape(js.spans[0])
    sc = [c for c in ts.spans[0]["children"]
          if c["name"] == "ShardedCombine"][0]
    assert "queueMs" in sc and "workMs" in sc
    assert sc["kernel"] == "fused_scan" and sc["segments"] == NUM_SEGMENTS


def _j_cluster(tmp_path, jsegs):
    from pinot_tpu.spi.table import TableConfig
    from pinot_tpu.tools.cluster import EmbeddedCluster

    c = EmbeddedCluster(num_servers=2, data_dir=str(tmp_path / "jc"))
    c.create_table(TableConfig("sales"), _schema())
    for s in jsegs:
        c.upload_segment_dir("sales_OFFLINE", s.segment_dir)
    assert c.wait_for_ev_converged("sales_OFFLINE", timeout_s=60)
    return c


def _t_cluster(tsegs):
    from pinot_tpu_torch.spi import data as tdata
    from pinot_tpu_torch.spi.table import TableConfig
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster

    schema = tdata.Schema("sales", [
        tdata.FieldSpec("region", tdata.DataType.STRING),
        tdata.FieldSpec("qty", tdata.DataType.LONG,
                        tdata.FieldType.METRIC)])
    c = EmbeddedCluster(num_servers=2, device="cpu")
    c.create_table(TableConfig("sales"), schema)
    for s in tsegs:
        c.upload_segment("sales_OFFLINE", s)
    assert c.wait_for_ev_converged("sales_OFFLINE", timeout_s=60)
    return c


def test_cluster_trace_equal_to_jax(segs, tmp_path):
    """Through the front door: the broker root (Compile, Routing,
    ScatterGather, Reduce with a Fold a server), each server's tree
    (SchedulerQueue first) under ScatterGather tagged with its instance,
    every flat entry tagged; an untraced query carries no traceInfo."""
    jsegs, tsegs = segs
    jc = _j_cluster(tmp_path, jsegs)
    tc = _t_cluster(tsegs)
    try:
        jr = jc.query(TRACED_SQL).to_dict()
        tr = tc.query(TRACED_SQL).to_dict()
        assert not tr["exceptions"]
        jroot, troot = jr["traceInfo"]["spans"][0], tr["traceInfo"]["spans"][0]
        assert _shape(troot) == _shape(jroot)
        assert _names(troot["children"]) == \
            ["Compile", "Routing", "ScatterGather", "Reduce"]
        sg = troot["children"][2]
        servers = [s["instance"] for s in sg["children"]]
        assert sorted(servers) == sorted(tc.servers)
        for s in sg["children"]:
            assert s["children"][0]["name"] == "SchedulerQueue"
        assert all("instance" in e for e in tr["traceInfo"]["entries"])
        assert "traceInfo" not in tc.query(GROUP_SQL).to_dict()
        # no server keeps a running query
        assert all(not s.queries_debug()["running"]
                   for s in tc.servers.values())
    finally:
        jc.shutdown()
        tc.shutdown()


# -- the untraced path, sampling, the registry ------------------------------------

def test_off_path_allocates_no_recorder(segs):
    _, tsegs = segs
    for ex in (ServerQueryExecutor(device="cpu"),
               ShardedQueryExecutor(device="cpu")):
        _, stats = ex.execute(t_compile(GROUP_SQL), tsegs)
        assert getattr(stats, "_recorder", None) is None
        assert stats.spans == [] and stats.trace == []
        dt = ex.execute_instance(t_compile(GROUP_SQL), tsegs)
        assert "spans" not in dt.stats.to_dict()


def test_sample_rate_traces_without_the_option(segs):
    _, tsegs = segs
    ex = ServerQueryExecutor(device="cpu", config=_cfg(
        "port", TRACE_SAMPLE_KEY="1.0"))
    _, stats = ex.execute(t_compile(GROUP_SQL), tsegs)
    assert stats.spans and stats.spans[0]["name"] == "ServerQuery"


def test_traced_query_never_rides_an_untraced_run(segs, monkeypatch):
    """The query single flight keys on the trace decision: a call sampled
    for tracing and an untraced call of one compiled context at once run
    apart, one with its tree and one with none."""
    _, tsegs = segs
    ex = ServerQueryExecutor(device="cpu")
    ctx = t_compile(GROUP_SQL)
    decisions = iter([True, False])
    lock = threading.Lock()

    def decide(_ctx):
        with lock:
            return next(decisions)

    gate, entered = threading.Event(), []
    real = ex._run_query

    def run(*args):
        entered.append(1)
        gate.wait(10)
        return real(*args)

    monkeypatch.setattr(ex, "_trace_requested", decide)
    monkeypatch.setattr(ex, "_run_query", run)
    outs = []
    threads = [threading.Thread(target=lambda: outs.append(
        ex.execute(ctx, tsegs))) for _ in range(2)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while len(entered) < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    gate.set()
    for t in threads:
        t.join(30)
    assert len(entered) == 2 and ex.query_flight.hits == 0
    assert sorted(bool(st.spans) for _, st in outs) == [False, True]


def test_slow_log_keeps_the_tree_of_an_untraced_query(segs):
    _, tsegs = segs
    ex = ServerQueryExecutor(device="cpu", config=_cfg(
        "port", SLOW_THRESHOLD_MS_KEY="0.0001"))
    _, stats = ex.execute(t_compile(GROUP_SQL), tsegs)
    assert stats.spans == [] and stats.trace == []
    slow = ex.queries.snapshot()["slow"][-1]
    assert slow["spans"][0]["name"] == "ServerQuery"
    assert "Lease" in _names(slow["spans"][0]["children"])
    # the flight recorder's ring got the tree too
    assert TELEMETRY.recorder.snapshot()["spanRingSize"] >= 1


def test_registry_ring_and_request_id(segs):
    _, tsegs = segs
    ex = ServerQueryExecutor(device="cpu")
    ex.execute(t_compile(GROUP_SQL + " OPTION(requestId=dash42)"), tsegs)
    snap = ex.queries.snapshot()
    done = snap["completed"][-1]
    assert done["requestId"] == "dash42" and done["table"] == "sales"
    assert done["elapsedMs"] > 0 and snap["running"] == []


def test_device_failure_raises_with_its_tree_closed(segs, monkeypatch):
    """Tracing catches no failure of a device path: the query raises, the
    registry's entry carries the error, the slow log a closed tree."""
    _, tsegs = segs

    def boom(*a, **k):
        raise RuntimeError("kernel exploded")

    monkeypatch.setattr(executor_mod.fused_scan, "run_segment", boom)
    ex = ServerQueryExecutor(device="cpu", config=_cfg(
        "port", SLOW_THRESHOLD_MS_KEY="0.0001"))
    with pytest.raises(RuntimeError, match="kernel exploded"):
        ex.execute(t_compile(TRACED_SQL), tsegs)
    snap = ex.queries.snapshot()
    assert snap["running"] == []
    assert "kernel exploded" in snap["completed"][-1]["error"]
    root = snap["slow"][-1]["spans"][0]
    assert root["name"] == "ServerQuery" and root["ms"] >= 0
    names = [d["name"] for d in _walk(root)]
    assert names[-2:] == ["Stage", "Kernel"]


# -- the wire -----------------------------------------------------------------------

def _traced_stats(cls):
    st = cls(num_docs_scanned=7)
    st.spans.append({"name": "ServerQuery", "ms": 5.0, "children": [
        {"name": "Kernel", "ms": 4.0, "kernel": "fused_scan",
         "launches": 2}]})
    st.trace.append({"operator": "Kernel", "ms": 4.0})
    st.decisions["pallas:pallas_kernel->jnp_kernel:pallas_distinct_agg"] = 2
    return st


def test_traced_datatable_bytes_between_packages(segs):
    """JAX-encoded traced bytes decode in the port with equal trace and
    spans, and the reverse; a real traced instance answer too."""
    jdt = JDataTable.for_aggregation([1.0], _traced_stats(JStats))
    back = TDataTable.from_bytes(jdt.to_bytes())
    assert back.stats.spans == jdt.stats.spans
    assert back.stats.trace == jdt.stats.trace
    tdt = TDataTable.for_aggregation([1.0], _traced_stats(QueryStats))
    back = JDataTable.from_bytes(tdt.to_bytes())
    assert back.stats.spans == tdt.stats.spans
    assert back.stats.trace == tdt.stats.trace
    _, tsegs = segs
    dt = ServerQueryExecutor(device="cpu").execute_instance(
        t_compile(TRACED_SQL), tsegs)
    back = JDataTable.from_bytes(dt.to_bytes())
    assert back.stats.spans == dt.stats.spans and dt.stats.spans
    assert back.stats.trace == dt.stats.trace


def test_tag_trace_copies_the_table():
    """The broker tags a copy: a table shared in process keeps its own
    trace untagged."""
    from pinot_tpu_torch.broker.broker import _tag_trace

    dt = TDataTable.for_aggregation([1.0], _traced_stats(QueryStats))
    tagged = _tag_trace(dt, "server_0")
    assert tagged is not dt
    assert tagged.stats.spans[0]["instance"] == "server_0"
    assert all(e["instance"] == "server_0" for e in tagged.stats.trace)
    assert "instance" not in dt.stats.spans[0]
    assert all("instance" not in e for e in dt.stats.trace)


# -- the decision ledger and the reason registry ----------------------------------

LEDGER_QUERIES = [
    "SELECT DISTINCT region FROM sales",
    "SELECT region, DISTINCTCOUNT(qty) FROM sales GROUP BY region",
    "SELECT region, sum(qty) FROM sales GROUP BY region",
    "SELECT DISTINCTCOUNT(qty) FROM sales",
]


def _reasons(mod, delta):
    out = {}
    for key, n in delta.items():
        reason = mod.parse_decision_key(key)[3]
        out[reason] = out.get(reason, 0) + n
    return out


def test_ledger_reason_histogram_equal_to_jax(segs):
    """Over the queries whose per-query decisions agree, the process
    ledger's delta and its reason histogram equal JAX's."""
    jsegs, tsegs = segs
    je = JExecutor(use_pallas=True)
    te = ServerQueryExecutor(device="cpu")
    agreed = 0
    for sql in LEDGER_QUERIES:
        jm = jtr.LEDGER.snapshot()
        _, js = je.execute(j_compile(sql), jsegs)
        jd = jtr.LEDGER.delta(jm)
        tm = ttr.LEDGER.snapshot()
        _, ts = te.execute(t_compile(sql), tsegs)
        td = ttr.LEDGER.delta(tm)
        assert td == ts.decisions, sql     # the ledger saw every record
        if js.decisions == ts.decisions:
            agreed += 1
            assert td == jd, sql
            assert _reasons(ttr, td) == _reasons(jtr, jd), sql
    assert agreed >= 3


def test_ledger_binds_the_labeled_family():
    from pinot_tpu_torch.spi.metrics import MetricsRegistry

    ledger = ttr.DecisionLedger()
    ledger.record("pallas", "jnp_kernel", "pallas_kernel",
                  "pallas_distinct_agg")
    reg = MetricsRegistry(role="server")
    ledger.bind_metrics(reg)
    ledger.record("routing", "pruned", "all_servers", "time_prune")
    text = reg.export_prometheus()
    assert ('pinot_server_decision_declined_total{point="pallas",'
            'reason="pallas_distinct_agg"} 1') in text
    assert ('pinot_server_decision_declined_total{point="routing",'
            'reason="time_prune"} 1') in text
    assert ledger.reason_histogram() == {"pallas_distinct_agg": 1,
                                         "time_prune": 1}


@pytest.mark.parametrize("name", sorted(ttr.reason_registry()))
def test_reason_namespace_conforms_over_port_modules(name):
    """Each namespace scans the port's own modules: every literal at a
    record site registered, enough sites found, an exact namespace using
    every code; its codes are JAX's."""
    ns = ttr.reason_registry(name)
    assert all(m == "pinot_tpu_torch" or m.startswith("pinot_tpu_torch.")
               for m in ns.modules)
    found, bad = ns.conformance()
    assert not bad, (name, bad)
    assert len(found) >= ns.min_sites, (name, found)
    if ns.exact:
        assert found == set(ns.codes), (name, set(ns.codes) - found)
    if name == "pallas_preflight":
        # the port's rules name its own kernel's limits under JAX's prefix;
        # the two rules both kernels have keep JAX's codes
        assert all(c.startswith("pallas_preflight_") for c in ns.codes)
        assert {"pallas_preflight_tile_align",
                "pallas_preflight_smem_budget"} <= \
            ns.codes & jtr.reason_registry(name).codes
    elif name == "race_ok":
        # the port's lint waives with JAX's four designs and its own
        # helper-object one
        assert ns.codes - jtr.RACE_OK_REASONS == {"owner_serialized"}
        assert jtr.RACE_OK_REASONS <= ns.codes
    else:
        assert ns.codes <= jtr.reason_registry(name).codes


def test_registry_registers_race_waivers_and_port_preflight():
    """The port's lint has its own waiver namespace, registered over the
    whole package like JAX's, so every namespace of JAX's is the port's
    too. The preflight's namespace is registered with the port's own
    rules (tools/preflight.py), none of them a code of JAX's lowering
    model but the two both kernels share."""
    names = set(ttr.reason_registry())
    assert names == set(jtr.reason_registry())
    assert ttr.reason_registry("race_ok").codes is ttr.RACE_OK_REASONS
    assert ttr.reason_registry("race_ok").modules == ("pinot_tpu_torch",)
    assert jtr.RACE_OK_REASONS <= ttr.registered_reason_codes()
    assert ttr.PALLAS_PREFLIGHT_REASONS & jtr.PALLAS_PREFLIGHT_REASONS \
        == {"pallas_preflight_tile_align", "pallas_preflight_smem_budget"}
    # the sets that live beside their modules are registered from there
    from pinot_tpu_torch.broker import broker, reduce, routing

    assert ttr.reason_registry("routing").codes is \
        routing.ROUTING_DECISION_REASONS
    assert ttr.reason_registry("gather").codes is \
        broker.GATHER_DECISION_REASONS
    assert ttr.reason_registry("reduce_device").codes is \
        reduce.REDUCE_DEVICE_REASONS


def test_record_decision_is_tracing_s():
    """One record_decision: the per-query count and the process ledger."""
    from pinot_tpu_torch.engine import results

    assert not hasattr(results, "record_decision")
    st = QueryStats()
    mark = ttr.LEDGER.snapshot()
    ttr.record_decision(st, "seal", "immutable_swap", "consuming_segment",
                        "seal_swap")
    ttr.record_decision(None, "seal", "immutable_swap", "consuming_segment",
                        "seal_swap")
    key = "seal:consuming_segment->immutable_swap:seal_swap"
    assert st.decisions == {key: 1}
    assert ttr.LEDGER.delta(mark) == {key: 2}


def test_chip_smoke_phase_18_small():
    """Phase 18 on the CPU on the cluster phase 17 hands over, as the
    script runs them (phase 17 small: 48 k SSB rows in 8 segments, 8000
    realtime user-events rows): traced flights == the oracle with their
    trees checked, C1-C8 from 8 client threads each with its solo counts,
    the debug views, phase 17's realtime tables in the freshness view and
    the ledger's delta (the plain version counts no launch)."""
    import chip_smoke
    from pinot_tpu_torch.engine.pruner import prune_segments
    from pinot_tpu_torch.tools import ssb

    segs_, frames = ssb.build_segments(0, num_segments=8, seed=3,
                                       rows=48_000)
    ctxs = {q: t_compile(t + " LIMIT 100000")
            for q, t in ssb.QUERIES.items()}
    ex = ServerQueryExecutor(device="cpu")
    variants = dict(ssb.COALESCE_QUERIES)
    main = {"segs": segs_, "ctxs": ctxs, "seed": 3,
            "parts": {q: [ssb.numpy_answer(f, q) for f in frames]
                      for q in ctxs},
            "wants": {q: ssb.merge_answers(
                [ssb.numpy_answer(f, q) for f in frames]) for q in ctxs},
            "results": {q: ex.execute(c, segs_)[0] for q, c in ctxs.items()},
            "kept": {q: len(prune_segments(c, segs_))
                     for q, c in ctxs.items()},
            "variant_texts": variants,
            "variant_wants": {v: ssb.merge_answers(
                [ssb.numpy_answer(f, v) for f in frames])
                for v in variants}}
    handed: list = []
    chip_smoke.phase_realtime_cluster(
        main, reps=1, device="cpu", user_rows=8000, user_flush=1600,
        more_rows=800, ssb_rows=3000, ssb_flush=2000, upsert_rows=2200,
        upsert_flush=500, seed=5, hand_over=handed)
    (cluster,) = handed
    run = chip_smoke.phase_trace(main, reps=1, device="cpu",
                                 cluster=cluster,
                                 fresh_tables=chip_smoke.RT_FRESH_TABLES)
    assert set(run["flights"]) == set(ctxs)
    assert all(f["kernel_spans"] == main["kept"][q]
               for q, f in run["flights"].items())
    assert run["concurrency"]["queries"] == 16
    assert run["launches"] == {"fused_scan": 0, "fused_scan_probe": 0}
    assert run["ledger"]["equal"]
    assert run["telemetry"]["broker_count"] >= len(ctxs)
    assert set(chip_smoke.RT_FRESH_TABLES) <= set(
        run["telemetry"]["freshness"])
    assert not os.path.exists(run["flight_dir"])
    assert not cluster.servers and not TELEMETRY.sampling
