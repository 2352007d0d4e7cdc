"""The fused scan's blocklist and preflight (tests/test_preflight.py:158-278
on the port, and the preflight held to the kernel's compiler).

- Every fuzz-grid shape: the preflight's verdict equals what
  ``compile_program`` does with it (builds the program, or declines with
  the same ``pallas_preflight_<rule>`` code), and each rule has a shape
  that fails on it.
- The 13 SSB flights pass at the default limits, as JAX's do
  (tests/test_preflight.py:59), and the table's shapes are JAX's.
- A plan over a limit (17 accumulator rows, a filter 33 deep) declines to
  the general rung with its rule's code on both executors, and its rows
  equal the JAX executor's (before, ``compile_program`` raised).
- A seeded shape declines through both executors with its reason and the
  answer stays right; a pessimal shared-memory limit fails and seeds all
  13 flights.
- The blocklist round-trips through its file, a new executor reads it
  from ``pinot.server.query.pallas.blocklist.path``, the port reads a file
  JAX wrote, and ``GET /debug/pallas`` serves the blocklist and the
  verdict table over REST. Only a preflight code blocks a shape: JAX's
  runtime entries in a file are refused, and so is ``add`` of one.
"""

import json
import urllib.request

from types import SimpleNamespace

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import ServerQueryExecutor as JExecutor  # noqa: E402
from pinot_tpu.engine.pallas_blocklist import (  # noqa: E402
    PallasBlocklist as JBlocklist,
)
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.tools import preflight as jpreflight  # noqa: E402
from pinot_tpu.tools import ssb as jssb  # noqa: E402
from pinot_tpu_torch.common.tracing import (  # noqa: E402
    PALLAS_PREFLIGHT_REASONS,
)
from pinot_tpu_torch.engine import fused_scan  # noqa: E402
from pinot_tpu_torch.engine.executor import ServerQueryExecutor  # noqa: E402
from pinot_tpu_torch.engine.pallas_blocklist import (  # noqa: E402
    RUNTIME_BLOCK_REASON,
    PallasBlocklist,
)
from pinot_tpu_torch.engine.plan import plan_segment  # noqa: E402
from pinot_tpu_torch.engine.staging import StagedSegment  # noqa: E402
from pinot_tpu_torch.parallel import ShardedQueryExecutor  # noqa: E402
from pinot_tpu_torch.query import compile_query  # noqa: E402
from pinot_tpu_torch.spi.config import (  # noqa: E402
    CommonConstants,
    PinotConfiguration,
)
from pinot_tpu_torch.tools import preflight, ssb  # noqa: E402

from tests.test_torch_executor import carry  # noqa: E402

ROWS = 6_000
FUZZ = {label: (pp, bits) for label, pp, bits in preflight.fuzz_specs()}


@pytest.fixture(scope="module")
def segs():
    return ssb.build_segments(0, num_segments=2, rows=ROWS)[0]


@pytest.fixture(scope="module")
def table(segs):
    return preflight.run_preflight(segs, device="cpu")


# -- the preflight against the kernel's compiler ------------------------------

@pytest.mark.parametrize("label", sorted(FUZZ))
def test_verdict_equals_compile_program(label):
    pp, bits = FUZZ[label]
    v = preflight.preflight_program(pp, bits, shape=label)
    assert v.ok == (not label.endswith(("_over", "_straddle"))), label
    if v.ok:
        prog = fused_scan.compile_program(pp, bits)
        assert fused_scan.scan_layout(prog).smem == v.smem_bytes > 0
        assert prog.prog.size == v.program_words
    else:
        with pytest.raises(fused_scan.ScanLimitError) as e:
            fused_scan.compile_program(pp, bits)
        assert v.rule == e.value.reason, (label, v.row())
        assert v.row()["detail"] == str(e.value)


def test_every_rule_fails_alone_somewhere():
    failing = {}
    for label, (pp, bits) in FUZZ.items():
        v = preflight.preflight_program(pp, bits)
        if not v.ok:
            failing.setdefault(v.rule, []).append(label)
            assert label.endswith(("_over", "_straddle")), label
    assert set(failing) == {r.code for r in preflight.RULES} \
        == PALLAS_PREFLIGHT_REASONS


@pytest.fixture(scope="module")
def jpair(tmp_path_factory):
    """JAX's SSB segments and the port's carried across."""
    jsegs = jssb.build_segments(0, str(tmp_path_factory.mktemp("jssb")),
                                num_segments=2, rows=ROWS, workers=1)
    return jsegs, carry(jsegs, "ssb_lineorder")


def test_table_shape_is_jaxs(table, jpair):
    """JAX's table keys, but its lowering model's numbers ("model") are
    the port's kernel limits ("limits")."""
    jtable = jpreflight.run_preflight(jpair[0], fuzz=False)
    assert set(table) - {"limits"} == set(jtable) - {"model"}
    assert jtable["ssb_failed"] == table["ssb_failed"] == []
    row = preflight.Verdict("x", "fuzz", False, "r", "d").row()
    assert {"shape", "source", "verdict", "rule", "detail"} <= set(row)
    assert "_plan_specs" not in preflight.serializable_table(table)


def test_all_13_ssb_flights_pass_at_default_limits(table):
    rows = {r["shape"]: r for r in table["shapes"] if r["source"] == "ssb"}
    assert sorted(rows) == sorted(ssb.QUERIES)
    assert all(r["verdict"] == "pass" for r in rows.values()), rows
    assert table["ssb_failed"] == []
    assert table["passed"] + table["failed"] == len(table["shapes"])


def test_preflight_runs_on_the_card_unless_asked(capsys):
    """The CLI and ``run_preflight`` stage on the card by default, and
    raise where there is none; ``--device cpu`` runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        preflight.main(["--no-fuzz", "--rows", "2000"])
    with pytest.raises(RuntimeError, match="cuda"):
        preflight.run_preflight(fuzz=False, rows=2000)
    assert preflight.main(["--no-fuzz", "--rows", "2000", "--json",
                           "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["ssb_failed"] == []


def test_not_extractable_plan_reports_reason(segs):
    staged = StagedSegment(segs[0], device="cpu")
    plan = plan_segment(compile_query(
        "SELECT distinctcount(c_city) FROM ssb_lineorder"), segs[0])
    pp, bits, eff, reason = preflight.extract_query_program(plan, staged)
    assert pp is None and bits is None and eff is None
    assert reason == "pallas_distinct_agg"


# -- a plan over the kernel's limits declines to the general rung -------------

_WIDE = ("SELECT " + ", ".join(f"sum(lo_quantity + {k})"
                               for k in range(1, 18))
         + " FROM ssb_lineorder")


def _deep_filter(depth):
    node = "lo_discount > 0"
    for i in range(depth - 1):
        node = (f"(lo_quantity < {50 - (i % 7)} AND {node})" if i % 2
                else f"(lo_discount < {9 - (i % 5)} OR {node})")
    return ("SELECT lo_discount, count(*), sum(lo_quantity) "
            "FROM ssb_lineorder WHERE " + node
            + " GROUP BY lo_discount ORDER BY lo_discount")


@pytest.mark.parametrize("sql, code", [
    (_WIDE, "pallas_preflight_accumulator_rows"),
    (_deep_filter(40), "pallas_preflight_filter_stack"),
])
def test_limit_declines_with_its_code(jpair, sql, code):
    jsegs, segs = jpair
    want, _ = JExecutor(use_device=True, use_pallas=False).execute(
        j_compile(sql), jsegs)
    for ex in (ServerQueryExecutor(device="cpu"),
               ShardedQueryExecutor(device="cpu")):
        try:
            got, stats = ex.execute(compile_query(sql), segs)
            assert got.rows == want.rows, (type(ex).__name__, sql)
            assert any(k.endswith(":" + code) for k in stats.decisions), \
                stats.decisions
        finally:
            ex.close()


# -- seeded shapes decline with their reason ----------------------------------

def test_seeded_fail_declines_per_segment_with_rule_reason(segs):
    ex = ServerQueryExecutor(device="cpu")
    host = ServerQueryExecutor(device="cpu", use_fused_scan=False)
    try:
        sql = ssb.QUERIES["Q1.1"]
        plan = plan_segment(compile_query(sql), segs[0])
        ex._pallas_blocked.add(plan.spec,
                               reason="pallas_preflight_smem_budget")
        got, stats = ex.execute(compile_query(sql), segs)
        want, _ = host.execute(compile_query(sql), segs)
        assert got.rows == want.rows
        keys = [k for k in stats.decisions
                if k.endswith(":pallas_preflight_smem_budget")]
        assert keys, stats.decisions
        assert not [k for k in stats.decisions if k.endswith(":unknown")]
    finally:
        ex.close()
        host.close()


def test_seeded_fail_declines_sharded_with_rule_reason(segs):
    ex = ShardedQueryExecutor(device="cpu")
    try:
        sql = ssb.QUERIES["Q2.1"]
        batch, _staged = ex.batch_for(segs)
        plan = plan_segment(compile_query(sql), batch)
        ex._pallas_blocked.add(plan.spec,
                               reason="pallas_preflight_smem_budget")
        _got, stats = ex.execute(compile_query(sql), segs)
        assert [k for k in stats.decisions
                if k.endswith(":pallas_preflight_smem_budget")], \
            stats.decisions
    finally:
        ex.close()


def test_attach_verdicts_seeds_blocklist_under_pessimal_limits(segs,
                                                              monkeypatch):
    monkeypatch.setattr(fused_scan, "_SMEM_BLOCK_MAX", 1 << 10)
    table = preflight.run_preflight(segs, fuzz=False, device="cpu")
    assert len(table["ssb_failed"]) == 13
    ex = ServerQueryExecutor(device="cpu")
    try:
        assert preflight.attach_verdicts(ex, table) == 13
        assert len(ex._pallas_blocked) == 13
        assert ex.preflight_verdicts["failed"] == 13
        assert "_plan_specs" not in ex.preflight_verdicts
        plan = plan_segment(compile_query(ssb.QUERIES["Q1.1"]), segs[0])
        assert ex._pallas_blocked.reason_for(plan.spec) == \
            "pallas_preflight_smem_budget"
    finally:
        ex.close()


# -- the blocklist's file and /debug/pallas -----------------------------------

def test_blocklist_roundtrips_through_disk(tmp_path, segs):
    path = str(tmp_path / "blocklist.json")
    bl = PallasBlocklist(path=path)
    plan = plan_segment(compile_query(ssb.QUERIES["Q1.1"]), segs[0])
    bl.add(plan.spec, reason="pallas_preflight_tile_align")
    bl.add(("another", "shape"), reason="pallas_preflight_value_stack")
    with pytest.raises(ValueError):
        bl.add(("runtime", "shape"), reason=RUNTIME_BLOCK_REASON)
    bl2 = PallasBlocklist(path=path)
    assert plan.spec in bl2 and len(bl2) == 2
    assert bl2.reason_for(plan.spec) == "pallas_preflight_tile_align"
    assert bl2.reason_for(("another", "shape")) == \
        "pallas_preflight_value_stack"
    assert ("runtime", "shape") not in bl2
    assert bl2.snapshot() == bl.snapshot()


def test_blocklist_files_cross_packages(tmp_path):
    """The file JAX writes is the port's and the other way round."""
    path = str(tmp_path / "j.json")
    JBlocklist(path=path).add((("eq", "a"), (1, 2), True, None),
                              reason="pallas_preflight_vmem_budget")
    got = PallasBlocklist(path=path)
    assert got.reason_for((("eq", "a"), (1, 2), True, None)) == \
        "pallas_preflight_vmem_budget"
    path2 = str(tmp_path / "t.json")
    PallasBlocklist(path=path2).add(("x", 1),
                                    reason="pallas_preflight_filter_stack")
    assert JBlocklist(path=path2).reason_for(("x", 1)) == \
        "pallas_preflight_filter_stack"
    with open(path2) as f:
        assert json.load(f) == {"entries": [
            {"spec": "('x', 1)", "reason": "pallas_preflight_filter_stack"}]}


def test_runtime_entry_in_a_file_keeps_the_kernel(tmp_path, segs):
    """A shape JAX blocked after its kernel failed at run time, in a file
    the port reads: refused, so the flight still takes the fused scan."""
    path = str(tmp_path / "j.json")
    sql = ssb.QUERIES["Q1.3"]
    plan = plan_segment(compile_query(sql), segs[0])
    jbl = JBlocklist(path=path)
    jbl.add(plan.spec)
    jbl.add(("x", 1), reason="pallas_preflight_vmem_budget")
    ex = ServerQueryExecutor(device="cpu", config=PinotConfiguration(
        {CommonConstants.PALLAS_BLOCKLIST_PATH_KEY: path}))
    try:
        assert plan.spec not in ex._pallas_blocked
        assert len(ex._pallas_blocked) == 1
        _got, stats = ex.execute(compile_query(sql), segs)
        assert not [k for k in stats.decisions if k.startswith("pallas:")], \
            stats.decisions
    finally:
        ex.close()


def test_executor_loads_blocklist_from_config(tmp_path, segs):
    path = str(tmp_path / "bl.json")
    plan = plan_segment(compile_query(ssb.QUERIES["Q1.2"]), segs[0])
    PallasBlocklist(path=path).add(plan.spec,
                                   reason="pallas_preflight_smem_budget")
    ex = ServerQueryExecutor(device="cpu", config=PinotConfiguration(
        {CommonConstants.PALLAS_BLOCKLIST_PATH_KEY: path}))
    try:
        assert ex._pallas_blocked.reason_for(plan.spec) == \
            "pallas_preflight_smem_budget"
        _got, stats = ex.execute(compile_query(ssb.QUERIES["Q1.2"]), segs)
        assert [k for k in stats.decisions
                if k.endswith(":pallas_preflight_smem_budget")]
        ex._pallas_blocked.add(("another", "shape"),
                               reason="pallas_preflight_filter_stack")
        assert ("another", "shape") in PallasBlocklist(path=path)
    finally:
        ex.close()


def test_debug_pallas_body(table):
    from pinot_tpu_torch.server.server import ServerInstance

    ex = ServerQueryExecutor(device="cpu")
    try:
        preflight.attach_verdicts(ex, table)
        ex._pallas_blocked.add(("bad", "shape"),
                               reason="pallas_preflight_accumulator_rows")
        body = ServerInstance.pallas_debug(SimpleNamespace(executor=ex))
        assert body["blockedShapes"] == 1
        [row] = body["blocklist"]
        assert row["reason"] == "pallas_preflight_accumulator_rows"
        assert body["preflight"]["passed"] == table["passed"]
        json.dumps(body)
        fresh = ServerInstance.pallas_debug(SimpleNamespace(
            executor=ServerQueryExecutor(device="cpu")))
        assert fresh == {"blocklist": [], "blockedShapes": 0,
                         "preflight": {"run": False}}
    finally:
        ex.close()


def test_debug_pallas_over_rest(tmp_path, table):
    from pinot_tpu_torch.common.telemetry import TELEMETRY
    from pinot_tpu_torch.tools.cluster import EmbeddedCluster
    from pinot_tpu_torch.transport.rest import ServerAdminApi

    cluster = EmbeddedCluster(num_servers=1, device="cpu")
    server = cluster.servers["server_0"]
    preflight.attach_verdicts(server.executor, table)
    api = ServerAdminApi(server, port=0)
    api.start()
    try:
        with urllib.request.urlopen(
                f"http://localhost:{api.port}/debug/pallas",
                timeout=20) as r:
            body = json.loads(r.read().decode())
        assert body["preflight"]["ssb_failed"] == []
        assert len(body["preflight"]["shapes"]) == len(table["shapes"])
        assert body["blockedShapes"] == 0
    finally:
        api.stop()
        cluster.shutdown()
        TELEMETRY.reset()


def test_a_launch_failure_still_raises(segs):
    """No runtime blocklist: a failing launch raises, and adds nothing."""
    ex = ServerQueryExecutor(device="cpu")
    real = fused_scan.fused_scan_plain

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    fused_scan.fused_scan_plain = boom
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            ex.execute(compile_query(ssb.QUERIES["Q1.1"]), segs)
        assert len(ex._pallas_blocked) == 0
    finally:
        fused_scan.fused_scan_plain = real
        ex.close()


def test_blocked_spec_literals_round_trip(segs):
    """Every SSB plan spec survives the file's repr / literal_eval."""
    import ast

    for sql in ssb.QUERIES.values():
        spec = plan_segment(compile_query(sql), segs[0]).spec
        assert ast.literal_eval(repr(spec)) == spec
    assert np.int64(3) == ast.literal_eval(repr(3))
