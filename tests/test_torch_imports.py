"""The PyTorch port stands alone: no JAX, no pinot_tpu, no hidden device
fallback."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "pinot_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "pinot_tpu"}


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PORT):
        out.extend(os.path.join(dirpath, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_executor_import_leaves_jax_unloaded():
    code = ("import sys, pinot_tpu_torch.engine.executor, "
            "pinot_tpu_torch.tools.ssb, pinot_tpu_torch.engine.fused_scan, "
            "pinot_tpu_torch.engine.kernels, pinot_tpu_torch.utils.hll, "
            "pinot_tpu_torch.tools.scan_profile, "
            "pinot_tpu_torch.engine.pruner, pinot_tpu_torch.utils.partition, "
            "pinot_tpu_torch.segment.textindex, "
            "pinot_tpu_torch.segment.jsonindex, "
            "pinot_tpu_torch.segment.fstindex, "
            "pinot_tpu_torch.engine.index_exec, "
            "pinot_tpu_torch.parallel.combine, "
            "pinot_tpu_torch.spi.table, pinot_tpu_torch.utils.bloom, "
            "pinot_tpu_torch.segment.startree, "
            "pinot_tpu_torch.engine.startree_exec, "
            "pinot_tpu_torch.engine.startree_device, "
            "pinot_tpu_torch.engine.residency, "
            "pinot_tpu_torch.common.singleflight, "
            "pinot_tpu_torch.spi.config, "
            "pinot_tpu_torch.parallel.launcher, "
            "pinot_tpu_torch.parallel.executor, "
            "pinot_tpu_torch.segment.mutable, "
            "pinot_tpu_torch.segment.upsert, "
            "pinot_tpu_torch.engine.mutable_staging, "
            "pinot_tpu_torch.ingestion, pinot_tpu_torch.ingestion.stream, "
            "pinot_tpu_torch.ingestion.transformers, "
            "pinot_tpu_torch.ingestion.realtime, "
            "pinot_tpu_torch.server.admission, "
            "pinot_tpu_torch.server.scheduler, "
            "pinot_tpu_torch.common.datatable, "
            "pinot_tpu_torch.common.bounds, "
            "pinot_tpu_torch.broker.reduce, "
            "pinot_tpu_torch.parallel.reduce_device, "
            "pinot_tpu_torch.controller.state, "
            "pinot_tpu_torch.controller.assignment, "
            "pinot_tpu_torch.controller.controller, "
            "pinot_tpu_torch.server.data_manager, "
            "pinot_tpu_torch.server.server, "
            "pinot_tpu_torch.broker.quota, "
            "pinot_tpu_torch.broker.routing, "
            "pinot_tpu_torch.broker.gapfill, "
            "pinot_tpu_torch.broker.broker, "
            "pinot_tpu_torch.common.response, "
            "pinot_tpu_torch.spi.metrics, "
            "pinot_tpu_torch.spi.filesystem, "
            "pinot_tpu_torch.query.explain, "
            "pinot_tpu_torch.tools.cluster; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pinot_tpu', 'triton')]; "
            "from pinot_tpu_torch.engine import _build, kernels; "
            "bad += ['built: ' + k for k in _build.BUILD_LOGS]; "
            "bad += ['launched'] * kernels.RUNG_COUNTER.launches; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _tiny_segment():
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema

    rng = np.random.default_rng(1)
    n = 5000
    schema = Schema("tiny", [FieldSpec("k", DataType.STRING),
                             FieldSpec("v", DataType.INT, FieldType.METRIC)])
    frame = {"k": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
             "v": rng.integers(0, 100, n)}
    return SegmentBuilder(schema, "tiny_0").build(frame), frame


def test_default_device_raises_without_a_card():
    from pinot_tpu_torch.device import resolve_device
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.staging import StagedSegment

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ServerQueryExecutor()
    with pytest.raises(RuntimeError, match="cuda"):
        StagedSegment(_tiny_segment()[0])
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()


def test_residency_entry_points_raise_without_a_card():
    from pinot_tpu_torch.engine.residency import ResidencyManager
    from pinot_tpu_torch.parallel import ShardedQueryExecutor

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ResidencyManager()
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedQueryExecutor(hbm_budget_bytes=1 << 30)


def test_consuming_segment_entry_points_raise_without_a_card():
    """A consuming segment's staging and the executors serving it default
    to the card and raise without one; ``device="cpu"`` runs them."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.engine.mutable_staging import StagedMutableSegment
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.segment.mutable import MutableSegment
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    seg = MutableSegment(Schema("m", [FieldSpec("k", DataType.STRING),
                                      FieldSpec("v", DataType.INT,
                                                FieldType.METRIC)]), "m_0")
    for i in range(10):
        seg.index({"k": "ab"[i % 2], "v": i})
    with pytest.raises(RuntimeError, match="cuda"):
        StagedMutableSegment(seg)
    for make in (ServerQueryExecutor, ShardedQueryExecutor):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    staged = StagedMutableSegment(seg, device="cpu")
    assert staged.snapshot().wm == 10
    for make in (ServerQueryExecutor, ShardedQueryExecutor):
        table, stats = make(device="cpu").execute(
            compile_query("SELECT k, sum(v) FROM m GROUP BY k ORDER BY k"),
            [seg])
        assert table.rows == [["a", 20.0], ["b", 25.0]]
        assert stats.group_by_rung == "mutable_device"


def test_cpu_device_runs_plain_path():
    from pinot_tpu_torch.engine import fused_scan
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query

    seg, frame = _tiny_segment()
    before = (fused_scan.SCAN_COUNTER.launches,
              fused_scan.PROBE_COUNTER.launches)
    table, stats = ServerQueryExecutor(device="cpu").execute(
        compile_query("SELECT k, sum(v), count(*) FROM tiny "
                      "WHERE v >= 50 GROUP BY k ORDER BY k"), [seg])
    m = frame["v"] >= 50
    want = [[k, float(frame["v"][m & (frame["k"] == k)].sum()),
             int((m & (frame["k"] == k)).sum())] for k in ("a", "b", "c")]
    assert table.rows == want
    assert stats.num_docs_scanned == int(m.sum())
    # the plain version is not a kernel launch
    assert (fused_scan.SCAN_COUNTER.launches,
            fused_scan.PROBE_COUNTER.launches) == before


def test_cpu_wrapper_rejects_mismatched_inputs():
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.engine.staging import StagedSegment
    from pinot_tpu_torch.query import compile_query

    seg, _ = _tiny_segment()
    staged = StagedSegment(seg, device="cpu")
    plan = plan_segment(compile_query("SELECT sum(v) FROM tiny WHERE k = 'a'"),
                        seg)
    pp = fs.extract_plan(plan, seg)
    words = [staged.packed_column(c).words.unsqueeze(0)
             for c in pp.packed_names]
    values = [staged.value_column(c).unsqueeze(0) for c in pp.value_names]
    prog = fs.compile_program(pp, (2,))
    num_docs = staged.num_docs_tensor()
    assert fs.fused_scan(prog, words, values, num_docs).matched.shape == (1,)
    with pytest.raises(ValueError):
        fs.fused_scan(prog, words, [values[0].to(torch.float32)], num_docs)
    # num_docs is an int64 [S] tensor: not an int, not [2], not int32
    for bad in (seg.num_docs, num_docs.repeat(2), num_docs.to(torch.int32)):
        with pytest.raises(ValueError):
            fs.fused_scan(prog, words, values, bad)


@pytest.mark.parametrize("sql", [
    "SELECT k, sum(v) FROM tiny GROUP BY k HAVING",
    "SELECT sum(v) FROM tiny WHERE k IS NOT 'a'",
    "SELECT sum(v) FROM tiny WHERE k NOT = 'a'",
    "SELECT CASE WHEN v > 1 THEN 1 ELSE 0 END, count(*) FROM tiny",
    "SELECT sum(v) FROM tiny LIMIT 5 OFFSET",
])
def test_unsupported_sql_raises_typed_error(sql):
    from pinot_tpu_torch.query import SqlParseError, compile_query

    with pytest.raises(SqlParseError):
        compile_query(sql)


@pytest.mark.parametrize("sql", ["SELECT DISTINCT k FROM tiny",
                                 "SELECT k FROM tiny"])
def test_selection_and_distinct_sql_are_served(sql):
    """DISTINCT and selection (refused until the host engine was ported)
    parse and are served on the CPU by the host engine, with no kernel."""
    from pinot_tpu_torch.engine import fused_scan
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query

    seg, frame = _tiny_segment()
    ctx = compile_query(sql)
    assert ctx.distinct == sql.startswith("SELECT DISTINCT")
    assert ctx.is_selection != ctx.distinct
    before = fused_scan.SCAN_COUNTER.launches
    table, stats = ServerQueryExecutor(device="cpu").execute(ctx, [seg])
    ks = frame["k"].tolist()
    want = ([[k] for k in dict.fromkeys(ks)] if ctx.distinct
            else [[k] for k in ks[:10]])
    assert table.rows == want
    assert table.schema.column_types == ["STRING"]
    assert fused_scan.SCAN_COUNTER.launches == before


def test_arithmetic_null_tests_and_transforms_parse():
    """``/``, ``%``, IS [NOT] NULL and transform calls parse as the JAX
    parser parses them; the planner refuses what it cannot compile."""
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.query.expressions import PredicateType

    ctx = compile_query("SELECT sum(v / 2), sum(v % 3) FROM tiny "
                        "WHERE k IS NOT NULL")
    assert [str(f) for f in ctx.aggregations] == [
        "sum(divide(v,2))", "sum(mod(v,3))"]
    assert ctx.filter.predicate.type is PredicateType.IS_NOT_NULL
    ctx = compile_query("SELECT upper(k), count(*) FROM tiny "
                        "GROUP BY upper(k)")
    assert str(ctx.group_by[0]) == "upper(k)"
