"""The combine mesh on 8 CPU cells against the port's one cell and the JAX
mesh on the 8 virtual devices of ``tests/conftest.py``.

Oracle: ``tests/test_mesh_combine.py``. The port's
``ShardedQueryExecutor(mesh=make_combine_mesh(["cpu"] * 8))`` (8x1) and
``make_combine_mesh(["cpu"] * 8, doc_shards=2)`` (4x2), with the fused
scan on and off, answer the 13 SSB flights on JAX-built segments carried
across like the port's 1x1 executor and like JAX's
``ShardedQueryExecutor`` on the same mesh shapes (:64, :81): counts,
integer sums, min/max and keys exact; float cells within rel 1e-9 of the
port's own 1x1 and within rel 1e-5, abs 1e-6 of JAX's. The stats (docs
scanned, segments processed and matched, the group-by rung) equal the
1x1's, and one query is one launch on every shape (:94). The slice
planner pads to the ``seg`` axis (:106), and a budget-sliced query on 8x1
equals the uncapped one (:131). Also: the query axis over a 4x2 mesh
(one launch a cell, folded per program), the jnp combine dense and
sparse (a hash table that overflows reruns every cell on the sort body),
a capacity the ``doc`` axis does not divide (JAX's
``capacity_mesh_mismatch``), the staged bytes of a 1x1 mesh equal to
today's single cell, and the host tier per cell. On the CPU every cell
runs the kernels' plain versions.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.parallel import make_combine_mesh as j_mesh  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine import fused_scan as t_fs  # noqa: E402
from pinot_tpu_torch.engine import kernels as t_kernels  # noqa: E402
from pinot_tpu_torch.engine.residency import (  # noqa: E402
    ResidencyManager,
    estimate_segment_bytes,
)
from pinot_tpu_torch.parallel import (  # noqa: E402
    DOC_AXIS,
    SEG_AXIS,
    MeshStagedBatch,
    ShardedQueryExecutor,
    StagedBatch,
    make_combine_mesh,
)
from pinot_tpu_torch.parallel import combine as t_combine  # noqa: E402
from pinot_tpu_torch.parallel.mesh import Cells, fold_partials  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.tools import ssb as t_ssb  # noqa: E402

from tests.test_torch_executor import carry  # noqa: E402
from tests.test_torch_general_rung import _hash_frame  # noqa: E402

pytestmark = pytest.mark.cluster_routing

SHAPES = {"8x1": 1, "4x2": 2}
MODES = {"fused": True, "jnp": False}
QIDS = sorted(j_ssb.QUERIES)
STATS = ("num_docs_scanned", "num_segments_processed",
         "num_segments_matched", "num_segments_pruned", "total_docs",
         "group_by_rung")


def _port_mesh(doc_shards, **kw):
    return ShardedQueryExecutor(
        mesh=make_combine_mesh(["cpu"] * 8, doc_shards=doc_shards), **kw)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """4 SSB segments (star_tree off: every flight on the batch) and the
    2 wide segments of tests/test_torch_jnp_combine.py (a ~2^17 key
    space), JAX-built and carried across."""
    from pinot_tpu.segment import SegmentBuilder, load_segment
    from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema

    ssb = j_ssb.build_segments(0, str(tmp_path_factory.mktemp("mesh_ssb")),
                               num_segments=4, rows=10_000, star_tree=False,
                               workers=1)
    wide_schema = Schema("wide", [
        FieldSpec("a", DataType.STRING), FieldSpec("b", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    out = tmp_path_factory.mktemp("mesh_wide")
    frame = _hash_frame(77, False)
    wide = []
    for i in range(2):
        SegmentBuilder(wide_schema, f"w{i}").build(frame, str(out))
        wide.append(load_segment(str(out / f"w{i}")))
    return {"ssb": (ssb, carry(ssb, "ssb_lineorder")),
            "wide": (wide, carry(wide, "wide"))}


@pytest.fixture(scope="module")
def ports():
    """(shape, mode) -> the port's executor; "1x1" is one CPU cell."""
    out = {}
    for mode, fused in MODES.items():
        out[("1x1", mode)] = ShardedQueryExecutor(device="cpu",
                                                  use_fused_scan=fused)
        for shape, d in SHAPES.items():
            out[(shape, mode)] = _port_mesh(d, use_fused_scan=fused)
    return out


@pytest.fixture(scope="module")
def jaxes(eight_devices):
    return {shape: JSharded(mesh=j_mesh(devices=eight_devices,
                                        doc_shards=d))
            for shape, d in SHAPES.items()}


def _exact(rows):
    return [not isinstance(c, float) for c in (rows[0] if rows else [])]


def _rows_close(got, want, rel, abs_, what):
    assert len(got) == len(want), what
    for gr, wr in zip(got, want):
        for g, w, ex in zip(gr, wr, _exact([wr])):
            if ex:
                assert g == w and type(g) is type(w), (what, gr, wr)
            else:
                assert g == pytest.approx(w, rel=rel, abs=abs_), (what, gr,
                                                                  wr)


def _stats(st):
    return tuple(getattr(st, k) for k in STATS)


# -- the mesh itself ------------------------------------------------------------

def test_make_combine_mesh_shapes():
    m = make_combine_mesh(["cpu"] * 8, doc_shards=2)
    assert (m.shape[SEG_AXIS], m.shape[DOC_AXIS], m.size) == (4, 2, 8)
    assert m.root == torch.device("cpu") and m.devices == (m.root,)
    assert make_combine_mesh(["cpu"] * 8).shape == {SEG_AXIS: 8,
                                                    DOC_AXIS: 1}
    with pytest.raises(ValueError):
        make_combine_mesh(["cpu"] * 8, doc_shards=3)


def test_make_combine_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh is valid")
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_combine_mesh()
    with pytest.raises(RuntimeError):
        make_combine_mesh(["cpu", "cuda:0"])
    with pytest.raises(RuntimeError):
        ShardedQueryExecutor(mesh=None, device="cuda", doc_shards=2)


def test_cells_keep_their_shape():
    m = make_combine_mesh(["cpu"] * 4, doc_shards=2)
    c = Cells(m, [torch.zeros(1, 3, 5, dtype=torch.int32)] * 4, (2, 6, 5))
    assert c.reshape(2, -1, 5) is c and len(c) == 4
    with pytest.raises(ValueError):
        c.reshape(4, -1, 5)
    parts = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0])]
    assert fold_partials(parts, "sum", m.root).tolist() == [4.0, 7.0]
    assert fold_partials(parts, "min", m.root).tolist() == [1.0, 2.0]
    assert fold_partials(parts, "max", m.root).tolist() == [3.0, 5.0]
    assert fold_partials(parts, "cat", m.root).tolist() == [1.0, 5.0, 3.0,
                                                            2.0]


# -- the SSB flights ---------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("qid", QIDS)
def test_ssb_flights(data, ports, jaxes, qid, shape, mode):
    jsegs, tsegs = data["ssb"]
    sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
    got, st = ports[(shape, mode)].execute(t_compile(sql), tsegs)
    one, st1 = ports[("1x1", mode)].execute(t_compile(sql), tsegs)
    want, jst = jaxes[shape].execute(j_compile(sql), jsegs)
    assert got.schema.column_names == want.schema.column_names
    _rows_close(got.rows, one.rows, 1e-9, 0.0, f"1x1 {qid}")
    _rows_close(got.rows, want.rows, 1e-5, 1e-6, f"jax {qid}")
    assert _stats(st) == _stats(st1)
    assert (st.num_docs_scanned, st.num_segments_processed,
            st.num_segments_pruned) == (jst.num_docs_scanned,
                                        jst.num_segments_processed,
                                        jst.num_segments_pruned)
    assert st.num_segments_processed + st.num_segments_pruned == 4


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decisions_equal_across_shapes(data, mode):
    """Fresh executors of each shape record the same decisions as the 1x1
    when they first bind each flight."""
    _, tsegs = data["ssb"]
    exs = {"1x1": ShardedQueryExecutor(device="cpu",
                                       use_fused_scan=MODES[mode])}
    for shape, d in SHAPES.items():
        exs[shape] = _port_mesh(d, use_fused_scan=MODES[mode])
    for qid in QIDS:
        sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
        seen = {shape: ex.execute(t_compile(sql), tsegs)[1].decisions
                for shape, ex in exs.items()}
        assert seen["8x1"] == seen["4x2"] == seen["1x1"], (qid, seen)


def test_launch_stats_across_mesh_shapes(data, ports):
    """One query is one launch on every shape (tests/test_mesh_combine.py
    :94), and its repeat hits both query caches."""
    _, tsegs = data["ssb"]
    sql = j_ssb.QUERIES["Q1.1"] + " LIMIT 100000"
    for shape in ("1x1", *SHAPES):
        ex = ports[(shape, "fused")]
        for _ in range(2):
            _, stats = ex.execute(t_compile(sql), tsegs)
            assert stats.launch["launches"] == 1, shape
            assert stats.launch["batchSize"] >= 1
            assert stats.launch["queueWaitMs"] >= 0
        assert all(k[-1] == ex.mesh.key for k in ex._param_cache)
        assert all(k[-3] == ex.mesh.key for k in ex._launch_cache)


def test_staging_per_shape(data):
    """A 1x1 mesh stages a ``StagedBatch`` with today's bytes; a mesh
    stages a ``MeshStagedBatch`` whose bytes sum its cells' and which the
    residency manager accounts as one resident."""
    _, tsegs = data["ssb"]
    sql = j_ssb.QUERIES["Q2.1"] + " LIMIT 100000"
    today = ShardedQueryExecutor(device="cpu")
    one = ShardedQueryExecutor(mesh=make_combine_mesh(["cpu"]))
    mesh = _port_mesh(2)
    for ex in (today, one, mesh):
        ex.execute(t_compile(sql), tsegs)
    st_today, st_one = today.batch_for(tsegs)[1], one.batch_for(tsegs)[1]
    st_mesh = mesh.batch_for(tsegs)[1]
    assert type(st_today) is StagedBatch and type(st_one) is StagedBatch
    assert st_one.nbytes() == st_today.nbytes()
    assert st_one.num_segs == st_today.num_segs == 4
    assert isinstance(st_mesh, MeshStagedBatch) and st_mesh.num_segs == 4
    cells = 0
    for pc in st_mesh._packed.values():
        assert isinstance(pc.words, Cells) and len(pc.words) == 8
        assert pc.words.shape[1] == st_mesh.tiles
        assert all(b.shape == (1, st_mesh.tiles // 2, pc.words.shape[2])
                   for b in pc.words)
        cells += pc.words.nbytes()
    cells += sum(v.nbytes() for v in st_mesh._values.values())
    cells += st_mesh.num_docs_tensor().nbytes()
    assert st_mesh.nbytes() == cells
    name = mesh.batch_for(tsegs)[0].segment_name
    assert mesh.residency.resident_nbytes(name) == st_mesh.nbytes()
    assert one.launcher is today.launcher
    assert mesh.launcher is not today.launcher


def test_fused_cells_clamp_num_docs(data):
    """Each cell's ``num_docs`` is its segments' docs in its tile block."""
    _, tsegs = data["ssb"]
    mesh = _port_mesh(2)
    batch, staged = mesh.batch_for(tsegs)
    span = staged.tiles // 2 * t_fs.TILE
    nd = batch.num_docs_array(4)
    got = [b.tolist() for b in staged.num_docs_tensor()]
    for c, row in enumerate(got):
        si, di = divmod(c, 2)
        assert row == [int(np.clip(nd[si] - di * span, 0, span))]
    assert [b.tolist() for b in staged.combine_num_docs()] == \
        [[int(nd[c // 2])] for c in range(8)]


# -- slices ------------------------------------------------------------------------

def test_slice_planner_pads_to_the_seg_axis(data, monkeypatch):
    _, tsegs = data["ssb"]
    cols = ["lo_extendedprice", "lo_discount", "d_year", "lo_quantity"]
    est = estimate_segment_bytes(tsegs[0], cols)
    rm = ResidencyManager(budget_bytes=int(3 * est), device="cpu")
    assert rm.plan_slices(tsegs, cols, pad_to=8) is None
    slices = rm.plan_slices(tsegs, cols, pad_to=1)
    assert slices is not None and len(slices) >= 2
    # the executor pads to its own mesh's seg axis (Q4.1 keeps every
    # segment)
    sql = j_ssb.QUERIES["Q4.1"] + " LIMIT 100000"
    est = estimate_segment_bytes(tsegs[0],
                                 t_compile(sql).referenced_columns())
    for ex, n_seg in ((_port_mesh(1, hbm_budget_bytes=int(3 * est)), 8),
                      (_port_mesh(2, hbm_budget_bytes=int(3 * est)), 4)):
        seen = []
        real = ex.residency.plan_slices

        def spy(*a, _real=real, **k):
            seen.append(k.get("pad_to"))
            return _real(*a, **k)

        monkeypatch.setattr(ex.residency, "plan_slices", spy)
        got, stats = ex.execute(t_compile(sql), tsegs)
        want, _ = ShardedQueryExecutor(device="cpu").execute(
            t_compile(sql), tsegs)
        assert got.rows == want.rows
        assert seen == [n_seg]


def test_sliced_query_on_8x1_equals_uncapped(data):
    _, tsegs = data["ssb"]
    sql = j_ssb.QUERIES["Q4.1"] + " LIMIT 100000"
    want, _ = _port_mesh(1).execute(t_compile(sql), tsegs)
    cols = t_compile(sql).referenced_columns()
    ws = sum(estimate_segment_bytes(s, cols) for s in tsegs)
    capped = _port_mesh(1, hbm_budget_bytes=max(int(ws * 0.6), 1))
    for _ in range(2):
        got, stats = capped.execute(t_compile(sql), tsegs)
        assert got.rows == want.rows
        assert stats.staging.get("spills", 0) == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_tier_per_cell(data, mode):
    """A 4x2 executor under a budget slices the query, demotes each
    slice's batch to the host image at the slice's end and promotes it
    back, block by block, on the next pass; the answers stay the same."""
    _, tsegs = data["ssb"]
    sql = j_ssb.QUERIES["Q3.1"] + " LIMIT 100000"
    want, _ = _port_mesh(2, use_fused_scan=MODES[mode]).execute(
        t_compile(sql), tsegs)
    cols = t_compile(sql).referenced_columns()
    ws = sum(estimate_segment_bytes(s, cols) for s in tsegs)
    capped = _port_mesh(2, use_fused_scan=MODES[mode],
                        hbm_budget_bytes=max(int(ws * 0.6), 1))
    for _ in range(3):
        got, stats = capped.execute(t_compile(sql), tsegs)
        assert got.rows == want.rows
    snap = capped.residency.stats_snapshot()
    assert snap["demotions"] > 0 and snap["promotions"] > 0, snap


# -- the query axis over a 4x2 mesh ------------------------------------------------------

def test_query_axis_on_4x2(data):
    """C1-C8 bind to one launch key on a 4x2 mesh; the query axis over
    the cells equals each program's solo scan and the 1x1 batch's query
    axis, program by program; 8 concurrent clients answer as 1x1."""
    _, tsegs = data["ssb"]
    mesh, one = _port_mesh(2), ShardedQueryExecutor(device="cpu")
    sqls = list(t_ssb.COALESCE_QUERIES.values())
    for ex in (mesh, one):
        for sql in sqls:
            ex.execute(t_compile(sql), tsegs)

    def bound(ex):
        return [next(v for k, v in ex._param_cache.items() if k[0] == sql)
                for sql in sqls]

    mb, ob = bound(mesh), bound(one)
    assert len({b.launch_key for b in mb}) == 1
    inp = mb[0].inputs
    assert isinstance(inp.num_docs, Cells)
    progs = [b.params for b in mb]
    many = t_combine.sharded_fused_scan_many(progs, inp.words, inp.values,
                                             inp.num_docs, inp.tiles)
    plain = t_combine.sharded_fused_scan_many_plain(
        progs, inp.words, inp.values, inp.num_docs, inp.tiles)
    oinp = ob[0].inputs
    one_many = t_combine.sharded_fused_scan_many(
        [b.params for b in ob], oinp.words, oinp.values, oinp.num_docs,
        oinp.tiles)
    for b, m, p, o in zip(mb, many, plain, one_many):
        solo = t_combine.sharded_fused_scan(b.params, inp.words, inp.values,
                                            inp.num_docs, inp.tiles)
        for out in (p, o, solo):
            assert torch.equal(m.buf, out.buf)
    # concurrent clients through the mesh's dispatcher
    want = {sql: one.execute(t_compile(sql), tsegs)[0].rows for sql in sqls}
    got, errs = {}, []

    def client(sql):
        try:
            got[sql] = mesh.execute(t_compile(sql), tsegs)[0].rows
        except Exception as e:  # noqa: BLE001 - to the assertion
            errs.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in sqls]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and got == want


def test_probe_folds_over_the_mesh(data):
    """Q3.2 / Q4.3 narrow their key space with the probe: over the mesh
    the probe's min/max rows fold across the cells."""
    _, tsegs = data["ssb"]
    for qid in ("Q3.2", "Q4.3"):
        sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
        mesh = _port_mesh(2)
        got, _ = mesh.execute(t_compile(sql), tsegs)
        b = next(v for k, v in mesh._param_cache.items() if k[0] == sql)
        assert b.probe is not None
        prog, words = b.probe
        nd = b.inputs.num_docs
        folded = t_combine.sharded_fused_scan_probe(prog, words, nd)
        plain = t_combine.sharded_fused_scan_plain(prog, words, [], nd)
        assert torch.equal(folded.buf, plain.buf)
        want, _ = ShardedQueryExecutor(device="cpu").execute(
            t_compile(sql), tsegs)
        _rows_close(got.rows, want.rows, 1e-9, 0.0, qid)


# -- the jnp combine ----------------------------------------------------------------------

WIDE_SQL = ("SELECT a, b, year, sum(v), count(*), min(v), max(v), avg(v) "
            "FROM wide WHERE v < 30 "
            "GROUP BY a, b, year ORDER BY a, b, year LIMIT 15000")


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sparse_compacts_over_the_mesh(data, jaxes, shape):
    jsegs, tsegs = data["wide"]
    from pinot_tpu_torch.engine.plan import plan_segment

    assert t_kernels.sparse_mode(
        plan_segment(t_compile(WIDE_SQL), tsegs[0]).spec) > 0
    got, st = _port_mesh(SHAPES[shape], use_fused_scan=False).execute(
        t_compile(WIDE_SQL), tsegs)
    one, st1 = ShardedQueryExecutor(device="cpu",
                                    use_fused_scan=False).execute(
        t_compile(WIDE_SQL), tsegs)
    want, _ = jaxes[shape].execute(j_compile(WIDE_SQL), jsegs)
    _rows_close(got.rows, one.rows, 1e-9, 0.0, shape)
    _rows_close(got.rows, want.rows, 1e-5, 1e-6, shape)
    assert st.group_by_rung == st1.group_by_rung
    assert st.group_by_rung in ("hash", "sort")
    assert st.batch_general_launches == 1


def test_hash_overflow_reruns_every_cell_on_sort(data, monkeypatch):
    from pinot_tpu.engine import kernels as jk

    monkeypatch.setattr(jk, "HASH_LIVE_DOCS", 64)
    monkeypatch.setattr(t_kernels, "HASH_LIVE_DOCS", 64)
    calls = []
    real = t_kernels.build_kernel_body

    def spy(spec, *a, **k):
        calls.append(k.get("sparse_rung"))
        return real(spec, *a, **k)

    monkeypatch.setattr(t_kernels, "build_kernel_body", spy)
    jsegs, tsegs = data["wide"]
    got, st = _port_mesh(2, use_fused_scan=False).execute(
        t_compile(WIDE_SQL), tsegs)
    assert st.group_by_rung == "sort"
    assert calls == ["hash", "sort"]
    want, _ = JSharded(use_pallas=False).execute(j_compile(WIDE_SQL), jsegs)
    _rows_close(got.rows, want.rows, 1e-5, 1e-6, "hash->sort")


def test_capacity_the_doc_axis_does_not_divide(data, eight_devices):
    """A jnp combine over 7 doc cells of a 3072-doc capacity leaves the
    batch with JAX's code; the per-segment path answers."""
    jsegs, tsegs = data["ssb"]
    sql = j_ssb.QUERIES["Q2.1"] + " LIMIT 100000"
    code = ("sharded_combine:sharded_combine->per_segment:"
            "capacity_mesh_mismatch")
    assert tsegs[0].padded_capacity % 7
    ex = ShardedQueryExecutor(mesh=make_combine_mesh(["cpu"] * 7,
                                                     doc_shards=7),
                              use_fused_scan=False)
    got, st = ex.execute(t_compile(sql), tsegs)
    assert st.decisions.get(code) == 1
    jex = JSharded(mesh=j_mesh(devices=eight_devices[:7], doc_shards=7))
    want, jst = jex.execute(j_compile(sql), jsegs)
    assert jst.decisions.get(code) == 1
    _rows_close(got.rows, want.rows, 1e-5, 1e-6, "7 doc cells")
    # the fused scan pads its tiles to the doc axis instead
    fgot, fst = ShardedQueryExecutor(
        mesh=make_combine_mesh(["cpu"] * 7, doc_shards=7)).execute(
        t_compile(sql), tsegs)
    assert code not in fst.decisions
    _rows_close(fgot.rows, want.rows, 1e-5, 1e-6, "7 doc cells, fused")


def test_mesh_jax_reference_shape(eight_devices):
    """JAX's mesh shapes the cases above are held to."""
    for shape, d in SHAPES.items():
        m = j_mesh(devices=eight_devices, doc_shards=d)
        assert f"{m.shape['seg']}x{m.shape['doc']}" == shape
    assert len(jax.devices()) == 8


def test_a_failed_cell_launch_raises_in_the_query(data, monkeypatch):
    """No fallback: one cell's scan failing fails the query."""
    _, tsegs = data["ssb"]
    ex = _port_mesh(2)
    calls = []
    real = t_combine.counted_scan

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("synthetic cell failure")
        return real(*a, **k)

    monkeypatch.setattr(t_combine, "counted_scan", flaky)
    with pytest.raises(RuntimeError, match="synthetic cell failure"):
        ex.execute(t_compile(j_ssb.QUERIES["Q2.1"] + " LIMIT 100000"),
                   tsegs)


def test_chip_smoke_phase_23_small():
    """chip_smoke's phase 23 on CPU cells at a small size: every mesh's
    flights == the 1x1's == the numpy oracle, the query axis and a sliced
    flight on 4x2, the broker's merge over 4 cells on each rung."""
    import chip_smoke
    from pinot_tpu_torch.engine.pruner import prune_segments

    segs, frames = t_ssb.build_segments(0, num_segments=8, rows=48_000)
    ctxs = {q: t_compile(s + " LIMIT 100000")
            for q, s in t_ssb.QUERIES.items()}
    kept_segs = {q: prune_segments(ctx, segs) for q, ctx in ctxs.items()}
    texts = {**t_ssb.COALESCE_QUERIES, **t_ssb.PROBE_QUERIES}
    main = {"segs": segs, "ctxs": ctxs, "kept_segs": kept_segs,
            "kept": {q: len(v) for q, v in kept_segs.items()},
            "wants": {q: t_ssb.merge_answers(
                [t_ssb.numpy_answer(f, q) for f in frames])
                for q in t_ssb.QUERIES},
            "variant_texts": texts,
            "variant_wants": {v: t_ssb.merge_answers(
                [t_ssb.numpy_answer(f, v) for f in frames]) for v in texts}}
    errs = {"sharded_fused_scan": 0.0, "sharded_fused_scan_probe": 0.0}
    out = chip_smoke.phase_mesh(
        main, ShardedQueryExecutor(device="cpu"), 1, errs, device="cpu",
        merges=(("dense", 3000, 300), ("slices", 6000, 9000),
                ("sort", 6000, 1 << 40)))
    assert set(out["shapes"]) == {"1x1", "8x1", "4x2", "2x2"}
    assert out["sliced"]["slices"] >= 2
    assert set(out["merge"]) == {"dense", "slices", "sort"}
