"""The fused scan's query axis (``fused_scan_many_kernel`` in
``pinot_tpu_torch/engine/csrc/fused_scan.cu``): its host side and its
plain version against the JAX package.

The host side: ``query_group`` (up to ``QG`` programs a block, the groups
on grid y), ``scan_layout_many`` (shared memory against the group size,
the shared / device-memory accumulator decision at each side of its
budget) and ``prepare_launch_many``'s argv, built on CPU tensors (no
launch here: the kernel runs on the card, in ``chip_smoke.py`` phases 3c
and 13b).

The port against the JAX package: the same numpy-built segments go
through the JAX ``ShardedQueryExecutor(use_pallas=True)``, whose launch
kernel's ``run_many`` (``pinot_tpu/parallel/launcher.py``) runs the Pallas
kernel in interpret mode under ``jax.vmap`` over Q literal variants, and
through the port's ``sharded_fused_scan_many`` /
``sharded_fused_scan_probe_many`` on the CPU (their plain version). Each
query's decoded rows (group keys and aggregation states) are compared:
counts, integer sums and keys exact; floats rel 1e-5, abs 1e-6 (the JAX
kernel sums floats as f32 pairs, the port in f64). The probe's decoded
dictId ranges are compared exactly.
"""

import numpy as np
import pytest

from pinot_tpu.engine.executor import decode_grouped_result as j_grouped
from pinot_tpu.engine.executor import decode_scalar_result as j_scalar
from pinot_tpu.engine.kernels import unpack_outputs
from pinot_tpu.engine.pallas_kernels import decode_probe_ranges as j_ranges
from pinot_tpu.engine.pallas_kernels import extract_plan as j_extract
from pinot_tpu.engine.pallas_kernels import probe_plan_of as j_probe_plan
from pinot_tpu.engine.plan import plan_segment as j_plan
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded
from pinot_tpu.parallel.combine import SEG_AXIS, pad_segments
from pinot_tpu.query import compile_query as j_compile
from pinot_tpu.segment import SegmentBuilder, load_segment
from pinot_tpu.spi import DataType, FieldSpec, FieldType, IndexingConfig, Schema
from pinot_tpu_torch.engine import fused_scan as fs
from pinot_tpu_torch.engine.executor import (
    decode_grouped_result,
    decode_scalar_result,
)
from pinot_tpu_torch.engine.plan import plan_segment as t_plan
from pinot_tpu_torch.parallel import ShardedQueryExecutor
from pinot_tpu_torch.parallel.combine import (
    sharded_fused_scan_many,
    sharded_fused_scan_probe_many,
)
from pinot_tpu_torch.engine.staging import pack_planar
from pinot_tpu_torch.query import compile_query as t_compile
from pinot_tpu_torch.segment import columns_of, segment_from_arrays

NUM_SEGMENTS = 4
DOCS = 1024


def _schema():
    return Schema("sales", [
        FieldSpec("region", DataType.STRING),
        FieldSpec("kind", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("item", DataType.INT),
        FieldSpec("ts", DataType.INT),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("raw_amt", DataType.LONG, FieldType.METRIC),
    ])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """4 segments of 1024 docs built by the JAX SegmentBuilder, carried to
    the port with ``columns_of``. ``item`` (1024 values, each segment's
    docs in order) by ``year`` is a group space past the fused scan's 8192
    groups, which a filter on ``ts`` (ten times the doc's place in its
    segment) narrows through the probe; every segment holds every value
    of both, so no filter of the tests prunes a segment."""
    rng = np.random.default_rng(29)
    out = tmp_path_factory.mktemp("torch_query_axis_segs")
    regions = ["east", "west", "north", "south"]
    kinds = ["a", "b", "c"]
    jsegs = []
    for i in range(NUM_SEGMENTS):
        doc = np.arange(DOCS)
        frame = {
            "region": [regions[j] for j in rng.integers(0, 4, DOCS)],
            "kind": [kinds[j] for j in rng.integers(0, 3, DOCS)],
            "year": rng.integers(2015, 2024, DOCS).astype(np.int64).tolist(),
            "item": doc.astype(np.int64).tolist(),
            "ts": (10 * doc).astype(np.int64).tolist(),
            "qty": rng.integers(1, 50, DOCS).astype(np.int64).tolist(),
            "price": np.round(rng.normal(100, 25, DOCS), 2).tolist(),
            "raw_amt": (rng.integers(0, 10_000, DOCS)
                        + (1 << 33)).astype(np.int64).tolist(),
        }
        SegmentBuilder(
            _schema(), f"sales_{i}",
            indexing_config=IndexingConfig(no_dictionary_columns=["raw_amt"])
        ).build(frame, str(out))
        jsegs.append(load_segment(str(out / f"sales_{i}")))
    tsegs = [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                 table_name="sales") for j in jsegs]
    return jsegs, tsegs


# --------------------------------------------------------------------------
# the host side: group size, layout, argv
# --------------------------------------------------------------------------

def _grouped_plan(G: int, n_isum: int = 1, scalar: bool = False,
                  n_rows: int = 1, n_min: int = 0) -> fs.ScanPlan:
    """A plan with one filter column, grouped by a second into ``G``
    groups (or scalar, with ``n_rows`` int sums and ``n_min`` min rows of
    distinct columns)."""
    if scalar:
        aggs = tuple(("sum", ("v", i), 1) for i in range(n_rows - n_min)) \
            + tuple(("min", ("v", i), None)
                    for i in range(n_rows - n_min, n_rows))
        return fs.ScanPlan(
            packed_names=["f"], value_names=[f"v{i}" for i in range(n_rows)],
            value_is_int=(True,) * n_rows, filter_tree=("iv", 0, 0),
            n_slots=1, group_idx=(), group_strides=(), group_key_offset=0,
            num_groups_padded=fs.G_CHUNK, aggs=aggs,
            static_params=np.array([1, 4], dtype=np.int32))
    aggs = (("count", None, None),) + tuple(
        ("sum", ("v", i), 1) for i in range(n_isum))
    return fs.ScanPlan(
        packed_names=["f", "g"], value_names=[f"v{i}" for i in range(n_isum)],
        value_is_int=(True,) * n_isum, filter_tree=("iv", 0, 0), n_slots=1,
        group_idx=(1,), group_strides=(1,), group_key_offset=0,
        num_groups_padded=G, aggs=aggs,
        static_params=np.array([1, 4], dtype=np.int32))


@pytest.mark.parametrize("q,want", [(1, (1, 1)), (3, (3, 1)), (8, (8, 1)),
                                    (9, (8, 2)), (17, (8, 3))])
def test_query_groups_on_grid_y(q, want):
    """Up to QG = 8 programs a block; grid y is the number of groups."""
    prog = fs.compile_program(_grouped_plan(128), (8, 8))
    assert fs.query_group(prog, q) == want
    with pytest.raises(ValueError):
        fs.query_group(prog, 0)


def test_shared_memory_against_the_group_size():
    """A block's programs, scalar rows and accumulators grow with the
    number of programs it serves; the stacks and the warps' lists do
    not."""
    scalar = fs.compile_program(
        _grouped_plan(0, scalar=True, n_rows=3, n_min=1), (8,))
    grouped = fs.compile_program(_grouped_plan(256, n_isum=2), (8, 8))
    for prog in (scalar, grouped):
        lays = {qg: fs.scan_layout_many(prog, qg) for qg in range(1, 9)}
        for qg, lay in lays.items():
            offs = [lay.prog_off, lay.mstack_off, lay.vstack_off,
                    lay.racc_off, lay.wlist_off, lay.lut_off, lay.acc_off,
                    lay.smem]
            assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
            assert lay.qg == qg
            assert lay.mstack_off - lay.prog_off >= 4 * qg * prog.prog.size
            # filter-stack entries: 16 bytes (the group's four mask words)
            assert lay.vstack_off - lay.mstack_off == (
                16 * 256 * max(prog.filter_depth - 1, 0))
            # list entries: a u16 doc and a u8 of its programs per doc of
            # a tile; then the leaf tables
            assert lay.lut_off - lay.wlist_off == 3 * fs.TILE
            assert lay.lut_bytes == lay.acc_off - lay.lut_off == sum(
                16 << (1 << lb) for lb in fs.lut_leaves(prog, qg))
            if prog.scalar:
                # u64 sum slots, f32 min/max slots
                assert lay.wlist_off - lay.racc_off == (
                    (8 * 2 + 4 * 1) * 256 * qg)
                assert not lay.acc_smem and lay.smem == lay.acc_off
            else:
                per = fs._align16(grouped.G * 8 * (1 + 2))
                assert lay.acc_smem and lay.acc_qstride == per
                assert lay.smem == lay.acc_off + qg * per
        grow = [lays[qg + 1].smem - lays[qg].smem for qg in range(1, 8)]
        assert min(grow) > 0
    # the one-query layout keeps 2-byte stack entries and u16 lists
    one = fs.scan_layout(grouped)
    assert one.acc_off - one.wlist_off == 2 * fs.TILE


def _shared_side(n_isum: int, qg: int):
    """(largest G, multiple of 128, whose ``qg`` accumulator sets fit
    beside two blocks, and the layouts at it and 128 groups above)."""
    budget = fs._SMEM_SM // 2 - fs._SMEM_RESERVED
    G = 128
    while True:
        nxt = fs.compile_program(_grouped_plan(G + 128, n_isum), (8, 16))
        if not fs.scan_layout_many(nxt, qg).acc_smem:
            break
        G += 128
    prog = fs.compile_program(_grouped_plan(G, n_isum), (8, 16))
    return G, budget, fs.scan_layout_many(prog, qg), \
        fs.scan_layout_many(nxt, qg)


@pytest.mark.parametrize("qg", [1, 3, 8])
def test_accumulator_decision_at_each_side_of_its_budget(qg):
    """Grouped accumulators of the block's ``qg`` programs take shared
    memory while they fit beside two blocks on an SM (scan_layout's rule),
    device memory past that."""
    G, budget, inside, outside = _shared_side(1, qg)
    assert inside.acc_smem and inside.smem <= budget
    assert fs._SMEM_SM // (inside.smem + fs._SMEM_RESERVED) >= 2
    assert not outside.acc_smem and outside.acc_qstride == 0
    assert outside.acc_off + qg * fs._align16((G + 128) * 16) > budget
    # more programs a block: fewer groups fit in shared memory
    if qg > 1:
        assert G < _shared_side(1, 1)[0]


def test_group_shrinks_where_eight_programs_do_not_fit():
    """16 scalar rows of 8 programs (256 KB of per-thread slots) do not fit
    in a block: the group shrinks to the most that do."""
    prog = fs.compile_program(_grouped_plan(0, scalar=True, n_rows=16),
                              (8,))
    qg, groups = fs.query_group(prog, 9)
    assert 1 <= qg < 8 and groups == -(-9 // qg)
    assert fs.scan_layout_many(prog, qg).smem <= fs._SMEM_BLOCK_MAX
    assert fs.scan_layout_many(prog, qg + 1).smem > fs._SMEM_BLOCK_MAX
    with pytest.raises(ValueError):
        fs.scan_layout_many(prog, 9)


def _leaf_plan(bits: int, n_runs: int) -> fs.ScanProgram:
    """A scalar count over one leaf of ``bits``-bit dictIds: one interval,
    or an interval set of ``n_runs`` runs (IVS)."""
    tree = ("iv", 0, 0) if n_runs == 1 else ("ivs", 0, 0, n_runs)
    pp = fs.ScanPlan(
        packed_names=["f"], value_names=[], value_is_int=(),
        filter_tree=tree, n_slots=n_runs, group_idx=(), group_strides=(),
        group_key_offset=0, num_groups_padded=fs.G_CHUNK,
        aggs=(("count", None, None),),
        static_params=np.arange(2 * n_runs, dtype=np.int32))
    return fs.compile_program(pp, (bits,))


@pytest.mark.parametrize("bits,n_runs,qg,table", [
    # an 8-bit leaf: SWAR for one or two programs, a table from three
    (8, 1, 1, False), (8, 1, 2, False), (8, 1, 3, True), (8, 1, 8, True),
    # a 4-bit leaf from 6 programs, a 2-bit leaf only at 9 and more
    (4, 1, 5, False), (4, 1, 6, True), (2, 1, 8, False),
    # an interval set of 32 runs takes a table for one program
    (8, 32, 1, True),
    # 1-, 2-, 16- and 32-bit leaves never do
    (1, 32, 8, False), (2, 32, 8, False), (16, 1, 8, False),
    (32, 32, 8, False),
])
def test_leaf_table_decision(bits, n_runs, qg, table):
    """A leaf takes a table of 2^B 16-byte entries where its group's SWAR
    tests would cost more instructions than the table's lookups."""
    prog = _leaf_plan(bits, n_runs)
    want = (16 << bits) if table else 0
    assert fs.lut_leaves(prog, qg) == ([bits.bit_length() - 1] if table
                                       else [])
    assert fs.scan_layout_many(prog, qg).lut_bytes == want


def test_leaf_tables_are_capped():
    """At most 16 KB and 8 tables a block, the leaves taken in order."""
    leaves = tuple(("iv", c, c) for c in range(10))
    pp = fs.ScanPlan(
        packed_names=[f"f{c}" for c in range(10)], value_names=[],
        value_is_int=(), filter_tree=("and", leaves), n_slots=10,
        group_idx=(), group_strides=(), group_key_offset=0,
        num_groups_padded=fs.G_CHUNK, aggs=(("count", None, None),),
        static_params=np.zeros(20, dtype=np.int32))
    eight = fs.compile_program(pp, (8,) * 10)
    four = fs.compile_program(pp, (4,) * 10)
    assert fs.lut_leaves(eight, 8) == [3] * 4
    assert fs.scan_layout_many(eight, 8).lut_bytes == 16 * 1024
    assert fs.lut_leaves(four, 8) == [2] * 8
    assert fs.scan_layout_many(four, 8).lut_bytes == 8 * 256


@pytest.mark.parametrize("lb", [2, 3])
def test_leaf_table_arithmetic(lb):
    """The kernel's table leaf (csrc/fused_scan.cu build_luts, leaf_lut),
    mirrored in numpy: entry d holds, for program q, bit 16 (q & 1) of
    word q >> 1 when d lies in one of q's intervals; thread i's doc
    i + 256 r (word r % NW, field r / NW of its words) ORs its entry in at
    bit r. Each program's 16-bit masks equal the interval test."""
    B, NW = 1 << lb, (1 << lb) // 2
    rng = np.random.default_rng(lb)
    ids = rng.integers(0, 1 << B, fs.TILE)
    words = pack_planar(ids.astype(np.uint64), B).reshape(-1).astype(
        np.uint32)
    nq = 8
    ivs = [[tuple(sorted(rng.integers(-2, (1 << B) + 2, 2).tolist()))
            for _ in range(int(rng.integers(1, 4)))] for _ in range(nq)]
    table = np.zeros(((1 << B), 4), dtype=np.uint32)
    for d in range(1 << B):
        for q in range(nq):
            if any(lo <= d <= hi for lo, hi in ivs[q]):
                table[d, q >> 1] |= np.uint32(1 << (16 * (q & 1)))
    i = np.arange(256)
    w = [words[i + 256 * k] for k in range(NW)]
    m = np.zeros((256, 4), dtype=np.uint32)
    for r in range(16):
        d = (w[r % NW] >> np.uint32((r // NW) * B)) & np.uint32((1 << B) - 1)
        m |= table[d] << np.uint32(r)
    for q in range(nq):
        got = (m[:, q >> 1] >> np.uint32(16 * (q & 1))) & np.uint32(0xFFFF)
        doc = ids[i[:, None] + 256 * np.arange(16)[None, :]]
        ok = np.zeros((256, 16), bool)
        for lo, hi in ivs[q]:
            ok |= (doc >= lo) & (doc <= hi)
        want = (ok << np.arange(16)).sum(axis=1)
        assert np.array_equal(got, want), (q, ivs[q])


def _bound(dev, sql):
    with dev._cache_lock:
        return next(v for k, v in dev._param_cache.items() if k[0] == sql)


def _bind(tsegs, sqls):
    dev = ShardedQueryExecutor(device="cpu")
    for sql in sqls:
        dev.execute(t_compile(sql), tsegs)
    return dev, [_bound(dev, sql) for sql in sqls]


@pytest.mark.parametrize("q", [1, 9])
def test_prepare_launch_many_argv(setup, q):
    """The query axis's argv (CPU tensors: no launch): the programs
    stacked [Q, prog_len], the group size and its layout, each program's
    outputs one row of one buffer; the part that depends only on the
    program, the batch's shape and the group size is built once."""
    _, tsegs = setup
    sqls = [f"SELECT region, sum(qty), count(*) FROM sales "
            f"WHERE year >= {2015 + k % 9} AND qty > {k} GROUP BY region"
            for k in range(q)]
    _, bounds = _bind(tsegs, sqls)
    progs = [b.params for b in bounds]
    inp = bounds[0].inputs
    argv, outs = fs.prepare_launch_many(progs, inp.words, inp.values,
                                        inp.num_docs, inp.tiles)
    qg, groups = fs.query_group(progs[0], q)
    lay = fs.scan_layout_many(progs[0], qg)
    n = outs[0].buf.numel()
    assert argv[fs._A_Q] == q and argv[fs._A_QG] == qg
    assert groups == (2 if q == 9 else 1)
    assert argv[fs._A_OUT_QSTRIDE] == 8 * n
    assert argv[fs._A_PROG_LEN] == progs[0].prog.size
    assert (argv[fs._A_SMEM], argv[fs._A_ACC_SMEM],
            argv[fs._A_ACC_QSTRIDE]) == (lay.smem, lay.acc_smem,
                                         lay.acc_qstride)
    assert (argv[fs._A_MSTACK_OFF], argv[fs._A_RACC_OFF],
            argv[fs._A_WLIST_OFF], argv[fs._A_LUT_OFF],
            argv[fs._A_LUT_BYTES], argv[fs._A_ACC_OFF]) == (
        lay.mstack_off, lay.racc_off, lay.wlist_off, lay.lut_off,
        lay.lut_bytes, lay.acc_off)
    assert argv[fs._A_OUT_CNT] == outs[0].cnt.data_ptr()
    assert argv[fs._A_OUT_MATCHED] == outs[0].matched.data_ptr()
    for k, o in enumerate(outs):
        assert o.buf.data_ptr() == outs[0].buf.data_ptr() + 8 * n * k
    for i, w in enumerate(inp.words):
        assert argv[fs._A_PACKED + i] == w.data_ptr()
    # the one-query template and the query axis's are kept apart
    solo, _ = fs.prepare_launch(progs[0], inp.words, inp.values,
                                inp.num_docs, inp.tiles)
    assert solo[fs._A_SMEM] == fs.scan_layout(progs[0]).smem
    assert len(progs[0]._argv) == 2
    fs.prepare_launch_many(progs, inp.words, inp.values, inp.num_docs,
                           inp.tiles)
    assert len(progs[0]._argv) == 2


def test_programs_of_another_layout_are_refused(setup):
    _, tsegs = setup
    _, bounds = _bind(tsegs, [
        "SELECT region, sum(qty) FROM sales WHERE year >= 2018 "
        "GROUP BY region",
        "SELECT region, sum(qty) FROM sales WHERE year >= 2018 "
        "AND kind = 'a' GROUP BY region"])
    progs = [b.params for b in bounds]
    inp = bounds[0].inputs
    assert progs[0].layout_key() != progs[1].layout_key()
    with pytest.raises(ValueError, match="layout"):
        sharded_fused_scan_many(progs, inp.words, inp.values, inp.num_docs,
                                inp.tiles)
    with pytest.raises(ValueError, match="no programs"):
        sharded_fused_scan_many([], inp.words, inp.values, inp.num_docs,
                                inp.tiles)


# --------------------------------------------------------------------------
# the port's query axis against the JAX package's run_many
# --------------------------------------------------------------------------

# selective filters would take the index rung on the JAX segments
NO_INDEX = " OPTION(useIndexRung=false)"


def _scan_shapes():
    """name -> (SQL of literal variant k, grouped). Every variant of a
    shape has the same program layout and the same JAX kernel spec (which
    holds the literals of value expressions, so those stay fixed)."""
    shapes = {
        # 20 scattered item runs: one padded interval set (IVS)
        "lut runs": (lambda k: (
            "SELECT region, sum(qty), sum(price), count(*) FROM sales "
            "WHERE item IN (" + ", ".join(str(47 * i + k) for i in range(20))
            + ") GROUP BY region"), True),
        "not": (lambda k: (
            f"SELECT kind, year, sum(raw_amt), max(price), count(*) FROM "
            f"sales WHERE NOT (item BETWEEN {100 * k} AND {100 * k + 450}) "
            f"AND qty >= {1 + 2 * k} GROUP BY kind, year"), True),
        "scalar": (lambda k: (
            f"SELECT count(*), sum(qty), sum(price * 2.5), min(price), "
            f"max(qty), avg(raw_amt) FROM sales WHERE year >= {2015 + k % 9} "
            f"AND ts < {10000 - 300 * k}"), False),
        "grouped": (lambda k: (
            f"SELECT region, kind, sum(qty * 3), sum(price * 1.5), count(*) "
            f"FROM sales WHERE year BETWEEN {2015 + k % 4} AND "
            f"{2019 + k % 5} OR qty < {k + 3} GROUP BY region, kind"), True),
    }
    return {name: ((lambda k, f=f: f(k) + NO_INDEX), grouped)
            for name, (f, grouped) in shapes.items()}


def _jax_many(jsegs, sqls):
    """The JAX batch executor binds each variant, then one ``run_many``
    of their shared launch kernel (Pallas, interpret mode, under vmap);
    -> each variant's decoded result."""
    jex = JSharded(use_pallas=True)
    for sql in sqls:
        jex.execute(j_compile(sql), jsegs)
    entries = [next(v for k, v in jex._param_cache.items() if k[0] == sql)
               for sql in sqls]
    keys = {lkey for _, lkey, _ in entries}
    assert len(keys) == 1, "the variants must share one launch kernel"
    kernel = jex._launch_cache[keys.pop()]
    assert kernel.is_pallas
    batch = jex.batch_for(jsegs)
    S = pad_segments(batch.num_segments, jex.mesh.shape[SEG_AXIS])
    rows = kernel.run_many([p for _, _, p in entries],
                           jex._device_num_docs(batch, S))
    out = []
    for (plan, _, _), row in zip(entries, rows):
        tree = unpack_outputs(np.asarray(row), plan.spec, num_seg=S)
        out.append(j_grouped(plan, batch, tree) if plan.spec[2]
                   else j_scalar(plan, batch, tree))
    return out


def _port_many(tsegs, sqls):
    """The port's batch executor binds each variant (CPU), then one
    ``sharded_fused_scan_many`` over their programs; -> each variant's
    decoded result."""
    dev, bounds = _bind(tsegs, sqls)
    assert len({b.launch_key for b in bounds}) == 1
    inp = bounds[0].inputs
    outs = sharded_fused_scan_many([b.params for b in bounds], inp.words,
                                   inp.values, inp.num_docs, inp.tiles)
    batch = dev.batch_for(tsegs)[0]
    got = []
    for b, o in zip(bounds, outs):
        tree = fs.assemble_outputs(b.plan.spec, b.pp, o)
        got.append(decode_grouped_result(b.plan, batch, tree)
                   if b.plan.spec[2] else decode_scalar_result(b.plan, batch,
                                                               tree))
    return got


def _same_state(g, w, at):
    if isinstance(w, tuple):
        assert isinstance(g, tuple) and len(g) == len(w), at
        for a, b in zip(g, w):
            _same_state(a, b, at)
    elif isinstance(w, float):
        assert g == pytest.approx(w, rel=1e-5, abs=1e-6), at
    else:
        assert g == w, at


def _same_result(got, want, at):
    if hasattr(want, "groups"):
        assert set(got.groups) == set(want.groups), at
        assert want.groups, f"{at}: no group matched"
        for key, states in want.groups.items():
            for g, w in zip(got.groups[key], states):
                _same_state(g, w, (at, key))
    else:
        assert len(got.states) == len(want.states), at
        for g, w in zip(got.states, want.states):
            _same_state(g, w, at)


@pytest.mark.parametrize("q", [3, 9])
@pytest.mark.parametrize("shape", list(_scan_shapes()))
def test_query_axis_against_jax_run_many(setup, shape, q):
    """Q literal variants of one shape: the port's query axis (its plain
    version on the CPU) gives each variant the rows of the JAX package's
    vmapped Pallas launch (interpret mode)."""
    jsegs, tsegs = setup
    sql_of, grouped = _scan_shapes()[shape]
    sqls = [sql_of(k) for k in range(q)]
    want = _jax_many(jsegs, sqls)
    got = _port_many(tsegs, sqls)
    assert len(got) == len(want) == q
    for k, (g, w) in enumerate(zip(got, want)):
        assert hasattr(w, "groups") == grouped
        _same_result(g, w, f"{shape} variant {k}")
    # the variants are distinct queries, not one answer repeated
    if grouped:
        assert len({repr(sorted(r.groups.items())) for r in got}) > 1
    else:
        assert len({repr(r.states) for r in got}) > 1


def _probe_sql(k: int) -> str:
    """item x year is 1024 x 9 groups, past the scan's 8192: the probe
    narrows item to the 401 values whose docs ``ts`` admits."""
    return (f"SELECT item, year, count(*), sum(qty) FROM sales "
            f"WHERE ts BETWEEN {500 * k} AND {500 * k + 4000} "
            f"GROUP BY item, year" + NO_INDEX)


@pytest.mark.parametrize("q", [3, 9])
def test_probe_query_axis_against_jax_run_many(setup, q):
    """Q probes of one layout in one launch: the port's
    ``sharded_fused_scan_probe_many`` decodes to the dictId ranges of the
    JAX package's vmapped Pallas probe, variant by variant, and each
    narrowed query's rows equal the JAX executor's."""
    jsegs, tsegs = setup
    sqls = [_probe_sql(k) for k in range(q)]

    jex = JSharded(use_pallas=True)
    jrows = [jex.execute(j_compile(sql), jsegs)[0].rows for sql in sqls]
    batch = jex.batch_for(jsegs)
    S = pad_segments(batch.num_segments, jex.mesh.shape[SEG_AXIS])
    probe_keys = [k for k in jex._launch_cache if k[0] == "pallas_probe"]
    assert len(probe_keys) == 1, "the variants' probes share one kernel"
    kernel = jex._launch_cache[probe_keys[0]]
    plans = [j_plan(j_compile(sql), batch) for sql in sqls]
    probe_pps = [j_probe_plan(j_extract(p, batch, unchecked_groups=True))
                 for p in plans]
    rows = kernel.run_many([pp.static_params for pp in probe_pps],
                           jex._device_num_docs(batch, S))
    spec = probe_pps[0].spec(num_segs=1, tiles_per_seg=1, interpret=True)
    want = [j_ranges(spec, np.asarray(r), 2) for r in rows]

    dev, bounds = _bind(tsegs, sqls)
    assert all(b.probe is not None for b in bounds)
    probes = [b.probe[0] for b in bounds]
    words = bounds[0].probe[1]
    outs = sharded_fused_scan_probe_many(probes, words,
                                         bounds[0].inputs.num_docs)
    tbatch = dev.batch_for(tsegs)[0]
    pps = [fs.probe_plan_of(fs.extract_plan(
        t_plan(t_compile(sql), tbatch), tbatch, unchecked_groups=True))
        for sql in sqls]
    got = [fs.decode_probe_ranges(pp, o.to_host().mm.numpy(), 2)
           for pp, o in zip(pps, outs)]
    assert got == want
    assert len(set(map(tuple, got))) == q
    trows = [dev.execute(t_compile(sql), tsegs)[0].rows for sql in sqls]
    for k, (t, j) in enumerate(zip(trows, jrows)):
        assert len(t) == len(j) > 0, k
        for tr, jr in zip(t, j):
            for a, b in zip(tr, jr):
                _same_state(a, b, (k, tr, jr))
