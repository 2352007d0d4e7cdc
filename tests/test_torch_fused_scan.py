"""The port's fused scan (plain version on the CPU) against the JAX fused
Pallas kernel in interpret mode, per segment and decoded; and the probe
ranges against the JAX probe's.

Tolerance: counts, keys, integer sums and min/max exact; float sums
rel 1e-5, abs 1e-6 (tests/test_pallas.py:101): the JAX kernel sums floats
as Neumaier f32 pairs, the port in f64.
"""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()

from pinot_tpu.engine import executor as j_exec  # noqa: E402
from pinot_tpu.engine import pallas_kernels as jpk  # noqa: E402
from pinot_tpu.engine.kernels import unpack_outputs  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.engine.staging import StagingCache  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine import executor as t_exec  # noqa: E402
from pinot_tpu_torch.engine import fused_scan as tfs  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.engine.staging import StagedSegment  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import columns_of, segment_from_arrays  # noqa: E402

from tests.test_torch_plan import PL_QUERIES, build_pl_sales  # noqa: E402


def carry(jseg, table):
    return segment_from_arrays(jseg.segment_name, jseg.num_docs,
                               columns_of(jseg), table_name=table)


@pytest.fixture(scope="module")
def ssb_pairs(tmp_path_factory):
    jsegs = j_ssb.build_segments(
        0, str(tmp_path_factory.mktemp("torch_fs_ssb")), num_segments=2,
        rows=18_000, star_tree=False, workers=1)
    return [(j, carry(j, "ssb_lineorder")) for j in jsegs]


@pytest.fixture(scope="module")
def pl_pairs(tmp_path_factory):
    jsegs = build_pl_sales(tmp_path_factory.mktemp("torch_fs_pl"))
    return [(j, carry(j, "pl_sales")) for j in jsegs]


@pytest.fixture(scope="module")
def pallas_cache():
    return jpk.PallasKernelCache()


def _decode(mod, plan, seg, tree, grouped):
    if grouped:
        return mod.decode_grouped_result(plan, seg, tree).groups
    return {(): mod.decode_scalar_result(plan, seg, tree).states}


def _close(got, want, exact):
    if isinstance(want, tuple):
        return all(_close(g, w, exact) for g, w in zip(got, want))
    if isinstance(want, float) and not exact:
        return got == pytest.approx(want, rel=1e-5, abs=1e-6)
    return got == want


def _scan_both(pair, sql, cache):
    jseg, tseg = pair
    jplan = j_plan(j_compile(sql), jseg)
    tplan = t_plan(t_compile(sql), tseg)
    served = jpk.run_segment(jplan, StagingCache().stage(jseg), cache,
                             interpret=True)
    assert served is not None, sql
    packed, jeff = served
    jtree = unpack_outputs(np.asarray(packed), jeff.spec)
    reasons = []
    scan = tfs.run_segment(tplan, StagedSegment(tseg, device="cpu"),
                           on_decline=reasons.append)
    assert scan is not None and not reasons, reasons
    grouped = bool(jplan.spec[2])
    assert scan.plan.spec == jeff.spec
    want = _decode(j_exec, jeff, jseg, jtree, grouped)
    got = _decode(t_exec, scan.plan, tseg, scan.tree, grouped)
    assert set(got) == set(want), sql
    # exact unless the aggregation accumulates floats
    exact = [a[3] != "f32" for a in jeff.spec[1]]
    for key, states in want.items():
        for g, w, ex in zip(got[key], states, exact):
            assert _close(g, w, ex), (sql, key, g, w)
    return scan


@pytest.mark.parametrize("qid", sorted(j_ssb.QUERIES))
def test_ssb_flight_matches_pallas_interpret(ssb_pairs, pallas_cache, qid):
    for pair in ssb_pairs:
        _scan_both(pair, j_ssb.QUERIES[qid] + " LIMIT 100000", pallas_cache)


@pytest.mark.parametrize("i", range(len(PL_QUERIES)))
def test_pl_sales_matches_pallas_interpret(pl_pairs, pallas_cache, i):
    for pair in pl_pairs:
        _scan_both(pair, PL_QUERIES[i], pallas_cache)


@pytest.mark.parametrize("qid", ["Q3.2", "Q4.3"])
def test_probe_ranges_match(ssb_pairs, pallas_cache, qid):
    sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
    for jseg, tseg in ssb_pairs:
        jplan = j_plan(j_compile(sql), jseg)
        jfull = jpk.extract_plan(jplan, jseg, unchecked_groups=True)
        jprobe = jpk.probe_plan_of(jfull)
        out_mm = jpk._run_probe_segment(jprobe, StagingCache().stage(jseg),
                                        pallas_cache, True, lambda r: None)
        want = jpk.decode_probe_ranges(
            jprobe.spec(num_segs=1, tiles_per_seg=1, interpret=True),
            out_mm, len(jplan.group_cards))

        tplan = t_plan(t_compile(sql), tseg)
        tfull = tfs.extract_plan(tplan, tseg, unchecked_groups=True)
        tprobe = tfs.probe_plan_of(tfull)
        staged = StagedSegment(tseg, device="cpu")
        pcs = [staged.packed_column(c) for c in tprobe.packed_names]
        prog = tfs.compile_program(tprobe, tuple(p.bits for p in pcs),
                                   probe=True)
        out = tfs.fused_scan(prog, [p.words.unsqueeze(0) for p in pcs], [],
                             staged.num_docs_tensor())
        got = tfs.decode_probe_ranges(tprobe, out.mm.numpy(),
                                      len(tplan.group_cards))
        assert got == want
        assert any(hi - lo + 1 < c for (lo, hi), c in
                   zip(got, jplan.group_cards)), "probe did not narrow"


def test_plain_scan_counts_matched_docs(ssb_pairs):
    """matched counts docs passing the filter, numpy-checked."""
    jseg, tseg = ssb_pairs[0]
    sql = "SELECT count(*) FROM ssb_lineorder WHERE lo_discount BETWEEN 1 AND 3"
    scan = tfs.run_segment(t_plan(t_compile(sql), tseg),
                           StagedSegment(tseg, device="cpu"))
    ds = tseg.data_source("lo_discount")
    vals = ds.dictionary.values[ds.forward_index[:tseg.num_docs]]
    want = int(((vals >= 1) & (vals <= 3)).sum())
    assert scan.matched == want == int(scan.tree["num_matched"])


def test_compile_program_layout():
    """The program sections hold what the plan says, in postfix order."""
    pp = tfs.ScanPlan(
        packed_names=["a", "b"], value_names=["v"], value_is_int=(True,),
        filter_tree=("and", (("iv", 0, 0), ("not", (("iv", 1, 1),)))),
        n_slots=2, group_idx=(1,), group_strides=(1,), group_key_offset=3,
        num_groups_padded=128,
        aggs=(("count", None, None), ("sum", ("times", ("v", 0),
                                              ("litc", 2)), 1),
              ("minmaxrange", ("v", 0), None)),
        static_params=np.array([1, 4, 2, 2], dtype=np.int32))
    prog = tfs.compile_program(pp, (4, 8))
    p = prog.prog.tolist()
    ops = [p[prog.filter_off + 4 * i] for i in range(prog.filter_n)]
    assert ops == [tfs.F_IV, tfs.F_IV, tfs.F_NOT, tfs.F_AND]
    assert (prog.n_isum, prog.n_fsum, prog.n_mm, prog.G) == (1, 0, 2, 128)
    assert [r[0] for r in prog.rows] == [tfs.R_ISUM, tfs.R_MIN, tfs.R_MAX]
    assert p[prog.iv_off:] == [1, 4, 2, 2]
    assert prog.key_offset == 3 and not prog.scalar


# --------------------------------------------------------------------------
# the host side of the kernel's design: the filter's ("early") columns,
# log2 widths and the kernel's addressing, the shared-memory layout, the
# argv slots shared with csrc/fused_scan.cu
# --------------------------------------------------------------------------

import os  # noqa: E402
import re  # noqa: E402

import chip_smoke  # noqa: E402
from pinot_tpu_torch.engine.staging import TILE, pack_planar  # noqa: E402

_SSB_COL = re.compile(r"\b[a-z]{1,2}_[a-z0-9]+\b")
_SYN_COL = re.compile(r"\bb(?:1|2|4|8|16|32)\b")


def _where_and_group(sql, col_re):
    """Column names in the WHERE clause and in GROUP BY, from the SQL."""
    where = (sql.split(" WHERE ", 1)[1].split(" GROUP BY ")[0]
             if " WHERE " in sql else "")
    group = sql.split(" GROUP BY ", 1)[1] if " GROUP BY " in sql else ""
    group = group.split(" ORDER BY ")[0]
    return set(col_re.findall(where)), set(col_re.findall(group))


def _tree_cols(node):
    """Packed columns the plan's filter tree reads (its iv/ivs leaves)."""
    if node[0] in ("iv", "ivs"):
        return {node[1]}
    if node[0] == "true":
        return set()
    return set().union(*(_tree_cols(c) for c in node[1]))


def _check_split(prog, names, filter_cols, group_cols):
    early = {names[c] for c in prog.early}
    late = set(names) - early
    assert early == filter_cols
    # group-only columns are late; a column in both is early
    assert late == group_cols - filter_cols
    assert list(prog.early) == sorted(set(prog.early))


@pytest.mark.parametrize("case", [f"ssb:{q}" for q in sorted(j_ssb.QUERIES)]
                         + [f"smoke:{i}" for i in
                            range(len(chip_smoke._kernel_cases()))])
def test_early_late_split(ssb_pairs, case):
    """Filter columns are early (read for every doc); group-only and
    ID-only columns are late (read for passing docs); a column both
    filtered and grouped on is early. The probe program
    splits alike (its group columns are ID values). The filter's columns are
    those of the SQL's WHERE clause the plan kept (the planner folds a
    predicate that every doc of the segment meets, or none)."""
    kind, key = case.split(":")
    if kind == "ssb":
        _, tseg = ssb_pairs[0]
        sql = j_ssb.QUERIES[key]
        col_re = _SSB_COL
    else:
        tseg = chip_smoke._synthetic_segment(20_000, 7)
        sql = chip_smoke._kernel_cases()[int(key)][1]
        col_re = _SYN_COL
    where_cols, group_cols = _where_and_group(sql, col_re)
    inp = tfs.scan_inputs(t_plan(t_compile(sql + " LIMIT 100000"), tseg),
                          StagedSegment(tseg, device="cpu"))
    names = inp.pp.packed_names
    filter_cols = {names[c] for c in _tree_cols(inp.pp.filter_tree)}
    # a query with a WHERE clause keeps a filter column; one without
    # (raw value columns alone) reads no packed column
    assert filter_cols <= where_cols
    assert bool(filter_cols) == bool(where_cols)
    _check_split(inp.prog, names, filter_cols, group_cols)
    if inp.probe is not None:
        probe_prog, _ = inp.probe
        # the probe reads the full plan's packed columns, in its order
        full = tfs.extract_plan(t_plan(t_compile(sql), tseg), tseg,
                                unchecked_groups=True)
        _check_split(probe_prog, full.packed_names, filter_cols, group_cols)
        assert all(p for p, _ in probe_prog.operands)


def _one_column_plan(filter_tree=("iv", 0, 0)):
    return tfs.ScanPlan(
        packed_names=["c"], value_names=[], value_is_int=(),
        filter_tree=filter_tree, n_slots=1, group_idx=(), group_strides=(),
        group_key_offset=0, num_groups_padded=tfs.G_CHUNK,
        aggs=(("count", None, None),),
        static_params=np.array([0, 0], dtype=np.int32))


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16, 32])
def test_log2_width_and_kernel_addressing(bits):
    """The program carries log2 of each width, and the kernel's two ways of
    finding a doc's dictId with it (per doc: word j & (W - 1) at bit
    (j >> log2 W) << log2 B; per thread: the 16 docs i + 256 r from B/2
    words) read back what the planar packing wrote."""
    prog = tfs.compile_program(_one_column_plan(), (bits,))
    lb = prog.log2_bits[0]
    assert 1 << lb == bits and prog.early == (0,)
    rng = np.random.default_rng(bits)
    ids = rng.integers(0, 1 << bits, 2 * TILE, dtype=np.uint64)
    words = pack_planar(ids, bits).astype(np.uint64)       # [2, W]
    W = words.shape[1]
    assert W == 128 << lb
    mask = (1 << bits) - 1
    j = np.arange(TILE)
    word = j & (W - 1)
    shift = (j >> (7 + lb)) << lb
    for t in range(2):
        got = (words[t, word] >> shift.astype(np.uint64)) & np.uint64(mask)
        assert np.array_equal(got, ids[t * TILE:(t + 1) * TILE])
    i = np.arange(256)[:, None]
    r = np.arange(16)[None, :]
    if lb == 0:
        word, shift = np.broadcast_to(i & 127, (256, 16)), (i >> 7) + 2 * r
    else:
        nw = bits // 2
        word, shift = i + 256 * (r % nw), np.broadcast_to(
            (r // nw) * bits, (256, 16))
    got = (words[0, word] >> shift.astype(np.uint64)) & np.uint64(mask)
    assert np.array_equal(got, ids[i + 256 * r])


def _grouped_plan(n_packed, G, n_isum=1, n_fsum=0):
    """A plan filtering on packed columns 0..n_packed-1 (one interval each,
    ANDed), grouped on one further packed column, with int and float sum
    rows."""
    leaves = tuple(("iv", c, c) for c in range(n_packed))
    tree = leaves[0] if n_packed == 1 else ("and", leaves)
    names = [f"f{c}" for c in range(n_packed)] + ["g"]
    aggs = [("count", None, None)]
    aggs += [("sum", ("v", k), 1) for k in range(n_isum)]
    aggs += [("sum", ("v", n_isum + k), None) for k in range(n_fsum)]
    return tfs.ScanPlan(
        packed_names=names, value_names=[f"v{k}" for k in
                                         range(n_isum + n_fsum)],
        value_is_int=(True,) * n_isum + (False,) * n_fsum, filter_tree=tree,
        n_slots=n_packed, group_idx=(n_packed,), group_strides=(1,),
        group_key_offset=0, num_groups_padded=G, aggs=tuple(aggs),
        static_params=np.zeros(2 * n_packed, dtype=np.int32))


@pytest.mark.parametrize("case", [
    # (name, plan, bits, accumulators in shared memory)
    ("scalar: per-thread rows", _one_column_plan(), (8,), False),
    ("filter reads no column", _one_column_plan(("true",)), (8,), False),
    ("128 groups in shared memory", _grouped_plan(2, 128), (8, 4, 8), True),
    # 8192 groups x (cnt + 2 sums) = 192 KB: one block per SM -> device
    ("8192 groups, 3 rows: device memory",
     _grouped_plan(1, 8192, n_isum=1, n_fsum=1), (32, 16), False),
    # 6144 groups x 16 B = 96 KB beside 8 filter columns: two blocks fit
    ("6144 groups, 8 filter columns: shared", _grouped_plan(8, 6144),
     (32,) * 8 + (16,), True),
    ("1024 groups: shared", _grouped_plan(2, 1024), (32, 16, 16), True),
    # two blocks' share of the SM (113664 B) less the warps' lists and the
    # program holds 6400 groups x 16 B, not 7040 (Q2.1 on SSB's batch)
    ("6400 groups: the most two blocks hold", _grouped_plan(1, 6400),
     (32, 16), True),
    ("7040 groups: past two blocks, device memory", _grouped_plan(1, 7040),
     (32, 16), False),
], ids=lambda c: c[0])
def test_scan_layout_choices(case):
    _, pp, bits, acc_smem = case
    prog = tfs.compile_program(pp, bits)
    lay = tfs.scan_layout(prog)
    assert lay.acc_smem == acc_smem
    # every layout leaves room for two blocks per SM
    assert tfs._SMEM_SM // (lay.smem + tfs._SMEM_RESERVED) >= 2
    offs = [lay.prog_off, lay.mstack_off, lay.vstack_off, lay.racc_off,
            lay.wlist_off, lay.acc_off, lay.smem]
    assert lay.prog_off == 0
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs[:-1])
    assert lay.prog_off + 4 * prog.prog.size <= lay.mstack_off
    assert lay.vstack_off - lay.mstack_off >= (
        2 * 256 * max(prog.filter_depth - 1, 0))
    assert lay.racc_off - lay.vstack_off == (
        8 * 256 * max(prog.value_depth - 1, 0))
    assert lay.wlist_off - lay.racc_off == (
        8 * 256 * prog.n_rows if prog.scalar else 0)
    assert lay.acc_off - lay.wlist_off == 2 * TILE
    acc = prog.G * (8 * (1 + prog.n_isum + prog.n_fsum) + 4 * prog.n_mm)
    assert lay.smem - lay.acc_off == (acc if lay.acc_smem else 0)


def test_operands_and_depths():
    """A doc's operands: group keys first, then ID and value columns in
    program order, each once, at most MAX_OPERANDS; the stack depths the
    layout sizes from."""
    pp = tfs.ScanPlan(
        packed_names=["a", "b", "c"], value_names=["v", "w"],
        value_is_int=(True, False),
        filter_tree=("or", (("iv", 0, 0), ("and", (("iv", 1, 1),
                                                   ("iv", 0, 2))))),
        n_slots=3, group_idx=(2, 1), group_strides=(1, 4),
        group_key_offset=0, num_groups_padded=128,
        aggs=(("sum", ("times", ("v", 0), ("plus", ("v", 0), ("litc", 1))),
               1),
              ("sum", ("v", 1), None),
              ("max", ("id", 0), None)),
        static_params=np.zeros(6, dtype=np.int32))
    prog = tfs.compile_program(pp, (4, 8, 2))
    assert prog.operands == ((True, 2), (True, 1), (False, 0), (False, 1),
                             (True, 0))
    assert prog.filter_depth == 3 and prog.value_depth == 3
    assert prog.early == (0, 1)


def _c_enum(src, first):
    """name -> value of the C enum that starts with ``first``."""
    body = src[src.index(first):]
    body = body[:body.index("};")]
    out, nxt = {}, 0
    for item in body.replace("\n", " ").split(","):
        item = item.strip()
        if not item:
            continue
        name, _, val = item.partition("=")
        nxt = int(val) if val.strip() else nxt
        out[name.strip()] = nxt
        nxt += 1
    return out


def test_argv_slots_match_the_kernel_source():
    """The wrapper's argv slots and limits are the kernel's."""
    src = open(os.path.join(os.path.dirname(tfs.__file__), "csrc",
                            "fused_scan.cu")).read()
    slots = _c_enum(src, "A_NUM_DOCS = 0")
    for name, val in slots.items():
        assert getattr(tfs, f"_{name}") == val, name
    assert set(slots) == {k[1:] for k in vars(tfs)
                          if re.fullmatch(r"_A_[A-Z0-9_]+", k)}
    for name, val in (("MAX_COLS", tfs.MAX_COLS),
                      ("MAX_OPND", tfs.MAX_OPERANDS),
                      ("BLOCK", tfs._BLOCK), ("TILE", TILE)):
        assert re.search(rf"#define {name} {val}\b", src), name
    assert re.search(r"#define SMEM_BLOCK_MAX \(227 \* 1024\)", src)


# the kernel's filter leaf (csrc/fused_scan.cu leaf_mask), mirrored in numpy
# step for step: SWAR range tests of every field of a word up to 8 bits,
# the result bits compressed into each thread's 16-doc mask
_U = np.uint32
_ONE = {0: 0x55555555, 1: 0x11111111, 2: 0x01010101, 3: 0x00010001}


def _fields_in(w, lb, lor, hig):
    B = 1 << lb
    ev, g = _U(_ONE[lb] * ((1 << B) - 1)), _U(_ONE[lb] << B)
    e, o = w & ev, (w >> _U(B)) & ev
    ie = ((e | g) - lor) & (hig - e) & g
    io = ((o | g) - lor) & (hig - o) & g
    return (ie >> _U(B)) | io


def _compress_even(x):
    x = x & _U(0x55555555)
    for sh, m in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF),
                  (8, 0x0000FFFF)):
        x = (x | (x >> _U(sh))) & _U(m)
    return x


def _halve(x, lb):
    steps = {1: None, 2: ((2, 0x05050505), (4, 0x00550055), (8, 0x5555)),
             3: ((4, 0x00110011), (8, 0x1111))}[lb]
    if steps is None:
        return _compress_even(x)
    for sh, m in steps:
        x = (x | (x >> _U(sh))) & _U(m)
    return x


def _leaf_mask(words, lb, ivs):
    """One tile's words of a 2^lb-bit column -> [256] masks of docs
    i + 256 r whose dictId lies in any interval."""
    B, M = 1 << lb, (1 << (1 << lb)) - 1
    i = np.arange(256)
    if lb == 0:
        w = [words[i & 127]]
    else:
        w = [words[i + 256 * k] for k in range(B // 2)]
    acc = [np.zeros(256, _U) for _ in w]
    m = np.zeros(256, _U)
    for lo, hi in ivs:
        lo = max(lo, 0)
        if hi < lo or lo > M:
            continue
        hi = min(hi, M)
        for k in range(len(w)):
            if lb <= 3:
                acc[k] |= _fields_in(w[k], lb, _U(lo * _ONE[lb]),
                                     _U(hi * _ONE[lb] | (_ONE[lb] << B)))
            elif lb == 4:
                m |= (((w[k] & _U(0xFFFF)) - _U(lo)) <= _U(hi - lo)
                      ).astype(_U) << _U(k)
                m |= (((w[k] >> _U(16)) - _U(lo)) <= _U(hi - lo)
                      ).astype(_U) << _U(k + 8)
            else:
                m |= ((w[k] - _U(lo)) <= _U(hi - lo)).astype(_U) << _U(k)
    if lb == 0:
        return _compress_even(acc[0] >> (i >> 7).astype(_U))
    if lb <= 3:
        for k in range(len(w)):
            m |= _halve(acc[k], lb) << _U(k)
    return m


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16, 32])
def test_filter_leaf_arithmetic(bits):
    """The kernel's filter leaf gives each thread the mask of its docs whose
    dictId lies in any of the intervals: empty ones, ones reaching past the
    width or below 0, several at once (IVS)."""
    lb = bits.bit_length() - 1
    rng = np.random.default_rng(bits)
    top = min(1 << bits, 1 << 31)
    i = np.arange(256)[:, None]
    r = np.arange(16)[None, :]
    with np.errstate(over="ignore"):
        for _ in range(40):
            ids = rng.integers(0, 1 << bits, TILE, dtype=np.uint64)
            words = pack_planar(ids, bits).reshape(-1).astype(_U)
            ivs = []
            for _ in range(int(rng.integers(1, 4))):
                lo, hi = sorted(rng.integers(-3, top + 3, 2).tolist())
                if rng.random() < 0.2:
                    lo, hi = hi, lo
                ivs.append((lo, min(hi, (1 << 31) - 1)))
            d = ids[i + 256 * r].astype(np.int64)
            ok = np.zeros((256, 16), bool)
            for lo, hi in ivs:
                ok |= (d >= lo) & (d <= hi)
            want = (ok << r).sum(axis=1)
            assert np.array_equal(_leaf_mask(words, lb, ivs), want), ivs


def test_prepare_launch_argv():
    """The launch's argv (built on CPU tensors here: no launch) carries the
    inputs' and outputs' addresses, the program's sections and widths, the
    layout, and each operand's slot; the part that depends only on the
    program and the batch's shape is built once."""
    seg = chip_smoke._synthetic_segment(20_000, 7)
    staged = StagedSegment(seg, device="cpu")
    sql = chip_smoke._kernel_cases()[1][1] + " LIMIT 100000"
    inp = tfs.scan_inputs(t_plan(t_compile(sql), seg), staged)
    prog = inp.prog
    args = (prog, inp.words, inp.values, inp.num_docs)
    argv, out = tfs.prepare_launch(*args)
    lay = tfs.scan_layout(prog)
    S, T = inp.words[0].shape[:2]
    assert (argv[tfs._A_NUM_TILES], argv[tfs._A_SEG_TILES]) == (S * T, T)
    assert argv[tfs._A_NUM_DOCS] == inp.num_docs.data_ptr()
    assert argv[tfs._A_OUT_CNT] == out.cnt.data_ptr()
    assert argv[tfs._A_OUT_MATCHED] == out.matched.data_ptr()
    assert (argv[tfs._A_SMEM], argv[tfs._A_ACC_SMEM]) == (lay.smem,
                                                          lay.acc_smem)
    assert (argv[tfs._A_PROG_SMEM_OFF], argv[tfs._A_MSTACK_OFF],
            argv[tfs._A_WLIST_OFF]) == (lay.prog_off, lay.mstack_off,
                                        lay.wlist_off)
    for i, w in enumerate(inp.words):
        assert argv[tfs._A_PACKED + i] == w.data_ptr()
        assert argv[tfs._A_LOG2_BITS + i] == prog.log2_bits[i]
    for i, v in enumerate(inp.values):
        assert argv[tfs._A_VALUES + i] == v.data_ptr()
    slots = {(bool(p), c): k for k, (p, c) in enumerate(prog.operands)}
    for c in range(tfs.MAX_COLS):
        assert argv[tfs._A_SLOT_PACKED + c] == slots.get((True, c), -1)
        assert argv[tfs._A_SLOT_VALUE + c] == slots.get((False, c), -1)
    assert argv[tfs._A_N_OPND] == len(prog.operands)
    # a second launch: new outputs, the same cached template
    argv2, out2 = tfs.prepare_launch(*args)
    assert argv2[tfs._A_OUT_CNT] == out2.cnt.data_ptr() != out.cnt.data_ptr()
    assert len(prog._argv) == 1
