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
    if mod is j_exec:
        return {(): mod.decode_scalar_result(plan, seg, tree).states}
    return {(): mod.decode_scalar_result(plan, tree).states}


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
        out = tfs.fused_scan(prog, [p.words for p in pcs], [], tseg.num_docs)
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
