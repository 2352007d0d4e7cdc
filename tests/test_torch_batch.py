"""The port's SegmentBatch against the JAX package's, on the same segments
carried across with segment_from_arrays: unified dictionaries, planar
packed words (bit-equal for every width), value columns (an i64 column
against the JAX limb planes recombined), batch plans and scan plans for the
13 SSB flights and tests/test_pallas.py's queries, and the batch-wide probe
ranges against the JAX sharded probe (interpret mode).

Everything compared here is exact: dictIds, words, values and plans.
"""

from dataclasses import replace

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()   # i64 value columns, as the JAX executor stages them

import jax.numpy as jnp  # noqa: E402

from pinot_tpu.engine import pallas_kernels as jpk  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.engine.staging import LIMB_BITS  # noqa: E402
from pinot_tpu.parallel import ShardedQueryExecutor as JSharded  # noqa: E402
from pinot_tpu.parallel.batch import SegmentBatch as JBatch  # noqa: E402
from pinot_tpu.parallel.combine import (  # noqa: E402
    SEG_AXIS,
    build_sharded_pallas_probe,
    pad_segments as j_pad_segments,
)
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine import fused_scan as tfs  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.engine.staging import StagedSegment  # noqa: E402
from pinot_tpu_torch.parallel.batch import SegmentBatch, StagedBatch  # noqa: E402
from pinot_tpu_torch.parallel.combine import (  # noqa: E402
    BATCH_KERNELS,
    sharded_fused_scan_probe,
)
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402
from pinot_tpu_torch.segment import columns_of, segment_from_arrays  # noqa: E402

from tests.test_torch_plan import (  # noqa: E402
    PL_QUERIES,
    _params_equal,
    build_pl_sales,
)

# three segments of different sizes, each ending in a remainder tile; c32
# has 74001 distinct values across them, so its unified ids need 32 bits
WIDE_ROWS = (30000, 20000, 24001)


def carry(jsegs, table):
    return [segment_from_arrays(j.segment_name, j.num_docs, columns_of(j),
                                table_name=table) for j in jsegs]


def _wide_segments(out):
    """Columns of every packed width (1..32 bits once unified) and an
    i64-staged column, over segments with overlapping value sets."""
    schema = Schema("wide", [
        FieldSpec("flag", DataType.INT), FieldSpec("c2", DataType.STRING),
        FieldSpec("c4", DataType.INT), FieldSpec("c8", DataType.STRING),
        FieldSpec("c16", DataType.INT), FieldSpec("c32", DataType.INT),
        FieldSpec("qty", DataType.INT, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("big", DataType.LONG, FieldType.METRIC),
    ])
    segs = []
    for i, n in enumerate(WIDE_ROWS):
        rng = np.random.default_rng(100 + i)
        frame = {
            "flag": rng.integers(0, 2, n),
            "c2": np.array(["w", "x", "y"])[rng.integers(0, 3, n)],
            "c4": rng.integers(0, 11, n),
            "c8": np.array([f"s{i:03d}" for i in range(137)])[
                rng.integers(0, 137, n)],
            "c16": rng.integers(0, 3000, n),
            "c32": np.arange(n) + 7 * i * n,
            "qty": rng.integers(-50, 100, n),
            "price": np.round(rng.normal(80.0, 30.0, n), 2),
            "big": rng.integers(0, 1 << 40, n) - (1 << 39),
        }
        SegmentBuilder(schema, f"wide_{i}").build(frame, str(out))
        segs.append(load_segment(str(out / f"wide_{i}")))
    return segs


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    jssb = j_ssb.build_segments(
        0, str(tmp_path_factory.mktemp("torch_batch_ssb")), num_segments=3,
        rows=18_000, star_tree=False, workers=1)
    jwide = _wide_segments(tmp_path_factory.mktemp("torch_batch_wide"))
    jpl = build_pl_sales(tmp_path_factory.mktemp("torch_batch_pl"))
    out = {}
    for key, jsegs, table in (("ssb", jssb, "ssb_lineorder"),
                              ("wide", jwide, "wide"),
                              ("pl", jpl, "pl_sales")):
        out[key] = (JBatch(jsegs), SegmentBatch(carry(jsegs, table)))
    return out


@pytest.mark.parametrize("key", ["ssb", "wide"])
def test_unified_dictionaries_equal(batches, key):
    jb, tb = batches[key]
    assert tb.segment_name == jb.segment_name
    assert tb.capacity == jb.capacity and tb.num_docs == jb.num_docs
    for col in jb.metadata.columns:
        jd, td = jb.unified_dictionary(col), tb.unified_dictionary(col)
        want = np.asarray(jd.get_values(range(jd.cardinality)))
        np.testing.assert_array_equal(td.values, want, col)
        jcm, tcm = jb.metadata.column(col), tb.metadata.column(col)
        assert (tcm.cardinality, tcm.min_value, tcm.max_value) == \
            (jcm.cardinality, jcm.min_value, jcm.max_value), col
        np.testing.assert_array_equal(tb.stacked_column(col)["fwd"],
                                      jb.stacked_column(col)["fwd"], col)


@pytest.mark.parametrize("key", ["ssb", "wide"])
def test_packed_column_batch_bit_equal(batches, key):
    jb, tb = batches[key]
    widths = set()
    for col in jb.metadata.columns:
        jw, jbits = jb.packed_column_batch(col)
        tw, tbits = tb.packed_column_batch(col)
        assert tbits == jbits, col
        assert tw.dtype == np.uint32
        S, T = jw.shape[:2]
        np.testing.assert_array_equal(tw, jw.reshape(S, T, -1), col)
        assert tb.pallas_tiles() == T
        widths.add(tbits)
    if key == "wide":
        assert widths == {1, 2, 4, 8, 16, 32}


@pytest.mark.parametrize("key", ["ssb", "wide"])
def test_value_column_batch_equal(batches, key):
    jb, tb = batches[key]
    checked = 0
    for col, cm in jb.metadata.columns.items():
        if not cm.data_type.is_numeric:
            assert tb.value_column_batch(col) is None
            continue
        got = tb.value_column_batch(col)
        want = jb.value_column_batch(col)
        S = got.shape[0]
        if want is None:
            # i64-staged: JAX splits into 12-bit limb planes
            assert got.dtype == np.int64, col
            limbs = jpk._limbs_for(max(abs(int(cm.min_value)),
                                       abs(int(cm.max_value))))
            planes = jb.value_limb_batch(col, limbs)
            want = sum(p.reshape(S, -1).astype(np.int64) << (LIMB_BITS * k)
                       for k, p in enumerate(planes))
        else:
            want = want.reshape(S, -1)
        assert got.dtype == want.dtype, col
        np.testing.assert_array_equal(got, want, col)
        checked += 1
    assert checked
    if key == "wide":
        assert tb.value_column_batch("big").dtype == np.int64


def test_num_docs_array(batches):
    jb, tb = batches["wide"]
    np.testing.assert_array_equal(tb.num_docs_array(pad_to=5),
                                  jb.num_docs_array(pad_to=5))
    assert tb.num_docs_array().dtype == np.int64
    assert tuple(tb.num_docs_array()) == WIDE_ROWS


def test_unbatchable_segments_raise(batches):
    _, tb = batches["wide"]
    other = batches["pl"][1].segments[0]
    with pytest.raises(ValueError):
        SegmentBatch([tb.segments[0], other])
    with pytest.raises(ValueError):
        SegmentBatch([])


PLAN_CASES = ([("ssb", j_ssb.QUERIES[q] + " LIMIT 100000")
               for q in sorted(j_ssb.QUERIES)]
              + [("pl", q) for q in PL_QUERIES])


@pytest.mark.parametrize("key,sql", PLAN_CASES,
                         ids=[f"{k} {s[:50]}" for k, s in PLAN_CASES])
def test_batch_plan_and_extract_equal(batches, key, sql):
    jb, tb = batches[key]
    jp = j_plan(j_compile(sql), jb)
    tp = t_plan(t_compile(sql), tb)
    assert tp.spec == jp.spec
    _params_equal(tp.params, jp.params)
    assert tp.group_cards == jp.group_cards
    assert tp.group_bases == jp.group_bases
    for unchecked in (False, True):
        jr, tr = [], []
        ja = jpk.extract_plan(jp, jb, on_decline=jr.append,
                              unchecked_groups=unchecked)
        ta = tfs.extract_plan(tp, tb, on_decline=tr.append,
                              unchecked_groups=unchecked)
        assert tr == jr
        assert (ta is None) == (ja is None)
        if ja is None:
            continue
        for field in ("packed_names", "value_names", "value_is_int",
                      "filter_tree", "n_slots", "group_idx",
                      "group_strides", "group_key_offset",
                      "num_groups_padded", "aggs", "value_limbs"):
            assert getattr(ta, field) == getattr(ja, field), field
        np.testing.assert_array_equal(ta.static_params, ja.static_params)


def _jax_batch_probe_ranges(jsegs, sql):
    """decode_probe_ranges of the JAX sharded probe over the batch."""
    jex = JSharded(use_pallas=True)
    jb = jex.batch_for(jsegs)
    S = j_pad_segments(jb.num_segments, jex.mesh.shape[SEG_AXIS])
    plan = j_plan(j_compile(sql), jb)
    probe_pp = jpk.probe_plan_of(jpk.extract_plan(plan, jb,
                                                  unchecked_groups=True))
    cols = [jex._staged_pallas(jb, nm, S, "packed")
            for nm in probe_pp.packed_names]
    spec = replace(probe_pp.spec(num_segs=S // jex.mesh.shape[SEG_AXIS],
                                 tiles_per_seg=jb.pallas_tiles(),
                                 interpret=True),
                   packed_bits=tuple(b for _, b in cols))
    fn = build_sharded_pallas_probe(spec, jex.mesh)
    out_mm = fn(jnp.asarray(probe_pp.static_params), [w for w, _ in cols],
                jex._device_num_docs(jb, S))
    return jpk.decode_probe_ranges(spec, np.asarray(out_mm),
                                   len(plan.group_cards))


@pytest.mark.parametrize("qid", ["Q3.2", "Q4.3"])
def test_batch_probe_ranges_match(batches, qid):
    sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
    jb, tb = batches["ssb"]
    want = _jax_batch_probe_ranges(jb.segments, sql)

    tplan = t_plan(t_compile(sql), tb)
    probe_pp = tfs.probe_plan_of(tfs.extract_plan(tplan, tb,
                                                  unchecked_groups=True))
    staged = StagedBatch(tb, device="cpu")
    pcs = [staged.packed_column(c) for c in probe_pp.packed_names]
    prog = tfs.compile_program(probe_pp, tuple(p.bits for p in pcs),
                               probe=True)
    out = sharded_fused_scan_probe(prog, [p.words for p in pcs],
                                   staged.num_docs_tensor())
    got = tfs.decode_probe_ranges(probe_pp, out.to_host().mm.numpy(),
                                  len(tplan.group_cards))
    assert got == want
    assert any(hi - lo + 1 < c for (lo, hi), c in
               zip(got, tplan.group_cards)), "probe did not narrow"


def test_staged_batch_pads_segments(batches):
    _, tb = batches["wide"]
    staged = StagedBatch(tb, device="cpu", num_segs=4)
    assert staged.num_docs_tensor().tolist() == [*WIDE_ROWS, 0]
    pc = staged.packed_column("c8")
    assert tuple(pc.words.shape) == (4, tb.pallas_tiles(), 4096 * 8 // 32)
    assert int(pc.words[3].abs().sum()) == 0
    assert tuple(staged.value_column("big").shape) == \
        (4, tb.pallas_tiles() * 4096)
    assert staged.nbytes() == (pc.words.numel() * 4
                               + staged.value_column("big").numel() * 8
                               + 4 * 8)


@pytest.mark.parametrize("qid", ["Q1.1", "Q4.3"])
def test_scan_inputs_pick_wrappers_by_staged_type(batches, qid):
    """A staged batch scans (and probes) through the batch wrappers, a
    staged segment through the per-segment ones; the batch's outputs are
    its segments' outputs added up."""
    sql = j_ssb.QUERIES[qid] + " LIMIT 100000"
    _, tb = batches["ssb"]
    ctx = t_compile(sql)
    binp = tfs.scan_inputs(t_plan(ctx, tb), StagedBatch(tb, device="cpu"))
    assert binp.kernels is BATCH_KERNELS
    assert (binp.probe is not None) == (qid == "Q4.3")
    bout = binp.scan()
    matched = []
    for seg in tb.segments:
        sinp = tfs.scan_inputs(t_plan(ctx, seg),
                               StagedSegment(seg, device="cpu"))
        assert sinp.kernels is tfs.SEGMENT_KERNELS
        matched += sinp.scan().matched.tolist()
    assert bout.matched.tolist() == matched
    with pytest.raises(ValueError):
        BATCH_KERNELS.probe(binp.prog, binp.words, binp.num_docs)
    with pytest.raises(ValueError):
        tfs.fused_scan_probe(binp.prog, binp.words, binp.num_docs)


def test_doc_masks_count_what_the_scan_matches(batches):
    _, tb = batches["wide"]
    sql = "SELECT c4, sum(qty) FROM wide WHERE c8 != 's003' AND flag = 1 " \
          "GROUP BY c4"
    staged = StagedBatch(tb, device="cpu", num_segs=4)
    inp = tfs.scan_inputs(t_plan(t_compile(sql), tb), staged)
    valid, matched = tfs.doc_masks(inp.prog, inp.words, inp.num_docs)
    S = staged.num_segs
    assert valid.view(S, -1).sum(dim=1).tolist() == [*WIDE_ROWS, 0]
    assert not (matched & ~valid).any()
    assert matched.view(S, -1).sum(dim=1).tolist() == \
        inp.scan().matched.tolist()


@pytest.fixture(scope="module")
def stats_batches(tmp_path_factory):
    """tests/test_torch_columns.py's two stats segments: raw LONG/DOUBLE
    columns (one past 2^31), MV columns with null rows, nullable columns."""
    from tests.test_torch_columns import build_stats

    jsegs, tsegs = build_stats(tmp_path_factory.mktemp("torch_batch_stats"))
    return JBatch(jsegs), SegmentBatch(tsegs)


def test_raw_mv_null_stacked_columns_equal(stats_batches):
    """Merged metadata and every stacked array (raw values in their staged
    dtype, dense MV and counts, null bitmaps) equal the JAX batch's."""
    jb, tb = stats_batches
    for col in jb.metadata.columns:
        jcm, tcm = jb.metadata.column(col), tb.metadata.column(col)
        assert (tcm.cardinality, tcm.min_value, tcm.max_value,
                tcm.has_nulls, tcm.max_num_multi_values) == \
            (jcm.cardinality, jcm.min_value, jcm.max_value, jcm.has_nulls,
             jcm.max_num_multi_values), col
        got, want = tb.stacked_column(col), jb.stacked_column(col)
        assert sorted(got) == sorted(want), col
        for k in want:
            assert got[k].dtype == want[k].dtype, (col, k)
            np.testing.assert_array_equal(got[k], want[k], f"{col}.{k}")
        assert (tb.unified_dictionary(col) is None) == \
            (jb.unified_dictionary(col) is None), col


def test_raw_value_column_batch_equal(stats_batches):
    """A raw column's batch values equal the JAX batch's (an i64 column's
    against the JAX limb planes recombined); a raw column packs nothing."""
    jb, tb = stats_batches
    for col in ("salary", "bonus", "ratio", "big"):
        got = tb.value_column_batch(col)
        want = jb.value_column_batch(col)
        S = got.shape[0]
        if want is None:
            cm = jb.metadata.column(col)
            planes = jb.value_limb_batch(col, jpk._limbs_for(
                max(abs(int(cm.min_value)), abs(int(cm.max_value)))))
            want = sum(p.reshape(S, -1).astype(np.int64) << (LIMB_BITS * k)
                       for k, p in enumerate(planes))
        else:
            want = want.reshape(S, -1)
        assert got.dtype == want.dtype, col
        np.testing.assert_array_equal(got, want, col)
        with pytest.raises(ValueError):
            tb.packed_column_batch(col)
    assert tb.value_column_batch("big").dtype == np.int64
    assert tb.value_column_batch("nums") is None


def test_raw_value_batch_plan_and_extract_equal(stats_batches):
    """A batch plan reading raw value columns (and none packed) extracts to
    the JAX scan plan, and its batch scan matches the per-segment scans."""
    jb, tb = stats_batches
    for sql in ("SELECT team, sum(salary), min(bonus), max(ratio), count(*) "
                "FROM stats WHERE league = 'AL' GROUP BY team",
                "SELECT sum(big), avg(ratio), count(*) FROM stats"):
        ctx = t_compile(sql)
        tp, jp = t_plan(ctx, tb), j_plan(j_compile(sql), jb)
        assert tp.spec == jp.spec
        tpp = tfs.extract_plan(tp, tb)
        jpp = jpk.extract_plan(jp, jb)
        assert tpp.value_names == jpp.value_names
        assert tpp.value_limbs == jpp.value_limbs
        assert tpp.aggs == jpp.aggs and tpp.filter_tree == jpp.filter_tree
        inp = tfs.scan_inputs(tp, StagedBatch(tb, device="cpu"))
        out = inp.scan()
        per_seg = [tfs.scan_inputs(t_plan(ctx, s),
                                   StagedSegment(s, device="cpu")).scan()
                   for s in tb.segments]
        assert out.matched.tolist() == [int(o.matched[0]) for o in per_seg]
        if not tp.spec[2]:   # scalar: one key space in both
            np.testing.assert_array_equal(
                out.isum.numpy(), sum(o.isum.numpy() for o in per_seg))
