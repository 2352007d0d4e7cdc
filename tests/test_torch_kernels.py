"""The port's general rung (pinot_tpu_torch/engine/kernels.py) against the
JAX package's jnp body (pinot_tpu/engine/kernels.py), leaf by leaf, on the
same segments carried across with segment_from_arrays, the same spec and
the same params: every rung (dense, compact, hash, sort, cond), scalar
DISTINCTCOUNT and DISTINCTCOUNTHLL, grouped HLL and gexpr keys; then the
output layout and pack -> unpack on the same tree.

Tolerance: counts, integer sums, min/max, keys, distinct presence and HLL
registers exact; float sums rel 1e-5, abs 1e-6 (the port sums in f64, the
JAX body in f32).
"""

import numpy as np
import pytest
import torch

from pinot_tpu.engine import ensure_x64

ensure_x64()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pinot_tpu.engine import kernels as jk  # noqa: E402
from pinot_tpu.engine.plan import PlanError as jk_PlanError  # noqa: E402
from pinot_tpu.engine.plan import plan_segment as j_plan  # noqa: E402
from pinot_tpu.engine.staging import StagedSegment as JStaged  # noqa: E402
from pinot_tpu.query import compile_query as j_compile  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu.tools import ssb as j_ssb  # noqa: E402
from pinot_tpu_torch.engine import kernels as tk  # noqa: E402
from pinot_tpu_torch.engine.errors import PlanError as t_PlanError  # noqa: E402
from pinot_tpu_torch.engine.plan import plan_segment as t_plan  # noqa: E402
from pinot_tpu_torch.engine.staging import StagedSegment  # noqa: E402
from pinot_tpu_torch.query import compile_query as t_compile  # noqa: E402

from tests.test_torch_plan import carry  # noqa: E402

CPU = torch.device("cpu")


def _wide_frame(seed, correlated):
    rng = np.random.default_rng(seed)
    n = 20_000
    ai = rng.integers(0, 150, n)
    bi = ai if correlated else rng.integers(0, 150, n)
    return {"a": [f"a{i:03d}" for i in ai], "b": [f"b{i:03d}" for i in bi],
            "year": rng.integers(2000, 2004, n).tolist(),
            "v": rng.integers(0, 100, n).tolist(),
            "w": np.round(rng.normal(50.0, 20.0, n), 3).tolist()}


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    """(JAX segment, port segment, table) per name: tests/test_hash_groupby
    .py's wide and tied shapes (plus a float column) and one SSB segment."""
    out = tmp_path_factory.mktemp("torch_kernels")
    schema = Schema("hw", [
        FieldSpec("a", DataType.STRING), FieldSpec("b", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("v", DataType.LONG, FieldType.METRIC),
        FieldSpec("w", DataType.DOUBLE, FieldType.METRIC)])
    got = {}
    for name, seed, corr in (("wide", 11, False), ("tied", 12, True)):
        SegmentBuilder(schema, f"{name}_0").build(_wide_frame(seed, corr),
                                                  str(out))
        jseg = load_segment(str(out / f"{name}_0"))
        got[name] = (jseg, carry(jseg, "hw"))
    jssb = j_ssb.build_segments(0, str(out / "ssb"), num_segments=2,
                                seed=5, rows=18_000, star_tree=False,
                                workers=1)
    got["ssb"] = (jssb[1], carry(jssb[1], "ssb_lineorder"))
    return got


SELECTIVE = ("SELECT a, b, year, sum(v), count(*), min(v), max(w), avg(w), "
             "minmaxrange(v) FROM hw WHERE v < 2 GROUP BY a, b, year "
             "LIMIT 15000")
TIED = ("SELECT a, b, year, sum(v), count(*), avg(v), sum(w) FROM hw "
        "GROUP BY a, b, year LIMIT 15000")
OVERFLOW = "SELECT a, b, year, sum(v) FROM hw GROUP BY a, b, year LIMIT 100000"

# (case id, segment, sql, sparse rung or None for the spec's own mode)
CASES = [
    ("dense scalar", "ssb", j_ssb.QUERIES["Q1.1"], None),
    ("dense scalar every agg", "wide",
     "SELECT count(*), sum(v), sum(w), min(w), max(v), avg(v), "
     "minmaxrange(w) FROM hw WHERE a IN ('a001', 'a017') OR year = 2002",
     None),
    ("dense grouped", "ssb", j_ssb.QUERIES["Q3.1"], None),
    ("dense, brands", "ssb", j_ssb.QUERIES["Q2.1"], None),
    ("compact", "wide",
     "SELECT a, b, sum(v), count(*), min(w) FROM hw WHERE a < 'a060' "
     "GROUP BY a, b LIMIT 15000", None),
    ("hash (cond)", "wide", SELECTIVE, None),
    ("hash", "wide", SELECTIVE, "hash"),
    ("sort", "wide", SELECTIVE, "sort"),
    ("tied hash (cond)", "tied", TIED, None),
    ("tied sort", "tied", TIED, "sort"),
    ("ssb hash (cond)", "ssb", j_ssb.QUERIES["Q3.2"], None),
    ("ssb sort", "ssb", j_ssb.QUERIES["Q4.3"], "sort"),
    ("overflow: hash flags it", "wide", OVERFLOW, "hash"),
    ("overflow: sort past K", "wide", OVERFLOW, "sort"),
    ("scalar distinctcount", "ssb",
     "SELECT count(DISTINCT p_brand1), count(*) FROM ssb_lineorder "
     "WHERE s_region = 'AMERICA'", None),
    ("scalar hll", "ssb",
     "SELECT distinctcounthll(p_brand1), distinctcounthll(lo_quantity) "
     "FROM ssb_lineorder WHERE s_region = 'EUROPE'", None),
    ("grouped hll", "ssb",
     "SELECT d_year, distinctcounthll(c_city), sum(lo_revenue) "
     "FROM ssb_lineorder WHERE s_region = 'EUROPE' GROUP BY d_year", None),
    ("gexpr keys", "ssb",
     "SELECT d_year * 100 + lo_discount, lo_quantity - lo_discount, "
     "sum(lo_revenue), max(lo_extendedprice * lo_discount) "
     "FROM ssb_lineorder WHERE lo_quantity < 10 "
     "GROUP BY d_year * 100 + lo_discount, lo_quantity - lo_discount", None),
    ("int min/max past 2^24", "ssb",
     "SELECT d_year, min(lo_extendedprice * lo_discount), "
     "max(lo_extendedprice * lo_discount) FROM ssb_lineorder "
     "GROUP BY d_year", None),
    ("lut and not", "ssb",
     "SELECT c_nation, sum(lo_revenue), count(*) FROM ssb_lineorder "
     "WHERE c_city IN ('CHINA    1', 'INDIA    4', 'PERU     7') "
     "OR NOT s_region = 'ASIA' GROUP BY c_nation", None),
]


def _plans(segs, name, sql):
    jseg, tseg = segs[name]
    jp = j_plan(j_compile(sql), jseg)
    tp = t_plan(t_compile(sql), tseg)
    assert tp.spec == jp.spec
    return jseg, tseg, jp, tp


def _run_jax(jseg, jp, rung):
    staged = JStaged(jseg)
    cols = {c: staged.column(c).tree() for c in jp.columns}
    body = jk.build_kernel_body(jp.spec, sparse_k=jk.sparse_mode(jp.spec),
                                sparse_rung=rung or "cond")
    out = jax.jit(body)(cols, tuple(jp.params), np.int32(jseg.num_docs),
                        jnp.int32(0))
    return jax.tree_util.tree_map(np.asarray, out)


def _run_port(tseg, tp, rung):
    staged = StagedSegment(tseg, device="cpu")
    cols = {c: staged.column(c).tree() for c in tp.columns}
    body = tk.build_kernel_body(tp.spec, sparse_k=tk.sparse_mode(tp.spec),
                                sparse_rung=rung or "cond")
    out = body(cols, tk.device_params(tp, CPU), tseg.num_docs, 0, CPU)
    return {k: (tuple(x.numpy() for x in v) if isinstance(v, tuple)
                else v.numpy()) for k, v in out.items()}


def _float_sum_leaves(spec):
    """Leaves that sum floats: compared within tolerance, all else
    exactly."""
    keys = set()
    for i, a in enumerate(spec[1]):
        if a[0] in ("sum", "avg") and a[3] in ("f32", "f64"):
            keys.add(f"agg{i}")
    return keys


def _assert_tree_equal(got, want, spec, what):
    assert sorted(got) == sorted(want), what
    approx = _float_sum_leaves(spec)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, tuple):
            assert isinstance(g, tuple) and len(g) == len(w), (what, key)
            pairs = [(g[j], w[j], key in approx and j == 0)
                     for j in range(len(w))]
        else:
            pairs = [(g, w, key in approx)]
        for gl, wl, close in pairs:
            gl, wl = np.asarray(gl), np.asarray(wl)
            assert gl.shape == wl.shape, (what, key)
            assert gl.dtype.kind == wl.dtype.kind, (what, key, gl.dtype,
                                                    wl.dtype)
            if close:
                np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{what}: {key}")
            else:
                np.testing.assert_array_equal(gl, wl, f"{what}: {key}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_body_equals_jax_leaf_by_leaf(segs, case):
    what, name, sql, rung = case
    jseg, tseg, jp, tp = _plans(segs, name, sql)
    want = _run_jax(jseg, jp, rung)
    got = _run_port(tseg, tp, rung)
    _assert_tree_equal(got, want, tp.spec, what)


def test_cases_cover_every_rung(segs):
    """The cases above reach dense, compact, the hash rung (cond mode
    served by the table) and the sort rung, and hash mode flags an
    overflow."""
    seen = set()
    for what, name, sql, rung in CASES:
        jseg, tseg, jp, tp = _plans(segs, name, sql)
        out = _run_port(tseg, tp, rung)
        if rung is None:
            seen.add(tk.grouped_rung(tp.spec, {"rung": out.get("rung")})
                     if tp.spec[2] else "scalar")
        elif rung == "hash" and int(out["rung"]):
            seen.add("hash overflow")
    assert {"dense", "compact", "hash", "scalar", "hash overflow"} <= seen


@pytest.mark.parametrize("knob", ["HASH_PROBES", "HASH_LIVE_DOCS"])
def test_cond_falls_back_to_sort_like_jax(segs, monkeypatch, knob):
    """tests/test_hash_groupby.py's forced fallbacks, in both modules: no
    probe pass, or a live window smaller than the matched docs; the cond
    mode then serves from the sort rung, in both packages alike."""
    value = {"HASH_PROBES": 0, "HASH_LIVE_DOCS": 64}[knob]
    monkeypatch.setattr(jk, knob, value)
    monkeypatch.setattr(tk, knob, value)
    jseg, tseg, jp, tp = _plans(segs, "wide", SELECTIVE)
    want = _run_jax(jseg, jp, None)
    got = _run_port(tseg, tp, None)
    assert int(got["rung"]) == 1 == int(want["rung"])
    _assert_tree_equal(got, want, tp.spec, knob)


def test_rung_constants_equal_jax():
    for name in ("_HASH_BITS", "HASH_TABLE_SLOTS", "HASH_PROBES",
                 "HASH_LIVE_DOCS", "_HASH_MULT", "COMPACT_MIN_GROUPS",
                 "COMPACT_K", "SPARSE_MIN_GROUPS", "_SENTINEL_KEY"):
        assert getattr(tk, name) == getattr(jk, name), name


def test_hash_slots_equal_jax_uint32():
    rng = np.random.default_rng(3)
    keys = np.concatenate([
        rng.integers(0, 1 << 31, 5000, dtype=np.int64),
        [0, 1, (1 << 31) - 1, (1 << 31) - 2, (1 << 21) - 1]]).astype(np.int32)
    want = np.asarray(((jnp.asarray(keys).astype(jnp.uint32)
                        * jnp.uint32(jk._HASH_MULT))
                       >> jnp.uint32(32 - jk._HASH_BITS)).astype(jnp.int32))
    got = tk._hash_slots(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_output_layout_and_pack_unpack_equal_jax(segs, case):
    """output_layout equal; the JAX body's own output tree packed and
    unpacked by each package gives the same host tree."""
    what, name, sql, rung = case
    jseg, tseg, jp, tp = _plans(segs, name, sql)
    spec = tp.spec
    assert tk.output_layout(spec) == jk.output_layout(spec)
    assert tk.output_layout(spec, 3) == jk.output_layout(spec, 3)
    assert tk.partial_reduce_ops(spec) == jk.partial_reduce_ops(spec)
    tree = _run_jax(jseg, jp, rung)
    if rung == "hash" and int(tree["rung"]):
        return  # an overflowed hash tree is discarded, never packed
    ttree = {k: (tuple(torch.tensor(x) for x in v) if isinstance(v, tuple)
                 else torch.tensor(v)) for k, v in tree.items()}
    packed = tk.pack_outputs(ttree, spec)
    assert packed.dtype == torch.float64
    jpacked = np.asarray(jk.pack_outputs(
        jax.tree_util.tree_map(jnp.asarray, tree), spec))
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    try:
        want = jk.unpack_outputs(jpacked, spec)
    except jk_PlanError as e:   # past the compact cap: both refuse alike
        with pytest.raises(t_PlanError) as te:
            tk.unpack_outputs(packed.numpy(), spec)
        assert te.value.reason_code == e.reason_code == "compact_cap_overflow"
        return
    got = tk.unpack_outputs(packed.numpy(), spec)
    assert sorted(got) == sorted(want)
    for k in want:
        w = want[k]
        g = got[k]
        if isinstance(w, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, k)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), k)


def test_overflow_unpack_raises_in_both(segs):
    """More live groups than the compact cap: the whole entry (body, pack,
    one copy) refuses at unpack in both packages, with one reason code."""
    jseg, tseg, jp, tp = _plans(segs, "wide", OVERFLOW)
    packed_j = np.asarray(jk.build_kernel(jp.spec)(
        {c: JStaged(jseg).column(c).tree() for c in jp.columns},
        tuple(jp.params), np.int32(jseg.num_docs)))
    with pytest.raises(jk_PlanError) as je:
        jk.unpack_outputs(packed_j, jp.spec)
    staged = StagedSegment(tseg, device="cpu")
    packed_t = tk.build_kernel(tp.spec)(
        {c: staged.column(c).tree() for c in tp.columns},
        tk.device_params(tp, CPU), tseg.num_docs)
    with pytest.raises(t_PlanError) as te:
        tk.unpack_outputs(packed_t.numpy(), tp.spec)
    assert te.value.reason_code == je.value.reason_code


def test_inputs_on_two_devices_are_refused(segs):
    _jseg, tseg, _jp, tp = _plans(segs, "ssb", j_ssb.QUERIES["Q2.3"])
    staged = StagedSegment(tseg, device="cpu")
    cols = {c: staged.column(c).tree() for c in tp.columns}
    params = list(tk.device_params(tp, CPU))
    params[0] = params[0].to("meta")
    with pytest.raises(ValueError, match="devices"):
        tk.build_kernel(tp.spec)(cols, tuple(params), tseg.num_docs)


def test_params_upload_once_per_plan_and_device(segs):
    _jseg, _tseg, _jp, tp = _plans(segs, "ssb", "SELECT distinctcounthll("
                                   "p_brand1) FROM ssb_lineorder")
    first = tk.device_params(tp, CPU)
    assert tk.device_params(tp, CPU) is first
    assert [p.dtype for p in first] == [torch.int32, torch.int32]
