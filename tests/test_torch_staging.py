"""Port staging against the JAX package's: planar packed words bit-equal for
every bit width, value columns equal, on segments ending in a remainder
tile (mirrors tests/test_pallas.py::test_packed_layout_roundtrip)."""

import numpy as np
import pytest

from pinot_tpu.engine import ensure_x64

ensure_x64()   # i64 value columns, as the JAX executor stages them

from pinot_tpu.engine.staging import PALLAS_TILE, StagingCache  # noqa: E402
from pinot_tpu.segment import SegmentBuilder, load_segment  # noqa: E402
from pinot_tpu.spi import DataType, FieldSpec, FieldType, Schema  # noqa: E402
from pinot_tpu_torch.engine import staging as tstaging  # noqa: E402
from pinot_tpu_torch.segment import columns_of, segment_from_arrays  # noqa: E402

N = 70_500   # 18 tiles, the last one partial; cardinality 70k needs 32 bits

# column -> expected packed bit width
WIDTHS = {"c1": 1, "c2": 2, "c4": 4, "c8": 8, "c16": 16, "c32": 32}


@pytest.fixture(scope="module")
def segs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_staging")
    rng = np.random.default_rng(5)
    schema = Schema("st", [
        FieldSpec("c1", DataType.INT), FieldSpec("c2", DataType.STRING),
        FieldSpec("c4", DataType.INT), FieldSpec("c8", DataType.STRING),
        FieldSpec("c16", DataType.INT), FieldSpec("c32", DataType.INT),
        FieldSpec("qty", DataType.INT, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC),
        FieldSpec("big", DataType.LONG, FieldType.METRIC),
    ])
    frame = {
        "c1": rng.integers(0, 2, N),
        "c2": np.array(["w", "x", "y"])[rng.integers(0, 3, N)],
        "c4": rng.integers(0, 11, N),
        "c8": np.array([f"s{i:03d}" for i in range(137)])[
            rng.integers(0, 137, N)],
        "c16": rng.integers(0, 3000, N),
        "c32": np.arange(N),
        "qty": rng.integers(-50, 100, N),
        "price": np.round(rng.normal(80.0, 30.0, N), 2),
        "big": rng.integers(0, 1 << 40, N) - (1 << 39),
    }
    SegmentBuilder(schema, "st_0").build(frame, str(out))
    jseg = load_segment(str(out / "st_0"))
    tseg = segment_from_arrays("st_0", jseg.num_docs, columns_of(jseg),
                               table_name="st")
    return jseg, tseg


def test_fixture_ends_in_remainder_tile(segs):
    jseg, _ = segs
    assert jseg.num_docs % PALLAS_TILE != 0
    assert tstaging.TILE == PALLAS_TILE


@pytest.mark.parametrize("col", sorted(WIDTHS))
def test_packed_words_bit_equal(segs, col):
    jseg, tseg = segs
    jpc = StagingCache().stage(jseg).packed_column(col)
    tpc = tstaging.StagedSegment(tseg, device="cpu").packed_column(col)
    assert jpc.bits == tpc.bits == WIDTHS[col]
    jw = np.asarray(jpc.words)
    tw = tpc.words.numpy().view(np.uint32)
    assert tw.shape == jw.shape
    np.testing.assert_array_equal(tw, jw)
    # and the plain unpack recovers the forward index
    from pinot_tpu_torch.engine.fused_scan import unpack_planar

    ids = unpack_planar(tpc.words, tpc.bits).numpy()
    fwd = np.asarray(jseg.data_source(col).forward_index)
    np.testing.assert_array_equal(ids[:fwd.shape[0]], fwd)


@pytest.mark.parametrize("col", ["qty", "price", "big", "c16"])
def test_value_columns_equal(segs, col):
    jseg, tseg = segs
    jv = np.asarray(StagingCache().stage(jseg).value_column(col))
    tv = tstaging.StagedSegment(tseg, device="cpu").value_column(col).numpy()
    assert tv.dtype == jv.dtype
    np.testing.assert_array_equal(tv, jv)


def test_pack_bits_and_capacity_match(segs):
    from pinot_tpu.engine.staging import pack_bits

    jseg, tseg = segs
    for b in range(1, 33):
        assert tstaging.pack_bits(b) == pack_bits(b)
    jst = StagingCache().stage(jseg)
    tst = tstaging.StagedSegment(tseg, device="cpu")
    assert tst.scan_capacity() == jst.pallas_capacity()
    assert tseg.padded_capacity == jseg.padded_capacity
