"""The port's native host helpers (``pinot_tpu_torch/native``) against the
JAX package's (``pinot_tpu.native``, oracle tests/test_native.py).

The C++ helpers equal their plain numpy versions, and both equal the JAX
package's, byte for byte: bit-packing at every width 1-31, varint posting
lists, the CRC-32 of a file (also ``zlib.crc32``). The mappings keep a
refcount, views keep their mapping alive, and ``load_npy`` reads what
``np.load`` reads. The library is the port's own build under
``pinot_tpu_torch/_build/``, and a failed build raises.
"""

import gc
import os
import zlib

import numpy as np
import pytest

from pinot_tpu import native as jnative
from pinot_tpu_torch import native


@pytest.mark.parametrize("bits", range(1, 32))
def test_bitpack_every_width_equals_plain_and_jax(bits):
    rng = np.random.default_rng(bits)
    n = 1000 + bits     # a tail that ends inside a word
    vals = rng.integers(0, 1 << bits, n).astype(np.int32)
    packed = native.bitpack(vals, bits)
    assert len(packed) == native.packed_size(n, bits)
    assert packed == native.bitpack_plain(vals, bits)
    assert packed == jnative.bitpack(vals, bits)
    for out in (native.bitunpack(packed, n, bits),
                native.bitunpack_plain(packed, n, bits),
                jnative.bitunpack(packed, n, bits)):
        np.testing.assert_array_equal(out, vals)


def test_bits_needed_matches_jax():
    for card in (1, 2, 3, 4, 255, 256, 257, 1 << 20, (1 << 20) + 1):
        assert native.bits_needed(card) == jnative.bits_needed(card)


def test_bitunpack_refuses_a_short_buffer():
    with pytest.raises(ValueError):
        native.bitunpack(b"\x00" * 8, 100, 7)


def test_varint_single_list():
    rng = np.random.default_rng(4)
    ids = np.unique(rng.integers(0, 2_000_000_000, 20_000)).astype(np.int32)
    enc = native.varint_encode(ids)
    assert enc == native.varint_encode_plain(ids) == jnative.varint_encode(ids)
    for out in (native.varint_decode(enc, len(ids)),
                native.varint_decode_plain(enc, len(ids)),
                jnative.varint_decode(enc, len(ids))):
        np.testing.assert_array_equal(out, ids)
    with pytest.raises(ValueError):
        native.varint_decode(enc[:-1], len(ids))


def test_varint_lists_with_empty_lists():
    rng = np.random.default_rng(5)
    sizes = [0, 3, 0, 0, 500, 1, 0, 40]
    docs = np.concatenate([np.sort(rng.choice(10_000, s, replace=False))
                           for s in sizes]).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    blob, bo = native.varint_encode_lists(docs, offsets)
    pblob, pbo = native.varint_encode_lists_plain(docs, offsets)
    jblob, jbo = jnative.varint_encode_lists(docs, offsets)
    assert blob == pblob == jblob
    np.testing.assert_array_equal(bo, pbo)
    np.testing.assert_array_equal(bo, jbo)
    np.testing.assert_array_equal(
        native.varint_decode_lists(blob, bo, offsets), docs)
    # no list at all
    empty, ebo = native.varint_encode_lists(np.empty(0, np.int32),
                                            np.zeros(1, np.int64))
    assert empty == b"" and ebo.tolist() == [0]
    assert native.varint_decode_lists(empty, ebo,
                                      np.zeros(1, np.int64)).size == 0
    with pytest.raises(ValueError):
        native.varint_decode_lists(blob[:-2], bo, offsets)


def test_crc32_file(tmp_path):
    p = tmp_path / "blob.bin"
    data = np.random.default_rng(1).bytes(300_001)
    p.write_bytes(data)
    want = zlib.crc32(data) & 0xFFFFFFFF
    assert native.crc32_file(str(p)) == want
    assert native.crc32_file_plain(str(p)) == want
    assert native.crc32_file(str(p)) == jnative.crc32_file(str(p))
    # chained over two files as compute_dir_crc chains them
    q = tmp_path / "two.bin"
    q.write_bytes(b"abc")
    assert native.crc32_file(str(q), want) == zlib.crc32(b"abc", want)
    with pytest.raises(OSError):
        native.crc32_file(str(tmp_path / "missing"))


def test_mmap_refcount_and_views_keep_the_mapping(tmp_path):
    p = tmp_path / "a.npy"
    np.save(p, np.arange(1000, dtype=np.int64))
    gc.collect()
    base = native.mmap_buffer_count()
    buf = native.MmapBuffer(str(p))
    assert native.mmap_buffer_count() == base + 1
    assert buf.acquire()
    buf.release()
    assert native.mmap_buffer_count() == base + 1
    arr = buf.as_array(np.int64, offset=128)
    buf.release()       # the view holds a reference of its own
    del buf
    gc.collect()
    assert native.mmap_buffer_count() == base + 1
    assert not arr.flags.writeable
    os.unlink(p)        # a mapped file that is deleted stays readable
    assert int(arr.sum()) == 999 * 1000 // 2    # 128: the .npy header
    del arr
    gc.collect()
    assert native.mmap_buffer_count() == base


def test_empty_file_maps_nothing(tmp_path):
    p = tmp_path / "e.bin"
    p.write_bytes(b"")
    gc.collect()
    base = native.mmap_buffer_count()
    buf = native.MmapBuffer(str(p))
    assert buf.size == 0 and buf.as_array(np.uint8).size == 0
    assert native.mmap_buffer_count() == base


@pytest.mark.parametrize("arr", [
    np.arange(7, dtype=np.int8), np.linspace(0, 1, 9),
    np.arange(12, dtype=np.int32).reshape(3, 4), np.zeros(5, dtype=bool),
    np.zeros(3, dtype=[("a", np.int32), ("b", np.int64)]),
    np.empty(0, dtype=np.uint64)], ids=str)
def test_load_npy_equals_np_load(tmp_path, arr):
    p = tmp_path / "x.npy"
    np.save(p, arr)
    got = native.load_npy(str(p))
    want = np.load(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_library_is_the_ports_own_build():
    native.load()
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert "pinot_tpu_torch" in path
    assert os.path.samefile(os.path.dirname(native.SRC),
                            os.path.dirname(native.__file__))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library()
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]
