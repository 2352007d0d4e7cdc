"""Host helpers of the on-disk segments, in C++ bound with ``ctypes``.

Counterpart of ``pinot_tpu/native/__init__.py``: the fixed-bit packing of
a single-value column's dictIds (``bitpack`` / ``bitunpack``), refcounted
read-only file mappings (``MmapBuffer``, ``mmap_buffer_count``), the CRC-32
of a file (``crc32_file``) and the delta+varint posting lists of the
inverted, text and JSON indexes (``varint_encode``,
``varint_encode_lists``, ``varint_decode``, ``varint_decode_lists``). The
source is the port's own copy, ``pinot_native.cpp`` beside this file. It
is compiled with ``g++`` at first use into ``pinot_tpu_torch/_build/``
(the library's name carries a hash of the source, so an edited source is
rebuilt), and a failed build raises: there is no fallback. The plain
numpy versions (``*_plain``) compute the same bytes; the tests hold the
C++ helpers to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "pinot_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_library() -> str:
    """Compile ``pinot_native.cpp`` unless an up-to-date build exists;
    -> the library path. Raises when ``g++`` fails."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libpinot_native-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            _declare(lib)
            _lib = lib
    return _lib


def library_path() -> Optional[str]:
    """The loaded library's file, or None before the first use."""
    return None if _lib is None else _lib._name


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64, i32, ptr = c.c_int64, c.c_int32, c.c_void_p
    sigs = {
        "pn_packed_size": (i64, [i64, i32]),
        "pn_bitpack_i32": (i64, [ptr, i64, i32, ptr, i64]),
        "pn_bitunpack_i32": (i64, [ptr, i64, i64, i32, ptr]),
        "pn_mmap_open": (i64, [c.c_char_p]),
        "pn_mmap_addr": (ptr, [i64]),
        "pn_mmap_size": (i64, [i64]),
        "pn_mmap_acquire": (i32, [i64]),
        "pn_mmap_release": (i32, [i64]),
        "pn_mmap_open_count": (i64, []),
        "pn_crc32_file": (i64, [c.c_char_p, c.c_uint32]),
        "pn_varint_encode": (i64, [ptr, i64, ptr, i64]),
        "pn_varint_decode": (i64, [ptr, i64, ptr, i64]),
        "pn_varint_encode_lists": (i64, [ptr, ptr, i64, ptr, i64, ptr]),
        "pn_varint_decode_lists": (i64, [ptr, i64, ptr, ptr, i64, ptr]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


# -- fixed-bit packing ----------------------------------------------------------

def bits_needed(cardinality: int) -> int:
    """Bits per dictId of a dictionary of ``cardinality`` values."""
    return max(1, int(cardinality - 1).bit_length())


def packed_size(n: int, bits: int) -> int:
    """Bytes of ``n`` packed values: whole 64-bit words."""
    return (n * bits + 63) // 64 * 8


def bitpack(values: np.ndarray, bits: int) -> bytes:
    """int32 values (each below ``2**bits``) -> packed little-endian
    64-bit words, value ``i`` at bit ``i * bits``."""
    values = np.ascontiguousarray(values, dtype=np.int32)
    n = values.shape[0]
    cap = packed_size(n, bits)
    out = np.empty(cap, dtype=np.uint8)
    wrote = load().pn_bitpack_i32(values.ctypes.data, n, bits,
                                  out.ctypes.data, cap)
    if wrote != cap:
        raise ValueError(f"bitpack failed (bits={bits})")
    return out.tobytes()


def bitunpack(buf, n: int, bits: int) -> np.ndarray:
    """Packed bytes (any buffer) -> int32 array of ``n`` values."""
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(n, dtype=np.int32)
    got = load().pn_bitunpack_i32(src.ctypes.data, src.shape[0], n, bits,
                                  out.ctypes.data)
    if got != n:
        raise ValueError(f"bitunpack failed (n={n}, bits={bits}, "
                         f"{src.shape[0]} bytes)")
    return out


def bitpack_plain(values: np.ndarray, bits: int) -> bytes:
    """``bitpack`` in numpy."""
    values = np.ascontiguousarray(values, dtype=np.int32)
    n = values.shape[0]
    bit_idx = (np.arange(n, dtype=np.int64)[:, None] * bits
               + np.arange(bits, dtype=np.int64)[None, :]).ravel()
    bit_vals = ((values.astype(np.uint64)[:, None]
                 >> np.arange(bits, dtype=np.uint64)[None, :]) & 1).ravel()
    words = np.zeros((n * bits + 63) // 64, dtype=np.uint64)
    np.bitwise_or.at(words, bit_idx >> 6,
                     bit_vals << (bit_idx & 63).astype(np.uint64))
    return words.astype("<u8").tobytes()


def bitunpack_plain(buf, n: int, bits: int) -> np.ndarray:
    """``bitunpack`` in numpy."""
    raw = bytes(buf)
    words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 8), dtype="<u8")
    bit_idx = (np.arange(n, dtype=np.int64)[:, None] * bits
               + np.arange(bits, dtype=np.int64)[None, :])
    bit_vals = (words[bit_idx >> 6] >> (bit_idx & 63).astype(np.uint64)) & 1
    weights = np.uint64(1) << np.arange(bits, dtype=np.uint64)
    return (bit_vals * weights[None, :]).sum(axis=1).astype(np.int32)


# -- refcounted file mappings -------------------------------------------------------

class _MappedView:
    """A numpy array interface over mapped bytes holding one reference
    to its ``MmapBuffer``: the mapping outlives every array read from
    it, whoever else releases the buffer."""

    def __init__(self, buf: "MmapBuffer", addr: int, dtype: np.dtype,
                 count: int):
        if not buf.acquire():
            raise ValueError(f"{buf.path!r} is no longer mapped")
        self._buf = buf
        self.__array_interface__ = {
            "version": 3, "shape": (count,), "typestr": dtype.str,
            "descr": dtype.descr, "data": (addr, True)}

    def __del__(self):
        try:
            self._buf.release()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


class MmapBuffer:
    """A read-only mapping of one file with a process-wide refcount
    (``pn_mmap_*``): it is unmapped when the last reference goes. The
    buffer holds one reference from its opening until ``release``; each
    view ``as_array`` gives holds one of its own until it is collected, so
    a view never outlives its mapping. On Linux a mapped file that is
    deleted stays readable through the mapping. An empty file maps
    nothing and reads as an empty array."""

    def __init__(self, path: str):
        self.path = path
        self._lib = load()
        self._handle = 0
        self._refs = 0
        self._addr = 0
        self.size = os.path.getsize(path)
        if self.size == 0:
            return
        h = self._lib.pn_mmap_open(path.encode())
        if h <= 0:
            raise OSError(f"cannot map {path!r}")
        self._handle = h
        self._refs = 1
        self._addr = self._lib.pn_mmap_addr(h)

    def as_array(self, dtype, count: int = -1, offset: int = 0
                 ) -> np.ndarray:
        dtype = np.dtype(dtype)
        avail = (self.size - offset) // dtype.itemsize
        count = avail if count < 0 else count
        if offset < 0 or count < 0 or count > avail:
            raise ValueError(f"{self.path!r}: {count} x {dtype} at {offset} "
                             f"past its {self.size} bytes")
        if count == 0:
            return np.empty(0, dtype=dtype)
        arr = np.asarray(_MappedView(self, self._addr + offset, dtype, count))
        arr.flags.writeable = False
        return arr

    def read(self) -> bytes:
        return self.as_array(np.uint8).tobytes()

    def acquire(self) -> bool:
        """One more reference; False once the mapping is gone."""
        if self._handle and self._lib.pn_mmap_acquire(self._handle):
            self._refs += 1
            return True
        return False

    def release(self) -> None:
        """Give back one reference this object holds (a release beyond
        them does nothing); the mapping goes with the last."""
        if self._handle and self._refs > 0:
            self._refs -= 1
            if self._lib.pn_mmap_release(self._handle) <= 0:
                self._handle = 0

    def __del__(self):
        try:
            while self._handle and self._refs > 0:
                self.release()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


def mmap_buffer_count() -> int:
    """Files mapped by ``MmapBuffer`` in this process now."""
    return int(load().pn_mmap_open_count())


def load_npy(path: str) -> np.ndarray:
    """A ``.npy`` file as a read-only array over its ``MmapBuffer`` (what
    ``np.load(path, mmap_mode="r")`` reads, without holding a file
    descriptor open)."""
    buf = MmapBuffer(path)
    head = buf.as_array(np.uint8, count=min(buf.size, 4096)).tobytes()
    import io

    f = io.BytesIO(head)
    major, _minor = np.lib.format.read_magic(f)
    if major == 1:
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    else:
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    if dtype.hasobject:
        raise ValueError(f"{path!r}: object arrays are not a segment file")
    count = int(np.prod(shape, dtype=np.int64))
    flat = buf.as_array(dtype, count=count, offset=f.tell())
    return flat.reshape(shape, order="F" if fortran else "C")


# -- CRC ---------------------------------------------------------------------------

def crc32_file(path: str, seed: int = 0) -> int:
    """zlib's CRC-32 of a file's bytes, continuing from ``seed``."""
    v = load().pn_crc32_file(path.encode(), seed & 0xFFFFFFFF)
    if v < 0:
        raise OSError(f"cannot read {path!r}")
    return int(v) & 0xFFFFFFFF


def crc32_file_plain(path: str, seed: int = 0) -> int:
    crc = seed
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


# -- delta + varint posting lists ----------------------------------------------------

def varint_encode(doc_ids: np.ndarray) -> bytes:
    """Ascending int32 doc ids -> delta+varint bytes."""
    doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int32)
    cap = doc_ids.shape[0] * 5 + 16
    out = np.empty(cap, dtype=np.uint8)
    wrote = load().pn_varint_encode(doc_ids.ctypes.data, doc_ids.shape[0],
                                    out.ctypes.data, cap)
    if wrote < 0:
        raise ValueError("varint encode overflow")
    return out[:wrote].tobytes()


def varint_encode_lists(docs: np.ndarray, offsets: np.ndarray
                        ) -> Tuple[bytes, np.ndarray]:
    """Encode the lists ``docs[offsets[i]:offsets[i + 1]]`` in one pass;
    -> (the bytes, int64 byte offsets [lists + 1])."""
    docs = np.ascontiguousarray(docs, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    num_lists = offsets.shape[0] - 1
    cap = docs.shape[0] * 5 + 16
    out = np.empty(cap, dtype=np.uint8)
    byte_offsets = np.empty(num_lists + 1, dtype=np.int64)
    wrote = load().pn_varint_encode_lists(
        docs.ctypes.data, offsets.ctypes.data, num_lists, out.ctypes.data,
        cap, byte_offsets.ctypes.data)
    if wrote < 0:
        raise ValueError("varint encode overflow")
    return out[:wrote].tobytes(), byte_offsets


def varint_decode(buf, n: int) -> np.ndarray:
    """``n`` ids of one delta+varint list."""
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(n, dtype=np.int32)
    if n and load().pn_varint_decode(src.ctypes.data, src.shape[0],
                                     out.ctypes.data, n) != n:
        raise ValueError("varint decode failed")
    return out


def varint_decode_lists(buf, byte_offsets: np.ndarray,
                        offsets: np.ndarray) -> np.ndarray:
    """Every list of ``varint_encode_lists``'s bytes, back to the flat
    int32 ids (list ``i`` at ``[offsets[i]:offsets[i + 1]]``)."""
    src = np.frombuffer(buf, dtype=np.uint8)
    byte_offsets = np.ascontiguousarray(byte_offsets, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    num_lists = offsets.shape[0] - 1
    total = int(offsets[-1]) if num_lists >= 0 and offsets.size else 0
    out = np.empty(total, dtype=np.int32)
    if num_lists > 0 and load().pn_varint_decode_lists(
            src.ctypes.data, src.shape[0], byte_offsets.ctypes.data,
            offsets.ctypes.data, num_lists, out.ctypes.data) != total:
        raise ValueError("varint decode of the posting lists failed")
    return out


def varint_encode_plain(doc_ids: np.ndarray) -> bytes:
    out = bytearray()
    prev = 0
    for v in np.asarray(doc_ids, dtype=np.int64).tolist():
        d = (v - prev) & 0xFFFFFFFF
        prev = v
        while d >= 0x80:
            out.append((d & 0x7F) | 0x80)
            d >>= 7
        out.append(d)
    return bytes(out)


def varint_encode_lists_plain(docs: np.ndarray, offsets: np.ndarray
                              ) -> Tuple[bytes, np.ndarray]:
    blobs = []
    byte_offsets = np.zeros(len(offsets), dtype=np.int64)
    for i in range(len(offsets) - 1):
        enc = varint_encode_plain(docs[offsets[i]:offsets[i + 1]])
        blobs.append(enc)
        byte_offsets[i + 1] = byte_offsets[i] + len(enc)
    return b"".join(blobs), byte_offsets


def varint_decode_plain(buf, n: int) -> np.ndarray:
    raw = bytes(buf)
    out = []
    prev = i = 0
    for _ in range(n):
        d = shift = 0
        while True:
            b = raw[i]
            i += 1
            d |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        prev = (prev + d) & 0xFFFFFFFF
        out.append(prev)
    return np.asarray(out, dtype=np.uint32).view(np.int32)


__all__ = [
    "build_library", "load", "library_path", "bits_needed", "packed_size",
    "bitpack", "bitunpack", "bitpack_plain", "bitunpack_plain",
    "MmapBuffer", "mmap_buffer_count", "load_npy", "crc32_file",
    "crc32_file_plain", "varint_encode", "varint_encode_lists",
    "varint_decode", "varint_decode_lists", "varint_encode_plain",
    "varint_encode_lists_plain", "varint_decode_plain",
]
