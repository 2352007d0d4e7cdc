"""Chunked codecs of a raw column's forward index on disk.

Counterpart of ``pinot_tpu/segment/compression.py`` (the file format
byte for byte): a raw column whose field config names a codec is stored
as independently compressed chunks of ``DEFAULT_CHUNK_DOCS`` values
behind a header (``PCC1``, codec, docs, chunk docs, item size, dtype,
chunk sizes). The loader decompresses the whole column once, since
staging wants the dense array. ZSTANDARD is written only where
``zstandard`` imports (SNAPPY and LZ4 land on it too), else ZLIB, and the
header records the codec used, so a reader never guesses. Reading a
ZSTANDARD file where ``zstandard`` is missing raises: there is no
fallback.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional

import numpy as np

MAGIC = b"PCC1"
DEFAULT_CHUNK_DOCS = 64 * 1024

_ZLIB = 0
_ZSTD = 1
_PASS = 2

try:
    import zstandard as _zstd_mod
except ImportError:
    _zstd_mod = None


def _codec_id(name: str) -> int:
    n = (name or "").upper()
    if n in ("PASS_THROUGH", "PASSTHROUGH", "NONE"):
        return _PASS
    if n in ("GZIP", "ZLIB", "DEFLATE"):
        return _ZLIB
    # SNAPPY / LZ4 / ZSTANDARD land on zstd where it imports, zlib
    # otherwise
    if n in ("ZSTANDARD", "ZSTD", "SNAPPY", "LZ4", ""):
        return _ZSTD if _zstd_mod is not None else _ZLIB
    raise ValueError(f"unknown compression codec {name!r}")


def _compress(codec: int, raw: bytes) -> bytes:
    if codec == _PASS:
        return raw
    if codec == _ZLIB:
        return zlib.compress(raw, 6)
    return _zstd_mod.ZstdCompressor(level=3).compress(raw)


def _decompress(codec: int, blob: bytes, out_len: int) -> bytes:
    if codec == _PASS:
        return blob
    if codec == _ZLIB:
        return zlib.decompress(blob)
    if codec != _ZSTD:
        raise ValueError(f"unknown chunk codec id {codec}")
    if _zstd_mod is None:
        raise RuntimeError("a ZSTANDARD-compressed column needs the "
                           "zstandard module, which this host lacks")
    return _zstd_mod.ZstdDecompressor().decompress(blob, max_output_size=out_len)


def write_compressed(path: str, values: np.ndarray, codec_name: str,
                     chunk_docs: int = DEFAULT_CHUNK_DOCS) -> str:
    """Write ``values`` as compressed chunks; returns the codec label
    actually used (recorded in column metadata)."""
    codec = _codec_id(codec_name)
    values = np.ascontiguousarray(values)
    n = values.shape[0]
    itemsize = values.dtype.itemsize
    chunks: List[bytes] = []
    for start in range(0, max(n, 1), chunk_docs):
        raw = values[start:start + chunk_docs].tobytes()
        chunks.append(_compress(codec, raw))
    with open(path, "wb") as f:
        header = MAGIC + struct.pack(
            "<BIIH", codec, n, chunk_docs, itemsize)
        dtype_label = values.dtype.str.encode("ascii")
        header += struct.pack("<H", len(dtype_label)) + dtype_label
        f.write(header)
        f.write(struct.pack("<I", len(chunks)))
        for c in chunks:
            f.write(struct.pack("<I", len(c)))
        for c in chunks:
            f.write(c)
    return {_ZLIB: "ZLIB", _ZSTD: "ZSTANDARD", _PASS: "PASS_THROUGH"}[codec]


def read_compressed(path: str, doc_range: Optional[tuple] = None,
                    blob: Optional[bytes] = None) -> np.ndarray:
    """Load the full column (or ``doc_range=(start, stop)``), decompressing
    only the covering chunks; ``blob`` is the file's bytes when the caller
    holds them already."""
    if blob is None:
        with open(path, "rb") as f:
            blob = f.read()
    if blob[:4] != MAGIC:
        raise ValueError(f"{path}: not a compressed chunk file")
    off = 4
    codec, n, chunk_docs, itemsize = struct.unpack_from("<BIIH", blob, off)
    off += struct.calcsize("<BIIH")
    (dl,) = struct.unpack_from("<H", blob, off)
    off += 2
    dtype = np.dtype(blob[off:off + dl].decode("ascii"))
    off += dl
    (num_chunks,) = struct.unpack_from("<I", blob, off)
    off += 4
    sizes = struct.unpack_from(f"<{num_chunks}I", blob, off)
    off += 4 * num_chunks
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off

    lo_chunk, hi_chunk = 0, num_chunks
    if doc_range is not None:
        lo, hi = doc_range
        lo_chunk = max(0, lo // chunk_docs)
        hi_chunk = min(num_chunks, -(-hi // chunk_docs))
    parts = []
    for ci in range(lo_chunk, hi_chunk):
        docs_in_chunk = min(chunk_docs, n - ci * chunk_docs)
        raw = _decompress(codec, blob[starts[ci]:starts[ci + 1]],
                          docs_in_chunk * itemsize)
        parts.append(np.frombuffer(raw, dtype=dtype))
    out = (np.concatenate(parts) if parts
           else np.empty(0, dtype=dtype))
    if doc_range is not None:
        lo, hi = doc_range
        base = lo_chunk * chunk_docs
        return out[lo - base:hi - base]
    return out
