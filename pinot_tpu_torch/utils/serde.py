"""Compact binary object serde for aggregation intermediate states.

Counterpart of ``pinot_tpu/common/serde.py`` (a copy: the idset state
and ``inIdSet`` encode through it).

Re-design of ``pinot-core/.../common/ObjectSerDeUtils.java`` (the custom
serializer registry for HLL/TDigest/Bitmap/IdSet intermediate objects): a
tagged, length-delimited binary encoding covering every intermediate-state
type the combine/reduce phases ship between server and broker — ints,
doubles (non-finite included), strings, bytes (sketch payloads), tuples
(AVG/MINMAXRANGE states), frozensets (DISTINCTCOUNT), lists, None, bools.

Unlike the reference there is no per-type registry index negotiated out of
band: each value is self-describing (one tag byte), so a DataTable payload
can be decoded without the query context. Varint lengths keep small states
small; numeric homogeneity is the DataTable's columnar layer's job, not
this one's.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

# tag bytes
_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03        # zigzag varint
_T_FLOAT = 0x04      # f64 big-endian (covers nan/inf exactly)
_T_STR = 0x05        # varint len + utf8
_T_BYTES = 0x06      # varint len + raw
_T_TUPLE = 0x07      # varint n + items
_T_FROZENSET = 0x08  # varint n + items
_T_LIST = 0x09       # varint n + items


def _write_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    shift = 0
    n = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def pack_obj(v: Any, out: bytearray) -> None:
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        out.append(_T_INT)
        _write_varint(out, (v << 1) if v >= 0 else ((-v << 1) | 1))
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out.extend(struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(_T_STR)
        _write_varint(out, len(raw))
        out.extend(raw)
    elif isinstance(v, bytes):
        out.append(_T_BYTES)
        _write_varint(out, len(v))
        out.extend(v)
    elif isinstance(v, tuple):
        out.append(_T_TUPLE)
        _write_varint(out, len(v))
        for x in v:
            pack_obj(x, out)
    elif isinstance(v, frozenset):
        out.append(_T_FROZENSET)
        _write_varint(out, len(v))
        for x in sorted(v, key=lambda e: (str(type(e)), str(e))):
            pack_obj(x, out)
    elif isinstance(v, list):
        out.append(_T_LIST)
        _write_varint(out, len(v))
        for x in v:
            pack_obj(x, out)
    elif hasattr(v, "item"):  # numpy scalar
        pack_obj(v.item(), out)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__} for the wire")


def unpack_obj(buf: bytes, off: int = 0) -> Tuple[Any, int]:
    tag = buf[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_INT:
        z, off = _read_varint(buf, off)
        return (-(z >> 1) if z & 1 else (z >> 1)), off
    if tag == _T_FLOAT:
        return struct.unpack_from(">d", buf, off)[0], off + 8
    if tag == _T_STR:
        n, off = _read_varint(buf, off)
        return buf[off:off + n].decode("utf-8"), off + n
    if tag == _T_BYTES:
        n, off = _read_varint(buf, off)
        return bytes(buf[off:off + n]), off + n
    if tag in (_T_TUPLE, _T_FROZENSET, _T_LIST):
        n, off = _read_varint(buf, off)
        items: List[Any] = []
        for _ in range(n):
            x, off = unpack_obj(buf, off)
            items.append(x)
        if tag == _T_TUPLE:
            return tuple(items), off
        if tag == _T_FROZENSET:
            return frozenset(items), off
        return items, off
    raise ValueError(f"unknown serde tag 0x{tag:02x}")


def dumps(v: Any) -> bytes:
    out = bytearray()
    pack_obj(v, out)
    return bytes(out)


def loads(raw: bytes) -> Any:
    v, off = unpack_obj(raw, 0)
    if off != len(raw):
        raise ValueError(f"trailing bytes after object ({len(raw) - off})")
    return v
