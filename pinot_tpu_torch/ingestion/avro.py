"""Avro object container files: the reader and the writer, in pure Python.

Counterpart of ``pinot_tpu/ingestion/avro.py`` (the reference's
``AvroRecordReader`` over org.apache.avro): the container framing (magic,
metadata map, sync-delimited blocks, the ``null`` and ``deflate``
codecs) and the binary encoding (zigzag varints, length-prefixed bytes
and strings, block-encoded arrays and maps, index-prefixed unions,
record fields in order, named types). ``read_container`` (JAX :165)
decodes a file and ``write_container`` (JAX :314) writes one; each
package reads the other's files. Logical types decode as their
underlying primitive.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, Iterator, List, Tuple, Union

MAGIC = b"Obj\x01"

SchemaT = Union[str, dict, list]


class AvroError(ValueError):
    pass


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise AvroError("truncated avro data")
        self.pos += n
        return b

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            if self.pos >= len(self.buf):
                raise AvroError("truncated avro data (mid-varint)")
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())


class _Decoder:
    """Schema-driven value decoder with a named-type registry."""

    def __init__(self, schema: SchemaT):
        self.named: Dict[str, dict] = {}
        self.schema = self._register(schema)

    def _register(self, s: SchemaT) -> SchemaT:
        if isinstance(s, dict):
            t = s.get("type")
            if t in ("record", "enum", "fixed"):
                name = s.get("name", "")
                ns = s.get("namespace", "")
                full = f"{ns}.{name}" if ns and "." not in name else name
                self.named[full] = s
                self.named[name] = s
                if t == "record":
                    for f in s.get("fields", []):
                        f["type"] = self._register(f["type"])
            elif t == "array":
                s["items"] = self._register(s["items"])
            elif t == "map":
                s["values"] = self._register(s["values"])
        elif isinstance(s, list):
            return [self._register(x) for x in s]
        return s

    def decode(self, c: _Cursor, s: SchemaT) -> Any:
        if isinstance(s, list):  # union: long index + value
            idx = c.read_long()
            if not 0 <= idx < len(s):
                raise AvroError(f"union index {idx} out of range")
            return self.decode(c, s[idx])
        if isinstance(s, str):
            if s in self.named:
                return self.decode(c, self.named[s])
            return self._primitive(c, s)
        t = s["type"]
        if isinstance(t, (dict, list)):
            return self.decode(c, t)
        if t == "record":
            return {f["name"]: self.decode(c, f["type"])
                    for f in s["fields"]}
        if t == "enum":
            symbols = s["symbols"]
            i = c.read_long()
            if not 0 <= i < len(symbols):
                raise AvroError(f"enum index {i} out of range")
            return symbols[i]
        if t == "array":
            out: List[Any] = []
            while True:
                n = c.read_long()
                if n == 0:
                    break
                if n < 0:  # block size follows (skippable form)
                    c.read_long()
                    n = -n
                for _ in range(n):
                    out.append(self.decode(c, s["items"]))
            return out
        if t == "map":
            m: Dict[str, Any] = {}
            while True:
                n = c.read_long()
                if n == 0:
                    break
                if n < 0:
                    c.read_long()
                    n = -n
                for _ in range(n):
                    k = c.read_bytes().decode("utf-8")
                    m[k] = self.decode(c, s["values"])
            return m
        if t == "fixed":
            return c.read(int(s["size"]))
        if t in self.named and t not in ("record", "enum", "fixed"):
            return self.decode(c, self.named[t])
        return self._primitive(c, t)

    @staticmethod
    def _primitive(c: _Cursor, t: str) -> Any:
        if t == "null":
            return None
        if t == "boolean":
            return c.read(1)[0] != 0
        if t in ("int", "long"):
            return c.read_long()
        if t == "float":
            return struct.unpack("<f", c.read(4))[0]
        if t == "double":
            return struct.unpack("<d", c.read(8))[0]
        if t == "bytes":
            return c.read_bytes()
        if t == "string":
            return c.read_bytes().decode("utf-8")
        raise AvroError(f"unknown avro type {t!r}")


def read_container(path: str) -> Tuple[SchemaT, Iterator[Any]]:
    """-> (writer schema, iterator of decoded values)."""
    with open(path, "rb") as f:
        blob = f.read()
    c = _Cursor(blob)
    if c.read(4) != MAGIC:
        raise AvroError(f"{path}: not an avro container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = c.read_long()
        if n == 0:
            break
        if n < 0:
            c.read_long()
            n = -n
        for _ in range(n):
            k = c.read_bytes().decode("utf-8")
            meta[k] = c.read_bytes()
    sync = c.read(16)
    try:
        schema = json.loads(meta["avro.schema"].decode("utf-8"))
    except KeyError:
        raise AvroError(f"{path}: missing avro.schema metadata")
    codec = meta.get("avro.codec", b"null").decode("ascii")
    if codec not in ("null", "deflate"):
        raise AvroError(f"unsupported avro codec {codec!r}")
    dec = _Decoder(schema)

    def rows() -> Iterator[Any]:
        while c.pos < len(c.buf):
            count = c.read_long()
            size = c.read_long()
            data = c.read(size)
            if codec == "deflate":
                data = zlib.decompress(data, -15)
            if c.read(16) != sync:
                raise AvroError("sync marker mismatch")
            bc = _Cursor(data)
            for _ in range(count):
                yield dec.decode(bc, dec.schema)

    return schema, rows()


# -- writer (tests + tooling: produce container files without a library) ----

def _write_long(out: bytearray, v: int) -> None:
    """Unsigned varint (callers zigzag signed values first)."""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(v: int) -> int:
    return (v << 1) if v >= 0 else ((-v << 1) - 1)


def _encode(out: bytearray, s: SchemaT, v: Any, named: Dict[str, dict]) -> None:
    if isinstance(s, list):
        for i, branch in enumerate(s):
            if _matches(branch, v, named):
                _write_long(out, _zigzag(i))
                _encode(out, branch, v, named)
                return
        raise AvroError(f"value {v!r} matches no union branch")
    if isinstance(s, str) and s in named:
        s = named[s]
    if isinstance(s, str):
        _encode_primitive(out, s, v)
        return
    t = s["type"]
    if t == "record":
        for f in s["fields"]:
            _encode(out, f["type"], v[f["name"]], named)
    elif t == "enum":
        _write_long(out, _zigzag(s["symbols"].index(v)))
    elif t == "array":
        if v:
            _write_long(out, _zigzag(len(v)))
            for x in v:
                _encode(out, s["items"], x, named)
        _write_long(out, 0)
    elif t == "map":
        if v:
            _write_long(out, _zigzag(len(v)))
            for k, x in v.items():
                raw = k.encode("utf-8")
                _write_long(out, _zigzag(len(raw)))
                out.extend(raw)
                _encode(out, s["values"], x, named)
        _write_long(out, 0)
    elif t == "fixed":
        out.extend(v)
    else:
        _encode_primitive(out, t, v)


def _encode_primitive(out: bytearray, t: str, v: Any) -> None:
    if t == "null":
        return
    if t == "boolean":
        out.append(1 if v else 0)
    elif t in ("int", "long"):
        _write_long(out, _zigzag(int(v)))
    elif t == "float":
        out.extend(struct.pack("<f", float(v)))
    elif t == "double":
        out.extend(struct.pack("<d", float(v)))
    elif t == "bytes":
        _write_long(out, _zigzag(len(v)))
        out.extend(v)
    elif t == "string":
        raw = str(v).encode("utf-8")
        _write_long(out, _zigzag(len(raw)))
        out.extend(raw)
    else:
        raise AvroError(f"unknown avro type {t!r}")


def _matches(branch: SchemaT, v: Any, named: Dict[str, dict]) -> bool:
    if isinstance(branch, str) and branch in named:
        branch = named[branch]
    t = branch["type"] if isinstance(branch, dict) else branch
    if t == "null":
        return v is None
    if v is None:
        return False
    if t == "boolean":
        return isinstance(v, bool)
    if t in ("int", "long"):
        return isinstance(v, int) and not isinstance(v, bool)
    if t in ("float", "double"):
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if t in ("string", "enum"):
        return isinstance(v, str)
    if t in ("bytes", "fixed"):
        return isinstance(v, bytes)
    if t == "array":
        return isinstance(v, list)
    if t in ("map", "record"):
        return isinstance(v, dict)
    return False


def write_container(path: str, schema: dict, values: List[Any],
                    codec: str = "deflate") -> None:
    dec = _Decoder(schema)  # registers named types
    body = bytearray()
    for v in values:
        _encode(body, dec.schema, v, dec.named)
    data = bytes(body)
    if codec == "deflate":
        data = zlib.compress(data)[2:-4]  # raw deflate, no zlib wrapper
    elif codec != "null":
        raise AvroError(f"unsupported codec {codec!r}")
    out = bytearray(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode("utf-8"),
            "avro.codec": codec.encode("ascii")}
    _write_long(out, _zigzag(len(meta)))
    for k, v in meta.items():
        raw = k.encode("utf-8")
        _write_long(out, _zigzag(len(raw)))
        out.extend(raw)
        _write_long(out, _zigzag(len(v)))
        out.extend(v)
    _write_long(out, 0)
    sync = bytes(range(16))
    out.extend(sync)
    _write_long(out, _zigzag(len(values)))
    _write_long(out, _zigzag(len(data)))
    out.extend(data)
    out.extend(sync)
    with open(path, "wb") as f:
        f.write(bytes(out))
