"""DataTable: the server -> broker intermediate-result wire format.

Counterpart of ``pinot_tpu/common/datatable.py`` (a copy of
``ResponseType``, ``Column``, ``DataTable`` with its binary wire, the
legacy JSON framing and the typed constructors). One self-describing
payload carries merged scalar-aggregation states, a group-by table,
selection rows or distinct rows, with the data schema, the server's
``QueryStats`` and its exceptions. Values round-trip through a tagged
encoding covering the intermediate-state types (tuples for AVG /
MINMAXRANGE, frozensets for DISTINCTCOUNT, bytes, non-finite floats).

Framing is binary and columnar (magic ``PDT3``): a header, the stats and
exceptions sections, then a payload per response type where selection,
distinct and group-by data ship as typed columns: numeric columns as raw
little-endian buffers, string columns as offsets and a heap, other state
columns through the tagged object serde (``common/serde.py``).
``from_bytes`` sniffs the magic and still accepts the legacy JSON framing.
The bytes are the JAX package's: a table encoded by either package
decodes in the other to the same states, rows and schema. The stats
section carries a traced query's ``trace`` entries and ``spans`` as the
JAX package's does (JAX :566-567), and the port's own counters beside the
JAX keys (see ``QueryStats.to_dict``); both decoders ignore keys they do
not know.

Decode is columnar: the wire's typed buffers stay numpy arrays behind the
``Column`` accessors, so the broker's vectorized reduce reads
``columns()`` / ``group_columns()`` without boxing a numeric cell;
``rows()`` / ``group_by_groups()`` are lazy views, and ``payload``
materialises its dict shape on first access only.
"""

from __future__ import annotations

import enum
import json
import struct

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.engine.results import DataSchema, QueryStats
from pinot_tpu_torch.common import serde

MAGIC = b"PDT3"


class ResponseType(enum.Enum):
    AGGREGATION = "AGGREGATION"
    GROUP_BY = "GROUP_BY"
    SELECTION = "SELECTION"
    DISTINCT = "DISTINCT"


# stable wire ordinals: never renumber, append only (declaration order must
# not leak into the binary framing or mixed-version decode breaks)
_WIRE_ORDINAL = {
    ResponseType.AGGREGATION: 0,
    ResponseType.GROUP_BY: 1,
    ResponseType.SELECTION: 2,
    ResponseType.DISTINCT: 3,
}
_WIRE_TYPE = {v: k for k, v in _WIRE_ORDINAL.items()}


# --------------------------------------------------------------------------
# tagged value encoding (the object types of intermediate states)
# --------------------------------------------------------------------------

def encode_value(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return {"__t": "f", "v": repr(v)}
        return v
    if isinstance(v, bytes):
        return {"__t": "b", "v": v.hex()}
    if isinstance(v, tuple):
        return {"__t": "t", "v": [encode_value(x) for x in v]}
    if isinstance(v, frozenset):
        return {"__t": "s", "v": sorted((encode_value(x) for x in v),
                                        key=lambda e: json.dumps(e))}
    if isinstance(v, (list,)):
        return {"__t": "l", "v": [encode_value(x) for x in v]}
    if hasattr(v, "item"):  # numpy scalar
        return encode_value(v.item())
    raise TypeError(f"cannot encode {type(v).__name__} for the wire")


def decode_value(v: Any) -> Any:
    if isinstance(v, dict) and "__t" in v:
        t = v["__t"]
        if t == "f":
            return float(v["v"])
        if t == "b":
            return bytes.fromhex(v["v"])
        if t == "t":
            return tuple(decode_value(x) for x in v["v"])
        if t == "s":
            return frozenset(decode_value(x) for x in v["v"])
        if t == "l":
            return [decode_value(x) for x in v["v"]]
        raise ValueError(f"unknown value tag {t!r}")
    return v


# --------------------------------------------------------------------------
# columnar sections (binary framing)
# --------------------------------------------------------------------------

# column kinds on the wire: a new kind needs encode, decode and every
# Column accessor updated together
_COL_I64 = 0
_COL_F64 = 1
_COL_STR = 2
_COL_OBJ = 3

# a grouping of kinds, not a wire ordinal
_COL_NUMERIC = (_COL_I64, _COL_F64)


class Column:
    """One typed wire column, kept in its decoded-buffer form.

    i64/f64: a zero-copy numpy view over the received bytes. str: the
    utf-8 heap + offsets (python strings decode lazily, once). obj: the
    serde-decoded python objects (tuples/frozensets/bytes/None/mixed).
    ``tolist()`` is the boxed compatibility view; the vectorized reduce
    never calls it for numeric columns.
    """

    __slots__ = ("kind", "n", "_arr", "_heap", "_offsets", "_vals", "_safe")

    def __init__(self, kind: int, n: int, arr: Optional[np.ndarray] = None,
                 heap: Optional[bytes] = None,
                 offsets: Optional[np.ndarray] = None,
                 vals: Optional[list] = None):
        self.kind = kind
        self.n = n
        self._arr = arr
        self._heap = heap
        self._offsets = offsets
        self._vals = vals
        self._safe: Optional[bool] = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_encoded(cls, values: List[Any]) -> "Column":
        """Payload-shaped (tagged-encoding) cells -> a typed Column; the
        sniff mirrors ``_encode_column`` so constructor-built and
        wire-decoded tables expose identical column kinds."""
        vals = [decode_value(v) for v in values]
        vals = [v.item() if hasattr(v, "item") else v for v in vals]
        if vals and all(type(v) is int for v in vals) \
                and all(-(1 << 63) <= v < (1 << 63) for v in vals):
            return cls(_COL_I64, len(vals),
                       arr=np.asarray(vals, dtype="<i8"), vals=vals)
        if vals and all(isinstance(v, float) for v in vals):
            return cls(_COL_F64, len(vals),
                       arr=np.asarray(vals, dtype="<f8"), vals=vals)
        if vals and all(type(v) is str for v in vals):
            return cls(_COL_STR, len(vals), vals=vals)
        return cls(_COL_OBJ, len(vals), vals=vals)

    # -- typed accessors -----------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.kind in _COL_NUMERIC

    @property
    def is_string(self) -> bool:
        return self.kind == _COL_STR

    @property
    def json_safe(self) -> bool:
        """Every boxed cell already satisfies the payload's JSON-shape
        invariant (i64/str always; f64 unless non-finite; obj never —
        tuples/sets/bytes need wrapping). Computed from the ARRAY for f64,
        never by scanning boxed cells."""
        if self._safe is None:
            if self.kind == _COL_F64:
                self._safe = bool(np.isfinite(self._arr).all())
            elif self.kind == _COL_I64 or self.kind == _COL_STR:
                self._safe = True
            elif self.kind == _COL_OBJ:
                self._safe = False
            else:
                raise ValueError(f"unknown column kind {self.kind}")
        return self._safe

    def array(self) -> np.ndarray:
        """The column as a numpy array: numeric -> the (zero-copy) wire
        buffer; str -> a unicode array (decoded once); obj -> object
        array. Sortable for every kind except obj (caller's guard)."""
        if self.kind == _COL_I64 or self.kind == _COL_F64:
            return self._arr
        if self.kind == _COL_STR:
            return np.asarray(self._strings(), dtype=object if self.n == 0
                              else None)
        if self.kind == _COL_OBJ:
            a = np.empty(self.n, dtype=object)
            for i, v in enumerate(self._vals):
                a[i] = v
            return a
        raise ValueError(f"unknown column kind {self.kind}")

    def tolist(self) -> list:
        """Boxed DECODED values (the ``rows()`` view), cached."""
        if self._vals is None:
            if self.kind == _COL_I64:
                self._vals = [int(v) for v in self._arr]
            elif self.kind == _COL_F64:
                self._vals = [float(v) for v in self._arr]
            elif self.kind == _COL_STR:
                self._vals = self._strings()
            elif self.kind == _COL_OBJ:
                self._vals = []
            else:
                raise ValueError(f"unknown column kind {self.kind}")
        return self._vals

    def take_boxed(self, indices) -> list:
        """Box ONLY the cells at ``indices`` (the trimmed-output path —
        a LIMIT-sized materialization, never the full column)."""
        if self._vals is not None:
            return [self._vals[int(i)] for i in indices]
        if self.kind == _COL_I64:
            return [int(v) for v in self._arr.take(indices)]
        if self.kind == _COL_F64:
            return [float(v) for v in self._arr.take(indices)]
        if self.kind == _COL_STR:
            off, heap = self._offsets, self._heap
            return [heap[off[i]:off[i + 1]].decode("utf-8")
                    for i in (int(i) for i in indices)]
        if self.kind == _COL_OBJ:
            return [self._vals[int(i)] for i in indices]
        raise ValueError(f"unknown column kind {self.kind}")

    def encoded_list(self) -> list:
        """Payload-shaped cells (tagged encoding applied where the boxed
        value would violate the JSON-shape invariant)."""
        if self.json_safe:
            return self.tolist()
        return [encode_value(v) for v in self.tolist()]

    def encode_parts(self, parts: list) -> None:
        """Append the wire form of this column as buffer PARTS (the typed
        fast path of ``_encode_column``): numeric and decoded-string
        columns frame their existing buffers directly — memoryviews over
        the arrays, no intermediate bytearray assembly — and the final
        ``b"".join`` in ``DataTable.to_bytes`` is the only copy."""
        if self.kind == _COL_I64:
            parts.append(bytes([_COL_I64]))
            parts.append(np.ascontiguousarray(self._arr, dtype="<i8").data)
        elif self.kind == _COL_F64:
            parts.append(bytes([_COL_F64]))
            parts.append(np.ascontiguousarray(self._arr, dtype="<f8").data)
        elif self.kind == _COL_STR:
            parts.append(bytes([_COL_STR]))
            if self._heap is not None:
                # wire-decoded: the heap + offsets ARE the wire form
                parts.append(struct.pack("<I", len(self._heap)))
                parts.append(self._heap)
                parts.append(np.ascontiguousarray(self._offsets,
                                                  dtype="<u4").data)
            else:
                _encode_str_parts(parts, self.tolist())
        elif self.kind == _COL_OBJ:
            parts.append(bytes([_COL_OBJ]))
            buf = bytearray()  # serde is inherently byte-at-a-time
            for v in self._vals:
                serde.pack_obj(v, buf)
            parts.append(bytes(buf))
        else:
            raise ValueError(f"unknown column kind {self.kind}")

    def _strings(self) -> List[str]:
        if self._vals is not None:
            return self._vals
        off = self._offsets
        heap = self._heap
        self._vals = [heap[off[i]:off[i + 1]].decode("utf-8")
                      for i in range(self.n)]
        return self._vals


def _encode_str_column(out: bytearray, vals: List[str]) -> None:
    """Heap+offsets body of a string column (kind byte is the caller's)."""
    parts = [v.encode("utf-8") for v in vals]
    heap = b"".join(parts)
    offsets = np.cumsum([0] + [len(p) for p in parts]).astype("<u4")
    out.extend(struct.pack("<I", len(heap)))
    out.extend(heap)
    out.extend(offsets.tobytes())


def _encode_str_parts(parts: list, vals: List[str]) -> None:
    """Heap+offsets body of a string column as buffer parts: each encoded
    string is its own part (the heap never assembles on the python heap —
    the final join IS the heap) followed by the offsets buffer."""
    enc = [v.encode("utf-8") for v in vals]
    offsets = np.cumsum([0] + [len(p) for p in enc]).astype("<u4")
    parts.append(struct.pack("<I", int(offsets[-1])))
    parts.extend(enc)
    parts.append(offsets.data)


def _encode_column(out: bytearray, values: List[Any]) -> None:
    """One typed column: numeric homogeneity -> raw buffers, strings ->
    offsets+heap, anything else (tuples/sets/bytes/None/mixed) -> tagged
    objects. The type sniff treats numpy scalars as their python values."""
    vals = [v.item() if hasattr(v, "item") else v for v in values]
    if vals and all(type(v) is int for v in vals) \
            and all(-(1 << 63) <= v < (1 << 63) for v in vals):
        out.append(_COL_I64)
        out.extend(np.asarray(vals, dtype="<i8").tobytes())
        return
    if vals and all(isinstance(v, float) for v in vals):
        out.append(_COL_F64)
        out.extend(np.asarray(vals, dtype="<f8").tobytes())
        return
    if vals and all(type(v) is str for v in vals):
        out.append(_COL_STR)
        _encode_str_column(out, vals)
        return
    out.append(_COL_OBJ)
    for v in vals:
        serde.pack_obj(v, out)


def _decode_column(buf: bytes, off: int, n: int) -> Tuple[Column, int]:
    """-> (Column, new offset). Numeric buffers are ZERO-COPY numpy views
    over ``buf``; strings stay heap+offsets; obj cells decode through the
    tagged serde. Nothing is boxed here — ``Column.tolist()`` is the lazy
    boxing point for compatibility consumers."""
    kind = buf[off]
    off += 1
    if kind == _COL_I64:
        a = np.frombuffer(buf, dtype="<i8", count=n, offset=off)
        return Column(_COL_I64, n, arr=a), off + 8 * n
    if kind == _COL_F64:
        a = np.frombuffer(buf, dtype="<f8", count=n, offset=off)
        return Column(_COL_F64, n, arr=a), off + 8 * n
    if kind == _COL_STR:
        (heap_len,) = struct.unpack_from("<I", buf, off)
        off += 4
        raw = buf[off:off + heap_len]
        off += heap_len
        offsets = np.frombuffer(buf, dtype="<u4", count=n + 1, offset=off)
        off += 4 * (n + 1)
        return Column(_COL_STR, n, heap=raw, offsets=offsets), off
    if kind == _COL_OBJ:
        vals = []
        for _ in range(n):
            v, off = serde.unpack_obj(buf, off)
            vals.append(v)
        return Column(_COL_OBJ, n, vals=vals), off
    raise ValueError(f"unknown column kind {kind}")


def _put_section(parts: list, raw: bytes) -> None:
    parts.append(struct.pack("<I", len(raw)))
    parts.append(raw)


def _get_section(buf: bytes, off: int) -> tuple:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n], off + n


# --------------------------------------------------------------------------
# the DataTable
# --------------------------------------------------------------------------

class DataTable:
    """One server's reply for one (sub)query.

    ``payload`` keeps the legacy JSON-shaped dict contract:
      AGGREGATION: {"states": [state per agg]}
      GROUP_BY:    {"groups": [[key tuple, [state per agg]], ...],
                    "schema_types": {col: type label}}
      SELECTION:   {"schema": DataSchema dict, "rows": [...],
                    "num_hidden": trailing order-by-only columns}
      DISTINCT:    {"schema": DataSchema dict, "rows": [...]}
    but on a wire-decoded table the row/group section lives as typed
    ``Column`` buffers until something touches ``payload`` — the
    vectorized reduce reads ``columns()`` / ``group_columns()`` and the
    boxed dict never materializes.
    """

    __slots__ = ("response_type", "stats", "exceptions", "wire_decoded",
                 "_payload", "_cols", "_key_cols", "_agg_cols", "_n_rows")

    def __init__(self, response_type: ResponseType,
                 payload: Optional[Dict[str, Any]],
                 stats: Optional[QueryStats] = None,
                 exceptions: Optional[List[str]] = None):
        self.response_type = response_type
        self._payload: Dict[str, Any] = payload if payload is not None else {}
        self.stats = stats if stats is not None else QueryStats()
        self.exceptions = exceptions if exceptions is not None else []
        # True on tables that arrived through the wire (from_bytes /
        # legacy JSON): the broker's device reduce declines them, since a
        # table that crossed a process boundary already paid the copy to
        # the host and the host merge is its natural frame
        self.wire_decoded = False
        self._cols: Optional[List[Column]] = None
        self._key_cols: Optional[List[Column]] = None
        self._agg_cols: Optional[List[Column]] = None
        self._n_rows: Optional[int] = None

    def __repr__(self) -> str:
        return (f"DataTable({self.response_type.value}, "
                f"rows={self.num_rows()}, "
                f"exceptions={len(self.exceptions)})")

    # -- payload compatibility ----------------------------------------------
    @property
    def payload(self) -> Dict[str, Any]:
        """The legacy dict view; materializes boxed rows/groups from the
        columnar buffers on first access (compat + JSON framing only —
        the array-native reduce never touches it)."""
        self._materialize()
        return self._payload

    def _materialize(self) -> None:
        p = self._payload
        if self._cols is not None and "rows" not in p:
            cols = [c.encoded_list() for c in self._cols]
            p["rows"] = [[c[i] for c in cols]
                         for i in range(self._n_rows or 0)]
        if self._key_cols is not None and "groups" not in p:
            keys = [c.tolist() for c in self._key_cols]
            aggs = [c.encoded_list() for c in self._agg_cols]
            p["groups"] = [
                [encode_value(tuple(kc[i] for kc in keys)),
                 [ac[i] for ac in aggs]]
                for i in range(self._n_rows or 0)]

    # -- framing -------------------------------------------------------------
    def to_buffers(self) -> List[Any]:
        """The wire form as an ordered list of buffer parts (bytes /
        memoryviews over the live column arrays). Layout:
        magic | u8 type-ordinal | stats json section | exceptions json
        section | per-type payload. Zero-copy: typed column buffers are
        framed directly (``Column.encode_parts``); nothing assembles an
        intermediate bytearray. A transport that can writev/scatter sends
        the parts as-is; ``to_bytes`` is the single-buffer join."""
        parts: List[Any] = [MAGIC, bytes([_WIRE_ORDINAL[self.response_type]])]
        _put_section(parts, json.dumps(
            self.stats.to_dict(), separators=(",", ":")).encode("utf-8"))
        _put_section(parts, json.dumps(
            self.exceptions, separators=(",", ":")).encode("utf-8"))
        t = self.response_type
        if t is ResponseType.AGGREGATION:
            states = [decode_value(s) for s in self._payload["states"]] \
                if self._payload else []
            buf = bytearray()
            serde.pack_obj(len(states), buf)
            for s in states:
                serde.pack_obj(s, buf)
            parts.append(bytes(buf))
        elif t is ResponseType.GROUP_BY:
            _put_section(parts, json.dumps(
                self._payload.get("schema_types", {}),
                separators=(",", ":")).encode("utf-8"))
            key_cols, agg_cols = (self.group_columns()
                                  if self._payload or self._key_cols
                                  else ([], []))
            n = key_cols[0].n if key_cols else 0
            parts.append(struct.pack("<IHH", n, len(key_cols),
                                     len(agg_cols)))
            for c in key_cols:
                c.encode_parts(parts)
            for c in agg_cols:
                c.encode_parts(parts)
        else:  # SELECTION / DISTINCT
            schema = self._payload.get(
                "schema", {"columnNames": [], "columnDataTypes": []}) \
                if self._payload else {"columnNames": [],
                                       "columnDataTypes": []}
            cols = self.columns() if self._payload or self._cols else []
            n_rows = cols[0].n if cols else 0
            _put_section(parts, json.dumps(
                schema, separators=(",", ":")).encode("utf-8"))
            parts.append(struct.pack("<IHH", n_rows, len(cols),
                                     self.num_hidden))
            for c in cols:
                c.encode_parts(parts)
        return parts

    def to_bytes(self) -> bytes:
        """Single-buffer wire form: ONE join over ``to_buffers`` parts."""
        return b"".join(self.to_buffers())

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DataTable":
        if not raw.startswith(MAGIC):
            return cls._from_json_bytes(raw)
        off = len(MAGIC)
        rtype = _WIRE_TYPE[raw[off]]
        off += 1
        stats_raw, off = _get_section(raw, off)
        exc_raw, off = _get_section(raw, off)
        stats = QueryStats.from_dict(json.loads(stats_raw.decode("utf-8")))
        exceptions = json.loads(exc_raw.decode("utf-8"))
        if rtype is ResponseType.AGGREGATION:
            n, off = serde.unpack_obj(raw, off)
            states = []
            for _ in range(n):
                s, off = serde.unpack_obj(raw, off)
                states.append(s)
            dt = cls(rtype, {"states": [encode_value(s) for s in states]},
                     stats, exceptions)
            dt.wire_decoded = True
            return dt
        dt = cls(rtype, {}, stats, exceptions)
        dt.wire_decoded = True
        if rtype is ResponseType.GROUP_BY:
            st_raw, off = _get_section(raw, off)
            dt._payload["schema_types"] = json.loads(st_raw.decode("utf-8"))
            n, arity, n_aggs = struct.unpack_from("<IHH", raw, off)
            off += 8
            key_cols = []
            for _ in range(arity):
                col, off = _decode_column(raw, off, n)
                key_cols.append(col)
            agg_cols = []
            for _ in range(n_aggs):
                col, off = _decode_column(raw, off, n)
                agg_cols.append(col)
            dt._key_cols, dt._agg_cols, dt._n_rows = key_cols, agg_cols, n
        else:
            schema_raw, off = _get_section(raw, off)
            dt._payload["schema"] = json.loads(schema_raw.decode("utf-8"))
            n_rows, n_cols, num_hidden = struct.unpack_from(
                "<IHH", raw, off)
            off += 8
            cols = []
            for _ in range(n_cols):
                col, off = _decode_column(raw, off, n_rows)
                cols.append(col)
            dt._cols, dt._n_rows = cols, n_rows
            if rtype is ResponseType.SELECTION:
                dt._payload["num_hidden"] = num_hidden
        return dt

    @classmethod
    def _from_json_bytes(cls, raw: bytes) -> "DataTable":
        """Legacy JSON framing (kept for mixed-version interop + debug)."""
        d = json.loads(raw.decode("utf-8"))
        dt = cls(ResponseType(d["type"]), d["payload"],
                 QueryStats.from_dict(d.get("stats", {})),
                 d.get("exceptions", []))
        dt.wire_decoded = True
        return dt

    def to_json_bytes(self) -> bytes:
        """The debuggable JSON framing (not the serving default)."""
        return json.dumps({
            "type": self.response_type.value,
            "payload": self.payload,
            "stats": self.stats.to_dict(),
            "exceptions": self.exceptions,
        }, separators=(",", ":")).encode("utf-8")

    # -- typed constructors --------------------------------------------------
    @classmethod
    def for_aggregation(cls, states: List[Any], stats: QueryStats) -> "DataTable":
        return cls(ResponseType.AGGREGATION,
                   {"states": [encode_value(s) for s in states]}, stats)

    @classmethod
    def for_group_by(cls, groups: Dict[tuple, List[Any]],
                     schema_types: Dict[str, str],
                     stats: QueryStats) -> "DataTable":
        return cls(ResponseType.GROUP_BY, {
            "groups": [[encode_value(k), [encode_value(s) for s in states]]
                       for k, states in groups.items()],
            "schema_types": schema_types,
        }, stats)

    @classmethod
    def for_selection(cls, schema: DataSchema, rows: List[List[Any]],
                      stats: QueryStats, num_hidden: int = 0,
                      sorted_rows: bool = False) -> "DataTable":
        """``sorted_rows``: the server already ordered the (trimmed) rows
        by the query's ORDER BY, so the broker's merge may treat the block
        as pre-sorted. Rides the schema section, so the binary layout is
        unchanged."""
        sd = schema.to_dict()
        if sorted_rows:
            sd["sorted"] = True
        return cls(ResponseType.SELECTION, {
            "schema": sd,
            "rows": [[encode_value(c) for c in r] for r in rows],
            "num_hidden": num_hidden,
        }, stats)

    @classmethod
    def for_distinct(cls, schema: DataSchema,
                     rows: List[List[Any]], stats: QueryStats) -> "DataTable":
        return cls(ResponseType.DISTINCT, {
            "schema": schema.to_dict(),
            "rows": [[encode_value(c) for c in r] for r in rows],
        }, stats)

    @classmethod
    def for_exception(cls, message: str,
                      response_type: ResponseType = ResponseType.AGGREGATION
                      ) -> "DataTable":
        return cls(response_type, {}, QueryStats(), [message])

    # -- columnar readers (the array-native reduce path) ---------------------
    def columns(self) -> List[Column]:
        """SELECTION/DISTINCT columns (visible + hidden) as typed Columns.
        Zero-copy when the table was wire-decoded; constructor-built and
        legacy-JSON tables sniff their boxed payload rows into typed
        arrays (same kinds the wire encoder would have chosen)."""
        if self._cols is None:
            rows = self._payload.get("rows", [])
            n_cols = len(self._payload.get(
                "schema", {}).get("columnNames", ())) or \
                (len(rows[0]) if rows else 0)
            self._cols = [Column.from_encoded([r[c] for r in rows])
                          for c in range(n_cols)]
            self._n_rows = len(rows)
        return self._cols

    def group_columns(self) -> Tuple[List[Column], List[Column]]:
        """GROUP_BY (key columns, aggregation-state columns)."""
        if self._key_cols is None:
            groups = self.group_by_groups() if self._payload else {}
            keys = list(groups.keys())
            vals = list(groups.values())
            arity = len(keys[0]) if keys else 0
            n_aggs = len(vals[0]) if vals else 0
            self._key_cols = [
                Column.from_encoded([encode_value(k[i]) for k in keys])
                for i in range(arity)]
            self._agg_cols = [
                Column.from_encoded([encode_value(v[a]) for v in vals])
                for a in range(n_aggs)]
            self._n_rows = len(keys)
        return self._key_cols, self._agg_cols

    def num_rows(self) -> int:
        """Row/group count without materializing the boxed payload."""
        if self._n_rows is not None:
            return self._n_rows
        if self.response_type is ResponseType.GROUP_BY:
            return len(self._payload.get("groups", ()))
        if self.response_type is ResponseType.AGGREGATION:
            return 1 if self._payload.get("states") else 0
        return len(self._payload.get("rows", ()))

    @property
    def selection_sorted(self) -> bool:
        """True when the producing server ordered this block by the
        query's ORDER BY (see ``for_selection(sorted_rows=True)``)."""
        return bool(self._payload.get("schema", {}).get("sorted"))

    # -- typed readers -------------------------------------------------------
    def agg_states(self) -> List[Any]:
        return [decode_value(s) for s in self._payload["states"]]

    def group_by_groups(self) -> Dict[tuple, List[Any]]:
        if self._key_cols is not None and "groups" not in self._payload:
            keys = [c.tolist() for c in self._key_cols]
            aggs = [c.tolist() for c in self._agg_cols]
            return {tuple(kc[i] for kc in keys): [ac[i] for ac in aggs]
                    for i in range(self._n_rows or 0)}
        return {decode_value(k): [decode_value(s) for s in states]
                for k, states in self._payload["groups"]}

    def schema_types(self) -> Dict[str, str]:
        return self._payload.get("schema_types", {})

    def data_schema(self) -> DataSchema:
        d = self._payload["schema"]
        return DataSchema(d["columnNames"], d["columnDataTypes"])

    def rows(self) -> List[List[Any]]:
        """Boxed row view — LAZY: wire-decoded tables build rows from the
        typed columns on demand (and only box each column once)."""
        if self._cols is not None and "rows" not in self._payload:
            cols = [c.tolist() for c in self._cols]
            return [[c[i] for c in cols] for i in range(self._n_rows or 0)]
        return [[decode_value(c) for c in r]
                for r in self._payload["rows"]]

    @property
    def num_hidden(self) -> int:
        return self._payload.get("num_hidden", 0)


__all__ = ["Column", "DataTable", "ResponseType", "decode_value",
           "encode_value"]
