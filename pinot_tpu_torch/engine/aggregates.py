"""Aggregation functions: state algebra, host computation and resolution.

Counterpart of ``pinot_tpu/engine/aggregates.py``. Every aggregation name
the JAX package knows resolves to its family, MV form and device flags
(``resolve_agg``, the JAX family table and flags at :440-529); the planner
refuses what has no device kernel with the JAX reason code, and the
executor then serves it on the host engine (``engine/host_engine.py``).
Every family has its state, merge and finalize, and ``AggDef.compute_host``
computes a segment's state on the host (the JAX package's ``_HOST`` table,
:228-436): count, sum, avg, min, max, minmaxrange, distinctcount and
distinctcounthll (the device families), mode, percentile /
percentileest / percentiletdigest, distinctcountthetasketch (and raw),
idset, sumprecision, lastwithtime / firstwithtime and stunion. States are
plain python values that merge across segments (a distinct count's state is
the frozenset of values, an HLL's its serialized registers).

An MV aggregation's values are an :class:`MVValues` (the column's dense
per-row values and counts, as the port stores MV columns) where the JAX
host engine builds a list of per-doc arrays; the flattened values of the
matching rows are the same values in the same order.
"""

from __future__ import annotations

import decimal as _decimal
import math as _math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np

from pinot_tpu_torch.engine.errors import QueryError, UnsupportedQueryError
from pinot_tpu_torch.query.expressions import (
    Expr,
    Function,
    Identifier,
    Literal,
)
from pinot_tpu_torch.utils.hll import HyperLogLog
from pinot_tpu_torch.utils.tdigest import TDigest
from pinot_tpu_torch.utils.theta import ThetaSketch

POS_INF = float("inf")
NEG_INF = float("-inf")


class MVValues:
    """A multi-value column's values over a segment's docs: ``ids`` [rows,
    max values] dictIds and ``counts`` [rows] (each row's values are its
    first ``counts`` entries), gathered from ``values`` (the dictionary's
    values: numeric, or an object array of strings)."""

    def __init__(self, ids: np.ndarray, counts: np.ndarray,
                 values: np.ndarray):
        self.ids = ids
        self.counts = counts
        self.values = values

    def __len__(self) -> int:
        return int(self.counts.shape[0])

    def take(self, idx: np.ndarray) -> "MVValues":
        return MVValues(self.ids[idx], self.counts[idx], self.values)

    def _flat_ids(self, mask: np.ndarray) -> np.ndarray:
        rows, counts = ((self.ids, self.counts) if mask.all()
                        else (self.ids[mask], self.counts[mask]))
        return rows[np.arange(rows.shape[1])[None, :] < counts[:, None]]

    def flat(self, mask: np.ndarray) -> np.ndarray:
        """The values of the rows ``mask`` selects, row after row."""
        return self.values[self._flat_ids(mask)]

    def distinct(self, mask: np.ndarray) -> list:
        """The distinct values of the rows ``mask`` selects."""
        seen = np.bincount(self._flat_ids(mask), minlength=len(self.values))
        return self.values[np.flatnonzero(seen)].tolist()


@dataclass
class AggDef:
    name: str
    base: str
    mv: bool = False
    percentile: Optional[float] = None
    precision: Optional[int] = None
    device_scalar: bool = True
    device_grouped: bool = True
    result_type: str = "DOUBLE"

    def empty_state(self) -> Any:
        e = _EMPTY[self.base]
        return e() if callable(e) else e

    def merge(self, a: Any, b: Any) -> Any:
        return _MERGE[self.base](a, b)

    def finalize(self, state: Any) -> Any:
        return _FINAL[self.base](self, state)

    def compute_host(self, values: Any, mask: np.ndarray) -> Any:
        """A segment's state over the docs ``mask`` selects: ``values`` is
        per doc (an :class:`MVValues` for an MV function, a (values,
        times) pair for lastwithtime / firstwithtime)."""
        return _HOST[self.base](self, values, mask)


# -- state algebra per family ------------------------------------------------

_EMPTY: Dict[str, Any] = {
    "count": 0,
    "sum": 0.0,
    "min": POS_INF,
    "max": NEG_INF,
    "avg": (0.0, 0),
    "minmaxrange": (POS_INF, NEG_INF),
    "distinctcount": frozenset(),
    "distinctcounthll": lambda: HyperLogLog().serialize(),
    "mode": dict,
    "percentile": tuple,
    "percentiletdigest": lambda: TDigest().serialize(),
    "distinctcountthetasketch": lambda: ThetaSketch().serialize(),
    "sumprecision": "0",  # exact decimal sum as a string-encoded Decimal
    "idset": frozenset(),
    # (time, value) of the chosen row, or None when no row matched yet
    "lastwithtime": None,
    "firstwithtime": None,
    "stunion": "",  # WKT of the union so far ("" = nothing yet)
}


def _exact_dec_add(a: _decimal.Decimal, b: _decimal.Decimal
                   ) -> _decimal.Decimal:
    """Exact decimal addition: the context spans both operands' digits,
    so no rounding occurs and merges do not depend on their order."""
    if not a.is_finite() or not b.is_finite():
        return a + b
    if not a:
        return b
    if not b:
        return a
    hi = max(a.adjusted(), b.adjusted())
    lo = min(a.as_tuple().exponent, b.as_tuple().exponent)
    return _decimal.Context(prec=max(hi - lo + 2, 1)).add(a, b)


def _decimal_add(a: str, b: str) -> str:
    return str(_exact_dec_add(_decimal.Decimal(a), _decimal.Decimal(b)))


def _stunion_merge(a: str, b: str) -> str:
    from pinot_tpu_torch.utils import geo

    if not a:
        return b
    if not b:
        return a
    g = geo.union([geo.parse_ewkt(a), geo.parse_ewkt(b)])
    return (geo.GEOG_PREFIX + g.wkt()) if g.geography else g.wkt()


def _merge_counts(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


_MERGE: Dict[str, Callable[[Any, Any], Any]] = {
    "count": lambda a, b: a + b,
    "sum": lambda a, b: a + b,
    "min": lambda a, b: min(a, b),
    "max": lambda a, b: max(a, b),
    "avg": lambda a, b: (a[0] + b[0], a[1] + b[1]),
    "minmaxrange": lambda a, b: (min(a[0], b[0]), max(a[1], b[1])),
    "distinctcount": lambda a, b: frozenset(a) | frozenset(b),
    "distinctcounthll": lambda a, b: HyperLogLog.deserialize(a).merge(
        HyperLogLog.deserialize(b)).serialize(),
    "mode": _merge_counts,
    "percentile": lambda a, b: tuple(a) + tuple(b),
    "percentiletdigest": lambda a, b: TDigest.deserialize(a).merge(
        TDigest.deserialize(b)).serialize(),
    "distinctcountthetasketch": lambda a, b: ThetaSketch.deserialize(a).merge(
        ThetaSketch.deserialize(b)).serialize(),
    "sumprecision": _decimal_add,
    "idset": lambda a, b: frozenset(a) | frozenset(b),
    # the lexicographic (time, value) extreme: the same under any merge
    # order (the value breaks a tie of times)
    "lastwithtime": lambda a, b: b if a is None else a if b is None
    else max(a, b),
    "firstwithtime": lambda a, b: b if a is None else a if b is None
    else min(a, b),
    "stunion": _stunion_merge,
}


def _final_percentile(d: AggDef, s) -> float:
    vals = np.sort(np.asarray(s, dtype=np.float64))
    if vals.size == 0:
        return NEG_INF
    idx = int(vals.size * d.percentile / 100.0)
    return float(vals[min(idx, vals.size - 1)])


def _final_sumprecision(d: AggDef, s: str):
    """An integral sum finalizes as a python int, a fractional one as a
    float (or its exact decimal string past the f64 range); the precision
    argument rounds at finalize only."""
    v = _decimal.Decimal(s)
    if d.precision is not None:
        v = _decimal.Context(prec=d.precision).plus(v)
    if v.is_finite() and v == v.to_integral_value():
        return int(v)
    f = float(v)
    if _math.isinf(f) and v.is_finite():
        return str(v)
    return f


def _final_idset(d: AggDef, s) -> str:
    """The id set serialized, base64 (what ``inIdSet`` reads)."""
    import base64

    from pinot_tpu_torch.common import serde

    return base64.b64encode(serde.dumps(
        sorted(s, key=lambda v: (str(type(v)), v)))).decode("ascii")


def _final_withtime(d: AggDef, s):
    if s is None:
        return None if d.result_type == "STRING" else NEG_INF
    v = s[1]
    if d.result_type in ("INT", "LONG"):
        return int(v)
    if d.result_type in ("FLOAT", "DOUBLE"):
        return float(v)
    if d.result_type == "BOOLEAN":
        return bool(v)
    return v if isinstance(v, str) else str(v)


_FINAL: Dict[str, Callable[[AggDef, Any], Any]] = {
    "count": lambda d, s: int(s),
    "sum": lambda d, s: float(s),
    "min": lambda d, s: float(s),
    "max": lambda d, s: float(s),
    # sum / count, -inf for an empty group (as the reference does)
    "avg": lambda d, s: s[0] / s[1] if s[1] else NEG_INF,
    "minmaxrange": lambda d, s: float(s[1] - s[0]),
    "distinctcount": lambda d, s: len(s),
    # the raw form returns the serialized sketch itself, as hex
    "distinctcounthll": lambda d, s: (
        s.hex() if d.name.startswith("distinctcountrawhll")
        else HyperLogLog.deserialize(s).cardinality()),
    "mode": lambda d, s: (float(max(s, key=lambda k: (s[k], k)))
                          if s else NEG_INF),
    "percentile": _final_percentile,
    "percentiletdigest": lambda d, s: TDigest.deserialize(s).quantile(
        d.percentile / 100.0),
    "distinctcountthetasketch": lambda d, s: (
        s.hex() if d.name.startswith("distinctcountrawthetasketch")
        else int(round(ThetaSketch.deserialize(s).estimate()))),
    "sumprecision": _final_sumprecision,
    "idset": _final_idset,
    "lastwithtime": _final_withtime,
    "firstwithtime": _final_withtime,
    "stunion": lambda d, s: s,
}


# -- host computation per family ---------------------------------------------

def _host_count(d: AggDef, values, mask) -> int:
    if d.mv:
        return int(values.counts[mask].sum())
    return int(np.count_nonzero(mask))


def _flat_filtered(d: AggDef, values, mask) -> np.ndarray:
    """Filtered values as f64 (MV: every value of the matching rows)."""
    if d.mv:
        return values.flat(mask).astype(np.float64)
    return np.asarray(values, dtype=np.float64)[mask]


def _raw_filtered(d: AggDef, values, mask) -> list:
    """Filtered values kept as they are (strings included), MV flattened."""
    if d.mv:
        return values.flat(mask).tolist()
    return np.asarray(values)[mask].tolist()


def _host_sum(d: AggDef, values, mask) -> float:
    return float(_flat_filtered(d, values, mask).sum())


def _host_min(d: AggDef, values, mask) -> float:
    v = _flat_filtered(d, values, mask)
    return float(v.min()) if v.size else POS_INF


def _host_max(d: AggDef, values, mask) -> float:
    v = _flat_filtered(d, values, mask)
    return float(v.max()) if v.size else NEG_INF


def _host_avg(d: AggDef, values, mask):
    v = _flat_filtered(d, values, mask)
    return (float(v.sum()), int(v.size))


def _host_minmaxrange(d: AggDef, values, mask):
    v = _flat_filtered(d, values, mask)
    if not v.size:
        return (POS_INF, NEG_INF)
    return (float(v.min()), float(v.max()))


def _host_distinctcount(d: AggDef, values, mask):
    if d.mv:
        return frozenset(values.distinct(mask))
    vals = np.asarray(values)[mask]
    if vals.dtype == object:
        # hashing the strings gives np.unique's set without sorting them
        return frozenset(vals.tolist())
    return frozenset(np.unique(vals).tolist())


def _host_mode(d: AggDef, values, mask):
    v = _flat_filtered(d, values, mask)
    uniq, counts = np.unique(v, return_counts=True)
    return {float(u): int(c) for u, c in zip(uniq, counts)}


def _host_percentile(d: AggDef, values, mask):
    return tuple(_flat_filtered(d, values, mask).tolist())


def _host_hll(d: AggDef, values, mask):
    vals = values.flat(mask) if d.mv else np.asarray(values)[mask]
    h = HyperLogLog()
    if len(vals):
        h.add_values(vals)
    return h.serialize()


def _host_tdigest(d: AggDef, values, mask):
    return TDigest.of(_flat_filtered(d, values, mask)).serialize()


def _host_sumprecision(d: AggDef, values, mask):
    total = _decimal.Decimal(0)
    for v in _raw_filtered(d, values, mask):
        total = _exact_dec_add(total, _decimal.Decimal(str(v)))
    return str(total)


def _host_theta(d: AggDef, values, mask):
    return ThetaSketch.of(_raw_filtered(d, values, mask)).serialize()


def _host_idset(d: AggDef, values, mask):
    return frozenset(_raw_filtered(d, values, mask))


def _host_withtime(d: AggDef, values, mask):
    """``values`` is (values, times): the row with the extreme time, the
    extreme value among rows that tie on it."""
    vals, times = values
    idx = np.nonzero(np.asarray(mask))[0]
    if idx.size == 0:
        return None
    t = np.asarray(times)[idx]  # native dtype: float times must not truncate
    pos = int(np.argmax(t) if d.base == "lastwithtime" else np.argmin(t))
    chosen_time = t[pos].item() if hasattr(t[pos], "item") else t[pos]
    tied = idx[t == t[pos]]
    cand = [vals[int(i)] for i in tied]
    cand = [c.item() if hasattr(c, "item") else c for c in cand]
    v = max(cand) if d.base == "lastwithtime" else min(cand)
    return (chosen_time, v)


def _host_stunion(d: AggDef, values, mask):
    from pinot_tpu_torch.utils import geo

    vals = _raw_filtered(d, values, mask)
    if not vals:
        return ""
    g = geo.union([geo.parse_ewkt(str(v)) for v in vals])
    return (geo.GEOG_PREFIX + g.wkt()) if g.geography else g.wkt()


_HOST: Dict[str, Callable] = {
    "count": _host_count,
    "sum": _host_sum,
    "min": _host_min,
    "max": _host_max,
    "avg": _host_avg,
    "minmaxrange": _host_minmaxrange,
    "distinctcount": _host_distinctcount,
    "distinctcounthll": _host_hll,
    "mode": _host_mode,
    "percentile": _host_percentile,
    "percentiletdigest": _host_tdigest,
    "distinctcountthetasketch": _host_theta,
    "sumprecision": _host_sumprecision,
    "idset": _host_idset,
    "lastwithtime": _host_withtime,
    "firstwithtime": _host_withtime,
    "stunion": _host_stunion,
}


# -- resolution -----------------------------------------------------------------

_RESULT_TYPE = {
    "count": "LONG", "sum": "DOUBLE", "min": "DOUBLE", "max": "DOUBLE",
    "avg": "DOUBLE", "minmaxrange": "DOUBLE", "distinctcount": "INT",
    "distinctcounthll": "LONG", "mode": "DOUBLE", "percentile": "DOUBLE",
    "percentiletdigest": "DOUBLE", "distinctcountthetasketch": "LONG",
    "sumprecision": "STRING", "idset": "STRING", "lastwithtime": "DOUBLE",
    "firstwithtime": "DOUBLE", "stunion": "STRING",
}

# families with device kernels (engine/kernels.py); an MV form is device
# scalar for the first five only and never grouped
_DEVICE_SCALAR = {"count", "sum", "min", "max", "avg", "minmaxrange",
                  "distinctcount", "distinctcounthll"}
_DEVICE_GROUPED = {"count", "sum", "min", "max", "avg", "minmaxrange",
                   "distinctcounthll"}
_DEVICE_SCALAR_MV = {"count", "sum", "min", "max", "avg"}

_FAMILY = {
    "count": "count", "sum": "sum", "min": "min", "max": "max",
    "avg": "avg", "minmaxrange": "minmaxrange",
    "distinctcount": "distinctcount", "distinctcountbitmap": "distinctcount",
    "segmentpartitioneddistinctcount": "distinctcount",
    "distinctcounthll": "distinctcounthll",
    "distinctcountrawhll": "distinctcounthll",
    "mode": "mode",
    "percentile": "percentile", "percentileest": "percentile",
    "percentiletdigest": "percentiletdigest",
    "distinctcountthetasketch": "distinctcountthetasketch",
    "sumprecision": "sumprecision",
    "distinctcountrawthetasketch": "distinctcountthetasketch",
    "idset": "idset",
    "lastwithtime": "lastwithtime",
    "firstwithtime": "firstwithtime",
    "stunion": "stunion", "st_union": "stunion",
}


def resolve_agg(fn: Function) -> AggDef:
    """Canonical Function -> AggDef (the JAX package's ``resolve_agg``)."""
    name = fn.name
    mv = name.endswith("mv")
    base_name = name[:-2] if mv else name

    percentile = None
    for prefix in ("percentiletdigest", "percentileest", "percentile"):
        if base_name.startswith(prefix):
            digits = base_name[len(prefix):]
            if digits.isdigit():
                percentile = float(digits)
                base_name = prefix
                break
            if digits == "":
                if len(fn.args) >= 2 and isinstance(fn.args[1], Literal):
                    percentile = float(fn.args[1].value)
                    base_name = prefix
                    break
                raise QueryError(f"{name} requires a percentile argument")

    family = _FAMILY.get(base_name)
    if family is None:
        raise UnsupportedQueryError(
            f"aggregation function {name!r} not supported")
    result_type = _RESULT_TYPE[family]
    if base_name in ("distinctcountrawhll", "distinctcountrawthetasketch"):
        result_type = "STRING"
    precision = None
    if family == "sumprecision" and len(fn.args) >= 2:
        if not (isinstance(fn.args[1], Literal)
                and type(fn.args[1].value) is int
                and fn.args[1].value >= 1):
            raise QueryError(
                "sumprecision precision must be an int literal >= 1")
        precision = int(fn.args[1].value)
    if family in ("lastwithtime", "firstwithtime"):
        if len(fn.args) != 3:
            raise QueryError(
                f"{name} requires (valueColumn, timeColumn, 'dataType')")
        dt = fn.args[2]
        if not isinstance(dt, Literal) or not isinstance(dt.value, str):
            raise QueryError(f"{name}: dataType argument must be a string")
        result_type = dt.value.upper()
        if result_type not in ("INT", "LONG", "FLOAT", "DOUBLE", "STRING",
                               "BOOLEAN"):
            raise QueryError(f"{name}: unsupported dataType {dt.value!r}")
    return AggDef(
        name=name, base=family, mv=mv, percentile=percentile,
        precision=precision,
        device_scalar=(family in _DEVICE_SCALAR_MV if mv
                       else family in _DEVICE_SCALAR),
        device_grouped=not mv and family in _DEVICE_GROUPED,
        result_type=result_type)


def agg_value_expr(fn: Function) -> Optional[Expr]:
    """The expression aggregated over, or None for COUNT(*)."""
    if not fn.args:
        return None
    a0 = fn.args[0]
    if isinstance(a0, Identifier) and a0.name == "*":
        return None
    return a0
