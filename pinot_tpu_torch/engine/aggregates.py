"""Aggregation functions: state algebra and resolution.

Counterpart of ``pinot_tpu/engine/aggregates.py``. Every aggregation name
the JAX package knows resolves to its family, MV form and device flags
(``resolve_agg``, the JAX family table and flags at :440-529); the planner
refuses what has no device kernel with the JAX reason code. States, merge
and finalize exist for the device families: count, sum, avg, min, max,
minmaxrange, distinctcount and distinctcounthll, and the MV forms of the
first five (countmv, summv, minmv, maxmv, avgmv: scalar only, their state
is the family's). States are plain python values that merge across
segments (a distinct count's state is the frozenset of values, an HLL's
its serialized registers). The host-only families (mode, percentile*,
theta sketches, idset, sumprecision, lastwithtime/firstwithtime, stunion)
and grouped distinctcount are served by the JAX host engine, which is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from pinot_tpu_torch.engine.errors import QueryError, UnsupportedQueryError
from pinot_tpu_torch.query.expressions import (
    Expr,
    Function,
    Identifier,
    Literal,
)
from pinot_tpu_torch.utils.hll import HyperLogLog

POS_INF = float("inf")
NEG_INF = float("-inf")


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
        return _FINAL[self.base](state)


_EMPTY: Dict[str, Any] = {
    "count": 0,
    "sum": 0.0,
    "min": POS_INF,
    "max": NEG_INF,
    "avg": (0.0, 0),
    "minmaxrange": (POS_INF, NEG_INF),
    "distinctcount": frozenset(),
    "distinctcounthll": lambda: HyperLogLog().serialize(),
}

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
}

_FINAL: Dict[str, Callable[[Any], Any]] = {
    "count": lambda s: int(s),
    "sum": lambda s: float(s),
    "min": lambda s: float(s),
    "max": lambda s: float(s),
    # sum / count, -inf for an empty group (as the reference does)
    "avg": lambda s: s[0] / s[1] if s[1] else NEG_INF,
    "minmaxrange": lambda s: float(s[1] - s[0]),
    "distinctcount": lambda s: len(s),
    "distinctcounthll": lambda s: HyperLogLog.deserialize(s).cardinality(),
}

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
