"""Aggregation functions: state algebra and resolution.

Counterpart of ``pinot_tpu/engine/aggregates.py`` for count, sum, avg, min,
max, minmaxrange, distinctcount and distinctcounthll. States are plain
python values that merge across segments (a distinct count's state is the
frozenset of values, an HLL's its serialized registers). Grouped
distinctcount is host-only in the JAX package, so the planner declines it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from pinot_tpu_torch.engine.errors import UnsupportedQueryError
from pinot_tpu_torch.query.expressions import Expr, Function, Identifier
from pinot_tpu_torch.utils.hll import HyperLogLog

POS_INF = float("inf")
NEG_INF = float("-inf")


@dataclass
class AggDef:
    name: str
    base: str
    mv: bool = False
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

_RESULT_TYPE = {"count": "LONG", "distinctcount": "INT",
                "distinctcounthll": "LONG"}


def resolve_agg(fn: Function) -> AggDef:
    """Canonical Function -> AggDef."""
    if fn.name not in _EMPTY:
        raise UnsupportedQueryError(
            f"aggregation function {fn.name!r} not supported")
    return AggDef(name=fn.name, base=fn.name,
                  device_grouped=fn.name != "distinctcount",
                  result_type=_RESULT_TYPE.get(fn.name, "DOUBLE"))


def agg_value_expr(fn: Function) -> Optional[Expr]:
    """The expression aggregated over, or None for COUNT(*)."""
    if not fn.args:
        return None
    a0 = fn.args[0]
    if isinstance(a0, Identifier) and a0.name == "*":
        return None
    return a0
