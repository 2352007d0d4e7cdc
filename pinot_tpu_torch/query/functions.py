"""Scalar function registry: row-level functions the host engine calls.

Counterpart of ``pinot_tpu/query/functions.py``: a name -> callable
registry (string, math, time, JSON, array, idset and ST_ functions) that
``engine/host_eval.py`` evaluates row by row over argument arrays,
``eval_scalar`` over one row's values, and ``eval_row_filter``, the
ingestion filter over one row (``ingestion/transformers.py``).
"""

from __future__ import annotations

import datetime as _dt
import functools
import json as _json
import math
import re

from typing import Any, Callable, Dict, List, Optional

from pinot_tpu_torch.query.expressions import (
    Expr,
    FilterNode,
    FilterOp,
    Function,
    Identifier,
    Literal,
    Predicate,
    PredicateType,
)

_REGISTRY: Dict[str, Callable] = {}


def scalar_function(name: Optional[str] = None, aliases: List[str] = ()):
    """Ref: @ScalarFunction annotation."""

    def wrap(fn: Callable) -> Callable:
        _REGISTRY[(name or fn.__name__).lower()] = fn
        for a in aliases:
            _REGISTRY[a.lower()] = fn
        return fn

    return wrap


def lookup(name: str) -> Optional[Callable]:
    return _REGISTRY.get(name.lower())


def registered_functions() -> List[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------
# row-level expression evaluation
# --------------------------------------------------------------------------

class EvalError(Exception):
    pass


def eval_scalar(expr: Expr, env: Dict[str, Any]) -> Any:
    """Evaluate an expression over one row env (ref: InbuiltFunctionEvaluator)."""
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, Identifier):
        if expr.name not in env:
            raise EvalError(f"unknown field {expr.name!r}")
        return env[expr.name]
    if isinstance(expr, Function):
        args = [eval_scalar(a, env) for a in expr.args]
        fn = _REGISTRY.get(expr.name)
        if fn is None:
            raise EvalError(f"unknown function {expr.name!r}")
        if any(a is None for a in args):
            # null propagates (ref: FunctionInvoker — non-nullable
            # parameters skip invocation and yield null)
            return None
        return fn(*args)
    raise EvalError(f"cannot evaluate {expr!r}")


def eval_row_filter(node: FilterNode, env: Dict[str, Any]) -> bool:
    """A boolean filter over one row (the ingestion FilterTransformer's;
    JAX ``functions.py:84``): a null value matches no comparison."""
    if node.op is FilterOp.AND:
        return all(eval_row_filter(c, env) for c in node.children)
    if node.op is FilterOp.OR:
        return any(eval_row_filter(c, env) for c in node.children)
    if node.op is FilterOp.NOT:
        return not eval_row_filter(node.children[0], env)
    return _eval_row_predicate(node.predicate, env)


def _eval_row_predicate(p: Predicate, env: Dict[str, Any]) -> bool:
    v = eval_scalar(p.lhs, env)
    t = p.type
    if t is PredicateType.IS_NULL:
        return v is None
    if t is PredicateType.IS_NOT_NULL:
        return v is not None
    if v is None:
        return False
    if t is PredicateType.EQ:
        return _loose_eq(v, p.value)
    if t is PredicateType.NOT_EQ:
        return not _loose_eq(v, p.value)
    if t is PredicateType.IN:
        return any(_loose_eq(v, x) for x in p.values)
    if t is PredicateType.NOT_IN:
        return not any(_loose_eq(v, x) for x in p.values)
    if t is PredicateType.RANGE:
        if p.lower is not None:
            lo = _coerce_like(v, p.lower)
            if not (v >= lo if p.lower_inclusive else v > lo):
                return False
        if p.upper is not None:
            hi = _coerce_like(v, p.upper)
            if not (v <= hi if p.upper_inclusive else v < hi):
                return False
        return True
    if t is PredicateType.REGEXP_LIKE:
        return re.search(str(p.value), str(v)) is not None
    raise EvalError(f"predicate {t} not supported in row filters")


def _coerce_like(template: Any, v: Any) -> Any:
    if isinstance(template, (int, float)) and isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return v
    return v


def _loose_eq(a: Any, b: Any) -> bool:
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return float(a) == float(b)
    return a == b


# --------------------------------------------------------------------------
# builtin scalar functions (ref: pinot-common/.../function/scalar/*)
# --------------------------------------------------------------------------

# ---- arithmetic (operator canonical forms) ----

@scalar_function()
def plus(a, b):
    return a + b


@scalar_function()
def minus(a, b):
    return a - b


@scalar_function()
def times(a, b):
    return a * b


@scalar_function()
def divide(a, b):
    return a / b


@scalar_function(name="mod")
def _mod(a, b):
    return a % b


@scalar_function(name="abs")
def _abs(a):
    return abs(a)


@scalar_function(name="ceil", aliases=["ceiling"])
def _ceil(a):
    return float(math.ceil(a))


@scalar_function(name="floor")
def _floor(a):
    return float(math.floor(a))


@scalar_function(name="exp")
def _exp(a):
    return math.exp(a)


@scalar_function(name="ln")
def _ln(a):
    return math.log(a)


@scalar_function(name="log10")
def _log10(a):
    return math.log10(a)


@scalar_function(name="log2")
def _log2(a):
    return math.log2(a)


@scalar_function(name="sqrt")
def _sqrt(a):
    return math.sqrt(a)


@scalar_function(name="power", aliases=["pow"])
def _power(a, b):
    return math.pow(a, b)


@scalar_function(name="round")
def _round(a, scale=0):
    return round(a, int(scale)) if scale else float(round(a))


@scalar_function(name="least")
def _least(*args):
    return min(args)


@scalar_function(name="greatest")
def _greatest(*args):
    return max(args)


# ---- string (ref: StringFunctions.java) ----

@scalar_function(name="upper")
def _upper(s):
    return str(s).upper()


@scalar_function(name="lower")
def _lower(s):
    return str(s).lower()


@scalar_function(name="trim")
def _trim(s):
    return str(s).strip()


@scalar_function(name="ltrim")
def _ltrim(s):
    return str(s).lstrip()


@scalar_function(name="rtrim")
def _rtrim(s):
    return str(s).rstrip()


@scalar_function(name="length")
def _length(s):
    return len(str(s))


@scalar_function(name="reverse")
def _reverse(s):
    return str(s)[::-1]


@scalar_function(name="substr", aliases=["substring"])
def _substr(s, start, end=None):
    # reference semantics: 0-based start; end exclusive; -1 end = rest
    s = str(s)
    start = int(start)
    if end is None or int(end) == -1:
        return s[start:]
    return s[start:int(end)]


@scalar_function(name="concat")
def _concat(a, b, sep=""):
    return f"{a}{sep}{b}"


@scalar_function(name="replace")
def _replace(s, find, sub):
    return str(s).replace(str(find), str(sub))


@scalar_function(name="lpad")
def _lpad(s, size, pad=" "):
    s = str(s)
    size = int(size)
    while len(s) < size:
        s = pad + s
    return s[-size:] if len(s) > size else s


@scalar_function(name="rpad")
def _rpad(s, size, pad=" "):
    s = str(s)
    size = int(size)
    while len(s) < size:
        s = s + pad
    return s[:size]


@scalar_function(name="strpos")
def _strpos(s, find, instance=1):
    s, find = str(s), str(find)
    pos = -1
    for _ in range(int(instance)):
        pos = s.find(find, pos + 1)
        if pos < 0:
            return -1
    return pos


@scalar_function(name="startswith", aliases=["startsWith"])
def _startswith(s, prefix):
    return str(s).startswith(str(prefix))


@scalar_function(name="split")
def _split(s, sep):
    return str(s).split(str(sep))


@scalar_function(name="hammingdistance", aliases=["hammingDistance"])
def _hamming(a, b):
    a, b = str(a), str(b)
    if len(a) != len(b):
        return -1
    return sum(1 for x, y in zip(a, b) if x != y)


# ---- datetime (ref: DateTimeFunctions.java) ----

@scalar_function(name="now")
def _now():
    import time as _t

    return int(_t.time() * 1000)


@scalar_function(name="toepochseconds", aliases=["toEpochSeconds"])
def _to_epoch_seconds(ms):
    return int(ms) // 1000


@scalar_function(name="toepochminutes", aliases=["toEpochMinutes"])
def _to_epoch_minutes(ms):
    return int(ms) // 60_000


@scalar_function(name="toepochhours", aliases=["toEpochHours"])
def _to_epoch_hours(ms):
    return int(ms) // 3_600_000


@scalar_function(name="toepochdays", aliases=["toEpochDays"])
def _to_epoch_days(ms):
    return int(ms) // 86_400_000


@scalar_function(name="fromepochseconds", aliases=["fromEpochSeconds"])
def _from_epoch_seconds(s):
    return int(s) * 1000


@scalar_function(name="fromepochminutes", aliases=["fromEpochMinutes"])
def _from_epoch_minutes(m):
    return int(m) * 60_000


@scalar_function(name="fromepochhours", aliases=["fromEpochHours"])
def _from_epoch_hours(h):
    return int(h) * 3_600_000


@scalar_function(name="fromepochdays", aliases=["fromEpochDays"])
def _from_epoch_days(d):
    return int(d) * 86_400_000


_JAVA_TO_STRFTIME = [
    ("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
    ("mm", "%M"), ("ss", "%S"), ("SSS", "%f"),
]


def _to_strftime(java_fmt: str) -> str:
    out = java_fmt
    for j, s in _JAVA_TO_STRFTIME:
        out = out.replace(j, s)
    return out


@scalar_function(name="todatetime", aliases=["toDateTime"])
def _to_datetime(ms, fmt):
    dt = _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc)
    s = dt.strftime(_to_strftime(str(fmt)))
    if "%f" in _to_strftime(str(fmt)):
        # strftime %f is microseconds; java SSS is millis
        s = s.replace(dt.strftime("%f"), dt.strftime("%f")[:3])
    return s


@scalar_function(name="fromdatetime", aliases=["fromDateTime"])
def _from_datetime(s, fmt):
    dt = _dt.datetime.strptime(str(s), _to_strftime(str(fmt)))
    return int(dt.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000)


# fixed-width unit tables, shared with the device transform rewrites
# (engine/plan.py imports these so the host oracle and the device integer
# rewrite can never diverge on a unit's width)
TRUNC_UNIT_MS = {
    "millisecond": 1, "second": 1000, "minute": 60_000, "hour": 3_600_000,
    "day": 86_400_000, "week": 7 * 86_400_000,
}
TIME_UNIT_MS = {
    "MILLISECONDS": 1, "SECONDS": 1000, "MINUTES": 60_000,
    "HOURS": 3_600_000, "DAYS": 86_400_000,
}
_TRUNC_UNIT_MS = TRUNC_UNIT_MS


@scalar_function(name="datetrunc", aliases=["dateTrunc"])
def _date_trunc(unit, ms):
    u = str(unit).lower()
    if u in _TRUNC_UNIT_MS:
        q = _TRUNC_UNIT_MS[u]
        return (int(ms) // q) * q
    dt = _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc)
    if u == "month":
        dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif u == "quarter":
        dt = dt.replace(month=(dt.month - 1) // 3 * 3 + 1, day=1, hour=0,
                        minute=0, second=0, microsecond=0)
    elif u == "year":
        dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                        microsecond=0)
    else:
        raise EvalError(f"datetrunc unit {unit!r}")
    return int(dt.timestamp() * 1000)


@scalar_function(name="year")
def _year(ms):
    return _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc).year


@scalar_function(name="month", aliases=["monthofyear", "monthOfYear"])
def _month(ms):
    return _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc).month


@scalar_function(name="dayofmonth", aliases=["dayOfMonth", "day"])
def _day_of_month(ms):
    return _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc).day


@scalar_function(name="dayofweek", aliases=["dayOfWeek"])
def _day_of_week(ms):
    # ISO: Monday=1..Sunday=7 (joda DateTimeField semantics)
    return _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc).isoweekday()


@scalar_function(name="hour")
def _hour(ms):
    return _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc).hour


@scalar_function(name="minute")
def _minute(ms):
    return _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc).minute


@scalar_function(name="second")
def _second(ms):
    return _dt.datetime.fromtimestamp(int(ms) / 1000.0, tz=_dt.timezone.utc).second


@scalar_function(name="timeconvert", aliases=["timeConvert"])
def _time_convert(value, from_unit, to_unit):
    ms = int(value) * TIME_UNIT_MS[str(from_unit).upper()]
    return ms // TIME_UNIT_MS[str(to_unit).upper()]


# ---- json (ref: JsonFunctions.java) ----

def _json_path_get(obj: Any, path: str) -> Any:
    """Subset of JsonPath: $.a.b[0].c"""
    if not path.startswith("$"):
        raise EvalError(f"json path must start with $: {path!r}")
    cur = obj
    for part in re.findall(r"\.([A-Za-z_][\w]*)|\[(\d+)\]", path):
        name, idx = part
        if cur is None:
            return None
        if name:
            if not isinstance(cur, dict):
                return None
            cur = cur.get(name)
        else:
            if not isinstance(cur, list) or int(idx) >= len(cur):
                return None
            cur = cur[int(idx)]
    return cur


@scalar_function(name="jsonpath", aliases=["jsonPath", "json_extract_scalar",
                                           "jsonextractscalar", "jsonExtractScalar"])
def _json_path(blob, path, result_type="STRING", default=None):
    obj = _json.loads(blob) if isinstance(blob, (str, bytes)) else blob
    v = _json_path_get(obj, str(path))
    if v is None:
        return default
    t = str(result_type).upper()
    if t in ("INT", "LONG"):
        return int(v)
    if t in ("FLOAT", "DOUBLE"):
        return float(v)
    if t == "STRING":
        return v if isinstance(v, str) else _json.dumps(v)
    return v


@scalar_function(name="jsonformat", aliases=["jsonFormat"])
def _json_format(obj):
    return _json.dumps(obj, separators=(",", ":"))


@scalar_function(name="tojsonmapstr", aliases=["toJsonMapStr"])
def _to_json_map_str(m):
    return _json.dumps(m, separators=(",", ":"))


# ---- array / multi-value (ref: ArrayFunctions) ----

@scalar_function(name="arraylength", aliases=["arrayLength", "cardinality"])
def _array_length(a):
    return len(a)


@scalar_function(name="arraymin", aliases=["arrayMin"])
def _array_min(a):
    return min(a)


@scalar_function(name="arraymax", aliases=["arrayMax"])
def _array_max(a):
    return max(a)


@scalar_function(name="arraysum", aliases=["arraySum"])
def _array_sum(a):
    return sum(a)


@scalar_function(name="arrayaverage", aliases=["arrayAverage"])
def _array_average(a):
    return sum(a) / len(a)


@scalar_function(name="arraydistinct", aliases=["arrayDistinct"])
def _array_distinct(a):
    out = []
    for x in a:
        if x not in out:
            out.append(x)
    return out


@scalar_function(name="valuein", aliases=["valueIn"])
def _value_in(a, *allowed):
    allow = set(allowed)
    return [x for x in a if x in allow]


@functools.lru_cache(maxsize=64)
def _decode_idset(serialized_idset: str) -> frozenset:
    import base64

    from pinot_tpu_torch.utils import serde

    return frozenset(serde.loads(base64.b64decode(serialized_idset)))


@scalar_function(name="inidset", aliases=["inIdSet", "in_id_set"])
def _in_id_set(value, serialized_idset):
    """Membership test against an IDSET() aggregation result (ref:
    InIdSetTransformFunction consuming IdSetAggregationFunction's base64
    payload) -> 1/0 like the reference's boolean-as-int transforms. The
    decoded set is cached: row-level eval calls this once per row."""
    v = value.item() if hasattr(value, "item") else value
    return 1 if v in _decode_idset(serialized_idset) else 0


# --------------------------------------------------------------------------
# geospatial (ref: pinot-core geospatial/transform/function/*; geography is
# carried through strings with the EWKT "SRID=4326;" prefix rather than the
# reference's serialized-bytes + SRID flag)
# --------------------------------------------------------------------------

def _parse_geo(v):
    from pinot_tpu_torch.utils import geo

    return geo.parse_ewkt(v)


@scalar_function(name="stpoint", aliases=["ST_Point", "st_point"])
def _st_point(x, y, is_geography=0):
    from pinot_tpu_torch.utils import geo

    g = geo.point(float(x), float(y), bool(is_geography))
    return (geo.GEOG_PREFIX + g.wkt()) if g.geography else g.wkt()


@scalar_function(name="stgeomfromtext", aliases=["ST_GeomFromText"])
def _st_geom_from_text(wkt):
    return _parse_geo(wkt).wkt()


@scalar_function(name="stgeogfromtext", aliases=["ST_GeogFromText"])
def _st_geog_from_text(wkt):
    from pinot_tpu_torch.utils import geo

    g = geo.from_wkt(str(wkt), geography=True)
    return geo.GEOG_PREFIX + g.wkt()


@scalar_function(name="stastext", aliases=["ST_AsText"])
def _st_as_text(v):
    return _parse_geo(v).wkt()


@scalar_function(name="stdistance", aliases=["ST_Distance"])
def _st_distance(a, b):
    from pinot_tpu_torch.utils import geo

    return geo.distance(_parse_geo(a), _parse_geo(b))


@scalar_function(name="stcontains", aliases=["ST_Contains"])
def _st_contains(outer, inner):
    from pinot_tpu_torch.utils import geo

    return 1 if geo.contains(_parse_geo(outer), _parse_geo(inner)) else 0


@scalar_function(name="stwithin", aliases=["ST_Within"])
def _st_within(inner, outer):
    from pinot_tpu_torch.utils import geo

    return 1 if geo.contains(_parse_geo(outer), _parse_geo(inner)) else 0


@scalar_function(name="starea", aliases=["ST_Area"])
def _st_area(g):
    from pinot_tpu_torch.utils import geo

    return geo.area(_parse_geo(g))


@scalar_function(name="stx", aliases=["ST_X"])
def _st_x(g):
    return _parse_geo(g).x


@scalar_function(name="sty", aliases=["ST_Y"])
def _st_y(g):
    return _parse_geo(g).y
