"""Per-segment plan: QueryContext + segment metadata -> spec + params.

Counterpart of ``pinot_tpu/engine/plan.py`` (``plan_segment``,
``narrow_plan_groups``): dictionary filters (eq/neq/range/lut), their
multi-value forms (``mv_*``, ANY value matches; an exclusive predicate on
an MV column is the NOT of its inclusive form), raw-value filters
(veq/vneq/vrange/vin/vnotin), ``isnull``/``isnotnull``, the upsert
``validdocs`` leaf; ``gdict``, ``graw`` and ``gexpr`` group keys (bounded
integral ``+ - * mod floordiv`` expressions); ``colmv`` values of the MV
aggregations; and the device DISTINCTCOUNTHLL with its per-dictId register
tables. REGEXP_LIKE (and LIKE, which the optimizer rewrites to it),
TEXT_MATCH and JSON_MATCH on a dictionary column are ``lut``/``mv_lut``
leaves over a table evaluated once per distinct value, or resolved by the
column's FST or text index where it has one. The epoch time
transforms (``toEpoch*``, ``fromEpoch*``, ``dateTrunc``, ``timeConvert``)
are rewritten at plan time into ``floordiv``/``times``/``minus(mod)``
trees. The spec (a hashable structural description) and the params (the
runtime values, in the order the kernel side consumes them) equal the JAX
package's for the same SQL and segment, so the eligibility rules
downstream read the same input.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.engine.aggregates import AggDef, agg_value_expr, resolve_agg
from pinot_tpu_torch.engine.errors import PlanError, QueryError
from pinot_tpu_torch.engine.staging import raw_staged_dtype
from pinot_tpu_torch.query.context import QueryContext
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
from pinot_tpu_torch.segment.immutable import DataSource, ImmutableSegment
from pinot_tpu_torch.segment.jsonindex import (
    match_json_value,
    parse_match_filter,
)
from pinot_tpu_torch.segment.mutable import is_arrival_ordered, is_mutable
from pinot_tpu_torch.segment.textindex import (
    match_text_value,
    parse_text_query,
)
from pinot_tpu_torch.utils.hll import DEFAULT_LOG2M

# composed group key space past which the JAX package leaves the device
MAX_DEVICE_GROUPS = 1 << 21

_I32_MAX = int(np.iinfo(np.int32).max)

_ARITH_OPS = {"plus", "minus", "times", "divide", "mod", "floordiv"}
# the integral operations whose bounds propagate (true division is float)
_INT_OPS = ("plus", "minus", "times", "mod", "floordiv")


# epoch-arithmetic transforms compile to exact integer ops; fixed-width
# units only (the JAX package's query/functions.py TIME_UNIT_MS and
# TRUNC_UNIT_MS): calendar units are not device-expressible
_UNIT_MS = {"MILLISECONDS": 1, "SECONDS": 1000, "MINUTES": 60_000,
            "HOURS": 3_600_000, "DAYS": 86_400_000}
_TRUNC_MS = {"millisecond": 1, "second": 1000, "minute": 60_000,
             "hour": 3_600_000, "day": 86_400_000, "week": 7 * 86_400_000}
_TIME_DIV = {"toepochseconds": _UNIT_MS["SECONDS"],
             "toepochminutes": _UNIT_MS["MINUTES"],
             "toepochhours": _UNIT_MS["HOURS"],
             "toepochdays": _UNIT_MS["DAYS"]}
_TIME_MUL = {"fromepochseconds": _UNIT_MS["SECONDS"],
             "fromepochminutes": _UNIT_MS["MINUTES"],
             "fromepochhours": _UNIT_MS["HOURS"],
             "fromepochdays": _UNIT_MS["DAYS"]}


def _device_transform_rewrite(e: Function) -> Optional[Expr]:
    """Time transform -> the equivalent plus/minus/times/mod/floordiv
    tree, or None when it is not device-expressible. Applied at plan time
    only, so response column names keep the user's expression."""
    n = e.name
    if n in _TIME_DIV and len(e.args) == 1:
        return Function("floordiv", (e.args[0], Literal(_TIME_DIV[n])))
    if n in _TIME_MUL and len(e.args) == 1:
        return Function("times", (e.args[0], Literal(_TIME_MUL[n])))
    if (n == "datetrunc" and len(e.args) == 2
            and isinstance(e.args[0], Literal)):
        q = _TRUNC_MS.get(str(e.args[0].value).lower())
        if q == 1:
            return e.args[1]
        if q:
            # trunc(v, q) = v - (v mod q), exact for negatives (floor mod)
            return Function("minus", (e.args[1], Function(
                "mod", (e.args[1], Literal(q)))))
        return None
    if (n == "timeconvert" and len(e.args) == 3
            and all(isinstance(a, Literal) for a in e.args[1:])):
        ma = _UNIT_MS.get(str(e.args[1].value).upper())
        mb = _UNIT_MS.get(str(e.args[2].value).upper())
        if ma is None or mb is None:
            return None
        inner: Expr = (e.args[0] if ma == 1
                       else Function("times", (e.args[0], Literal(ma))))
        return inner if mb == 1 else Function("floordiv",
                                              (inner, Literal(mb)))
    return None


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclass
class SegmentPlan:
    spec: Tuple              # (filter, aggs, group specs, num_groups, capacity)
    params: List[Any]        # runtime values, consumed in order
    columns: List[str]
    group_defs: List[Tuple[str, Any]]
    group_cards: List[int]
    group_strides: Optional[np.ndarray]
    num_groups: int          # padded total group count (0 = not group-by)
    agg_defs: List[AggDef]
    group_bases: List[int] = field(default_factory=list)
    # the spec this plan was narrowed from (probe-narrowed plans only)
    narrowed_from: Optional[Tuple] = None
    # device -> params uploaded there (engine/kernels.py device_params)
    device_params: Dict[Any, Tuple] = field(default_factory=dict,
                                            repr=False, compare=False)
    # capacity -> this plan's gathered-block plan (engine/index_exec.py)
    gathered: Dict[int, "SegmentPlan"] = field(default_factory=dict,
                                               repr=False, compare=False)


def plan_segment(ctx: QueryContext, segment: ImmutableSegment) -> SegmentPlan:
    if is_mutable(segment):
        # a consuming segment plans through its watermark view
        # (engine/mutable_staging.py), never directly (JAX :282-285)
        raise PlanError("mutable segment -> host path")
    params: List[Any] = []
    columns: List[str] = []

    filter_spec = _compile_filter(ctx.filter, segment, params, columns)
    # collected before the validdocs placeholder shifts the param slots
    dict_ranges = (_conjunctive_dict_ranges(filter_spec, params)
                   if ctx.group_by else {})
    if getattr(segment, "valid_doc_ids", None) is not None:
        # upsert-managed: the valid-doc snapshot is ANDed into the filter;
        # its param rides first as a placeholder the executor fills with
        # the staged snapshot at run time
        params.insert(0, None)
        filter_spec = ("and", (("validdocs",), filter_spec))
    agg_defs = [resolve_agg(f) for f in ctx.aggregations]

    group_specs: List[Optional[Tuple]] = []
    group_defs: List[Tuple[str, Any]] = []
    group_cards: List[int] = []
    group_bases: List[int] = []
    pending_gexpr: List[Tuple[int, Expr]] = []
    num_groups = 0
    strides = None
    if ctx.group_by:
        for e in ctx.group_by:
            strat, payload, card, base = _group_strategy(e, segment,
                                                         dict_ranges)
            group_cards.append(card)
            group_bases.append(base)
            if strat == "gexpr":
                # compiled after strides/bases, so the literals of the key
                # expression follow them in the params
                group_specs.append(None)
                group_defs.append((strat, base))   # decode adds base back
                pending_gexpr.append((len(group_specs) - 1, e))
            else:
                group_specs.append((strat, payload))
                group_defs.append((strat, payload))
                if payload not in columns:
                    columns.append(payload)
        total = 1
        for c in group_cards:
            total *= c
            if total > MAX_DEVICE_GROUPS:
                raise PlanError(
                    f"group key space {total}+ exceeds device limit")
        num_groups = _next_pow2(total)
        strides = _row_major_strides(group_cards)
        params.append(strides)
        params.append(np.asarray(group_bases, dtype=np.int64))
        for idx, e in pending_gexpr:
            group_specs[idx] = (
                "gexpr", _compile_value(e, segment, params, columns))

    agg_specs: List[Tuple] = []
    for agg, fn in zip(agg_defs, ctx.aggregations):
        ok = agg.device_grouped if ctx.group_by else agg.device_scalar
        if not ok:
            raise PlanError(f"aggregation {agg.name} not device-supported "
                            f"{'grouped' if ctx.group_by else 'scalar'}")
        vexpr = agg_value_expr(fn)
        if agg.base == "distinctcounthll" and not agg.mv:
            # per-dictId (bucket, rank) tables from the dictionary's hashes;
            # the register update is a masked scatter-max on the device
            if not isinstance(vexpr, Identifier) or vexpr.name.startswith("$"):
                raise PlanError("DISTINCTCOUNTHLL argument must be a column")
            cm = segment.metadata.column(vexpr.name)
            if not (cm.has_dictionary and cm.single_value):
                raise PlanError("DISTINCTCOUNTHLL needs an SV dict column")
            m = 1 << DEFAULT_LOG2M
            if num_groups and (num_groups + 1) * m > (1 << 23):
                raise PlanError("grouped HLL register space too large")
            bucket, rank = segment.data_source(
                vexpr.name).dictionary.hll_register_luts(DEFAULT_LOG2M)
            params.append(bucket)
            params.append(rank)
            agg_specs.append(("distinctcounthll", vexpr.name, DEFAULT_LOG2M))
            if vexpr.name not in columns:
                columns.append(vexpr.name)
            continue
        if agg.base == "distinctcount" and not agg.mv:
            if not isinstance(vexpr, Identifier) or vexpr.name.startswith("$"):
                raise PlanError("DISTINCTCOUNT argument must be a column")
            cm = segment.metadata.column(vexpr.name)
            if not cm.has_dictionary:
                raise PlanError("DISTINCTCOUNT on raw column -> host")
            if not cm.single_value:
                raise PlanError("DISTINCTCOUNT on MV column -> host")
            if cm.cardinality > (1 << 20):
                raise PlanError("DISTINCTCOUNT cardinality too large -> host")
            agg_specs.append(("distinctcount", vexpr.name, cm.cardinality))
            if vexpr.name not in columns:
                columns.append(vexpr.name)
            continue
        fanout = 1
        if vexpr is None:
            vspec = None
        elif agg.mv:
            if not isinstance(vexpr, Identifier) or vexpr.name.startswith("$"):
                raise PlanError("MV aggregation argument must be a column")
            cm = segment.metadata.column(vexpr.name)
            if cm.single_value or not cm.data_type.is_numeric:
                raise PlanError(f"{agg.name} needs a numeric MV column")
            vspec = ("colmv", vexpr.name)
            fanout = max(1, cm.max_num_multi_values)
            if vexpr.name not in columns:
                columns.append(vexpr.name)
        else:
            vspec = _compile_value(vexpr, segment, params, columns)
        agg_specs.append((agg.base, agg.mv, vspec,
                          _acc_dtype(agg.base, vexpr, segment, fanout)))

    spec = (filter_spec, tuple(agg_specs), tuple(group_specs), num_groups,
            segment.padded_capacity)
    expected = expected_param_count(spec)
    if len(params) != expected:
        raise AssertionError(
            f"param pack/unpack drift: packed {len(params)} params but the "
            f"spec consumes {expected} (spec={spec[:3]!r})")
    return SegmentPlan(spec=spec, params=params, columns=columns,
                       group_defs=group_defs, group_cards=group_cards,
                       group_strides=strides, num_groups=num_groups,
                       agg_defs=agg_defs, group_bases=group_bases)


def _row_major_strides(cards: List[int]) -> np.ndarray:
    strides = np.ones(len(cards), dtype=np.int32)
    for i in range(len(cards) - 2, -1, -1):
        strides[i] = strides[i + 1] * cards[i + 1]
    return strides


# -- accumulator types (the JAX package narrows accumulators by stats) ------

def _value_kind(e: Expr, segment: ImmutableSegment):
    """('int', max_abs | None) when the expression is integral, else
    ('float', None); integer bounds propagate through + - * mod floordiv
    and the time-transform rewrites, true division is float."""
    if isinstance(e, Literal):
        if isinstance(e.value, (bool, int)):
            return ("int", abs(int(e.value)))
        return ("float", None)
    if isinstance(e, Identifier):
        cm = segment.metadata.column(e.name)
        if cm.data_type.is_integral:
            if cm.min_value is None or cm.max_value is None:
                return ("int", None)
            return ("int", max(abs(int(cm.min_value)),
                               abs(int(cm.max_value))))
        return ("float", None)
    if isinstance(e, Function):
        rewritten = _device_transform_rewrite(e)
        if rewritten is not None:
            return _value_kind(rewritten, segment)
    if isinstance(e, Function) and e.name in _INT_OPS and len(e.args) == 2:
        kinds = [_value_kind(a, segment) for a in e.args]
        if all(k[0] == "int" for k in kinds):
            (_, la), (_, ra) = kinds
            if e.name == "mod":
                return ("int", ra)     # |a mod b| < |b| (floor semantics)
            if e.name == "floordiv":
                return ("int", la)     # |a // b| <= |a| for integral b
            if la is None or ra is None:
                return ("int", None)
            return ("int", la * ra if e.name == "times" else la + ra)
    return ("float", None)


def _acc_dtype(base: str, vexpr: Optional[Expr], segment: ImmutableSegment,
               fanout: int = 1) -> str:
    """``fanout`` bounds the values per doc (1 for single-value columns,
    the most values per row for an MV aggregation): sums and counts add up
    to ``capacity * fanout`` terms."""
    if vexpr is None:
        return "i32"
    if base == "count":
        return ("i32" if segment.padded_capacity * fanout <= _I32_MAX
                else "i64")
    kind, max_abs = _value_kind(vexpr, segment)
    if kind == "float":
        return "f32"
    if base in ("min", "max", "minmaxrange"):
        return "i32" if (max_abs is not None and max_abs <= _I32_MAX) else "i64"
    if (max_abs is not None
            and max_abs * segment.padded_capacity * fanout <= _I32_MAX):
        return "i32"
    return "i64"


# -- param accounting -------------------------------------------------------

# params consumed per compiled filter op
_FILTER_PARAMS = {
    "true": 0, "false": 0, "validdocs": 1, "isnull": 0, "isnotnull": 0,
    "eq": 1, "neq": 1, "range": 1, "lut": 1,
    "mv_eq": 1, "mv_neq": 1, "mv_range": 1, "mv_lut": 1,
    "veq": 1, "vneq": 1, "vrange": 2, "vin": 1, "vnotin": 1,
}
# params consumed per compiled value op ("fn" is structural; "colmv" takes
# none: the MV aggregations read the dense MV arrays)
_VALUE_PARAMS = {"lit": 1, "col": 0, "fn": 0}


def _count_value_params(vspec: Optional[Tuple]) -> int:
    if vspec is None or vspec[0] == "colmv":
        return 0
    n = _VALUE_PARAMS[vspec[0]]
    if vspec[0] == "fn":
        n += sum(_count_value_params(a) for a in vspec[2])
    return n


def _count_filter_params(node: Tuple) -> int:
    if node[0] in ("and", "or", "not"):
        return sum(_count_filter_params(c) for c in node[1])
    return _FILTER_PARAMS[node[0]]


def expected_param_count(spec: Tuple) -> int:
    filter_spec, agg_specs, group_specs, _num_groups, _cap = spec
    n = _count_filter_params(filter_spec)
    if group_specs:
        n += 2  # the strides + bases arrays, in that order
        for gspec in group_specs:
            if gspec[0] == "gexpr":
                n += _count_value_params(gspec[1])
    for aspec in agg_specs:
        if aspec[0] == "distinctcounthll":
            n += 2  # per-dictId (bucket, rank) register tables
        elif aspec[0] != "distinctcount":
            n += _count_value_params(aspec[2])
    return n


def narrow_plan_groups(plan: SegmentPlan,
                       ranges: List[Tuple[int, int]]) -> SegmentPlan:
    """Rebuild a group-by plan with each group column's key range narrowed
    to the observed dictId bounds ``ranges`` (inclusive). Exact: the bounds
    are min/max over the rows the filter matches. Only the strides/bases
    params change, so decode applies unchanged."""
    if not plan.group_cards or len(ranges) != len(plan.group_cards):
        raise ValueError("one observed range per group column is required")
    cards: List[int] = []
    bases: List[int] = []
    for (lo, hi), card, base in zip(ranges, plan.group_cards,
                                    plan.group_bases):
        lo = max(base, int(lo))
        hi = min(base + card - 1, int(hi))
        if lo > hi:
            lo = hi = base
        cards.append(hi - lo + 1)
        bases.append(lo)
    total = 1
    for c in cards:
        total *= c
    num_groups = _next_pow2(total)
    strides = _row_major_strides(cards)
    filter_spec, agg_specs, group_specs, _old, capacity = plan.spec
    n_filter = _count_filter_params(filter_spec)
    params = list(plan.params)
    params[n_filter] = strides
    params[n_filter + 1] = np.asarray(bases, dtype=np.int64)
    return SegmentPlan(
        spec=(filter_spec, agg_specs, group_specs, num_groups, capacity),
        params=params, columns=list(plan.columns),
        group_defs=list(plan.group_defs), group_cards=cards,
        group_strides=strides, num_groups=num_groups,
        agg_defs=plan.agg_defs, group_bases=bases,
        narrowed_from=plan.narrowed_from or plan.spec)


def _conjunctive_dict_ranges(filter_spec: Tuple, params: List[Any]
                             ) -> Dict[str, Tuple[int, int]]:
    """column -> inclusive dictId bounds implied for every doc the filter
    can match, from predicates along pure-AND paths from the root."""
    ranges: Dict[str, Tuple[int, int]] = {}

    def meet(col: str, lo: int, hi: int) -> None:
        cur = ranges.get(col)
        ranges[col] = ((max(cur[0], lo), min(cur[1], hi))
                       if cur else (lo, hi))

    def walk(node: Tuple, i: int, conj: bool) -> int:
        op = node[0]
        if op == "and":
            for c in node[1]:
                i = walk(c, i, conj)
            return i
        if op in ("or", "not"):
            for c in node[1]:
                i = walk(c, i, False)
            return i
        if conj:
            if op == "eq":
                did = int(params[i])
                meet(node[1], did, did)
            elif op == "range":
                iv = np.asarray(params[i])
                meet(node[1], int(iv[0]), int(iv[1]))
            elif op == "lut":
                idx = np.nonzero(np.asarray(params[i]))[0]
                if idx.size:
                    meet(node[1], int(idx[0]), int(idx[-1]))
                else:
                    meet(node[1], 1, 0)  # matches nothing
        return i + _FILTER_PARAMS[op]

    walk(filter_spec, 0, True)
    return ranges


def _value_bounds(e: Expr, segment: ImmutableSegment
                  ) -> Optional[Tuple[int, int]]:
    """(lo, hi) integer bounds of a device value expression by interval
    arithmetic over column stats, or None when unbounded or not integral."""
    if isinstance(e, Literal):
        if isinstance(e.value, bool) or not isinstance(e.value, int):
            return None
        return (e.value, e.value)
    if isinstance(e, Identifier):
        if e.name.startswith("$"):
            return None
        cm = segment.metadata.column(e.name)
        if (not cm.single_value or not cm.data_type.is_integral
                or cm.min_value is None or cm.max_value is None):
            return None
        return (int(cm.min_value), int(cm.max_value))
    if isinstance(e, Function):
        rewritten = _device_transform_rewrite(e)
        if rewritten is not None:
            return _value_bounds(rewritten, segment)
    if isinstance(e, Function) and e.name in _INT_OPS and len(e.args) == 2:
        a = _value_bounds(e.args[0], segment)
        b = _value_bounds(e.args[1], segment)
        if a is None or b is None:
            return None
        (alo, ahi), (blo, bhi) = a, b
        if e.name == "plus":
            return (alo + blo, ahi + bhi)
        if e.name == "minus":
            return (alo - bhi, ahi - blo)
        if e.name == "times":
            corners = (alo * blo, alo * bhi, ahi * blo, ahi * bhi)
            return (min(corners), max(corners))
        # mod / floordiv: a positive constant divisor only (floor semantics)
        if blo != bhi or blo <= 0:
            return None
        if e.name == "mod":
            return (0, blo - 1)
        return (alo // blo, ahi // blo)
    return None


def _group_strategy(e: Expr, segment: ImmutableSegment,
                    dict_ranges: Dict[str, Tuple[int, int]]
                    ) -> Tuple[str, Any, int, int]:
    """-> (strategy, payload, cardinality, base): ``gdict`` with the column
    name (key = dictId - the filter-narrowed base), ``graw`` with a raw
    integer column (key = value - its min), or ``gexpr`` with the
    expression (key = value - its lower bound)."""
    if isinstance(e, Identifier):
        if e.name.startswith("$"):
            raise PlanError("group-by on virtual column -> host path")
        cm = segment.metadata.column(e.name)
        if not cm.single_value:
            raise PlanError("group-by on MV column -> host path")
        if cm.has_dictionary:
            lo, hi = dict_ranges.get(e.name, (0, cm.cardinality - 1))
            lo = max(0, lo)
            hi = min(cm.cardinality - 1, hi)
            if lo > hi:
                lo, hi = 0, 0  # unsatisfiable conjunction: a 1-slot space
            return "gdict", e.name, hi - lo + 1, lo
        if cm.data_type.is_integral:
            lo, hi = int(cm.min_value), int(cm.max_value)
            span = hi - lo + 1
            if span > MAX_DEVICE_GROUPS:
                raise PlanError("raw int group-by span too large")
            return "graw", e.name, span, lo
        raise PlanError("group-by on raw float column -> host path")
    bounds = _value_bounds(e, segment)
    if bounds is None:
        raise PlanError(f"group-by expression {e} -> host path")
    lo, hi = bounds
    span = hi - lo + 1
    if span <= 0 or span > MAX_DEVICE_GROUPS:
        raise PlanError("group-by expression span too large -> host path")
    return "gexpr", e, span, lo


# -- filter compilation -----------------------------------------------------

def _compile_filter(node: Optional[FilterNode], segment: ImmutableSegment,
                    params: List[Any], columns: List[str]) -> Tuple:
    if node is None:
        return ("true",)
    if node.op is FilterOp.AND:
        return ("and", tuple(_compile_filter(c, segment, params, columns)
                             for c in node.children))
    if node.op is FilterOp.OR:
        return ("or", tuple(_compile_filter(c, segment, params, columns)
                            for c in node.children))
    if node.op is FilterOp.NOT:
        return ("not", (_compile_filter(node.children[0], segment, params,
                                        columns),))
    return _compile_predicate(node.predicate, segment, params, columns)


def _conv(ds: DataSource, v: Any) -> Any:
    try:
        return ds.metadata.data_type.convert(v)
    except (ValueError, TypeError) as e:
        raise QueryError(f"cannot convert {v!r} for column {ds.name!r}: {e}")


def _compile_predicate(pred: Predicate, segment: ImmutableSegment,
                       params: List[Any], columns: List[str]) -> Tuple:
    t = pred.type
    if t in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
        cols = pred.lhs.columns()
        if not cols:
            raise QueryError(f"predicate references no column: {pred}")
        col = cols[0]
        if not segment.metadata.column(col).has_nulls:
            return ("false",) if t is PredicateType.IS_NULL else ("true",)
        if col not in columns:
            columns.append(col)
        return ("isnull" if t is PredicateType.IS_NULL else "isnotnull", col)

    if not isinstance(pred.lhs, Identifier):
        raise PlanError(f"expression predicate {pred.lhs} -> host path")
    col = pred.lhs.name
    if col.startswith("$"):
        raise PlanError("virtual column predicate -> host path")
    ds = segment.data_source(col)
    cm = ds.metadata
    if col not in columns:
        columns.append(col)
    mvp = "" if cm.single_value else "mv_"

    if cm.has_dictionary:
        d = ds.dictionary
        # an exclusive predicate on an MV column needs every value to pass:
        # the NOT of the inclusive form (ANY value matches)
        if not cm.single_value and t in (PredicateType.NOT_EQ,
                                         PredicateType.NOT_IN):
            inner_t = (PredicateType.EQ if t is PredicateType.NOT_EQ
                       else PredicateType.IN)
            return ("not", (_compile_predicate(replace(pred, type=inner_t),
                                               segment, params, columns),))
        if t in (PredicateType.EQ, PredicateType.NOT_EQ):
            params.append(np.int32(d.index_of(_conv(ds, pred.value))))
            return (mvp + ("eq" if t is PredicateType.EQ else "neq"), col)
        if t is PredicateType.RANGE:
            lo = _conv(ds, pred.lower) if pred.lower is not None else None
            hi = _conv(ds, pred.upper) if pred.upper is not None else None
            if is_arrival_ordered(d):
                # a consuming dictionary has no id interval: its matching
                # ids as a LUT, the IN op (JAX :843-851)
                lut = np.zeros(d.cardinality, dtype=bool)
                lut[d.matching_range_ids(lo, hi, pred.lower_inclusive,
                                         pred.upper_inclusive)] = True
                params.append(lut)
                return (mvp + "lut", col, d.cardinality)
            a, b = d.range_to_dict_id_interval(lo, hi, pred.lower_inclusive,
                                               pred.upper_inclusive)
            params.append(np.array([a, b], dtype=np.int32))
            return (mvp + "range", col)
        if t in (PredicateType.IN, PredicateType.NOT_IN,
                 PredicateType.REGEXP_LIKE, PredicateType.TEXT_MATCH,
                 PredicateType.JSON_MATCH):
            if t is PredicateType.JSON_MATCH and not cm.single_value:
                raise PlanError("JSON_MATCH on MV column is unsupported")
            params.append(_build_lut(ds, pred))
            return (mvp + "lut", col, d.cardinality)
        raise PlanError(f"predicate {t} -> host path")

    # raw column: compares against the values in their staged dtype
    if not cm.single_value:
        raise PlanError("raw MV column predicate -> host path")
    dt = raw_staged_dtype(cm)
    if t in (PredicateType.EQ, PredicateType.NOT_EQ):
        v = _conv(ds, pred.value)
        if cm.data_type.is_integral:
            info = np.iinfo(dt)
            if not (info.min <= int(v) <= info.max):
                # outside the staged dtype: no stored value can equal it
                return ("false",) if t is PredicateType.EQ else ("true",)
        params.append(np.asarray(v, dtype=dt))
        return ("veq" if t is PredicateType.EQ else "vneq", col)
    if t is PredicateType.RANGE:
        bounds = _raw_bounds(cm, ds, pred)
        if bounds is None:  # provably empty for the staged dtype
            return ("false",)
        lo, hi, lo_inc, hi_inc = bounds
        params.append(lo)
        params.append(hi)
        return ("vrange", col, lo_inc, hi_inc)
    if t in (PredicateType.IN, PredicateType.NOT_IN):
        conv = [_conv(ds, v) for v in pred.values]
        if cm.data_type.is_integral:
            info = np.iinfo(dt)
            conv = [v for v in conv if info.min <= int(v) <= info.max]
        vals = np.array(conv, dtype=dt)
        if vals.size == 0:
            return ("false",) if t is PredicateType.IN else ("true",)
        params.append(vals)
        return ("vin" if t is PredicateType.IN else "vnotin", col, len(vals))
    raise PlanError(f"predicate {t} on raw column -> host path")


def _raw_bounds(cm, ds: DataSource, pred: Predicate):
    """(lo, hi, lo_inclusive, hi_inclusive) in the staged dtype, or None if
    the range is provably empty. A literal outside the narrowed dtype's
    range makes its bound unrestrictive (an inclusive dtype extreme: every
    stored value fits the dtype) or the range empty."""
    dt = raw_staged_dtype(cm)
    lo_inc, hi_inc = pred.lower_inclusive, pred.upper_inclusive
    if cm.data_type.is_integral:
        info = np.iinfo(dt)
        if pred.lower is None:
            lo, lo_inc = info.min, True
        else:
            lv = int(_conv(ds, pred.lower))
            if lv > info.max:
                return None
            lo, lo_inc = (info.min, True) if lv < info.min else (lv, lo_inc)
        if pred.upper is None:
            hi, hi_inc = info.max, True
        else:
            uv = int(_conv(ds, pred.upper))
            if uv < info.min:
                return None
            hi, hi_inc = (info.max, True) if uv > info.max else (uv, hi_inc)
        return (np.asarray(lo, dtype=dt), np.asarray(hi, dtype=dt),
                lo_inc, hi_inc)
    lo = (np.float64(_conv(ds, pred.lower)) if pred.lower is not None
          else np.float64(float("-inf")))
    hi = (np.float64(_conv(ds, pred.upper)) if pred.upper is not None
          else np.float64(float("inf")))
    return lo, hi, lo_inc, hi_inc


def _build_lut(ds: DataSource, pred: Predicate) -> np.ndarray:
    """Boolean dictId lookup table: IN / NOT IN by value; REGEXP_LIKE and
    TEXT_MATCH through the column's FST or text index where it has one
    (JAX ``plan.py:965``, ``:997``), else, as JSON_MATCH, by evaluating the
    pattern once per distinct value. Both give the same dictIds."""
    d = ds.dictionary
    card = d.cardinality
    t = pred.type
    lut = np.zeros(card, dtype=bool)
    if t in (PredicateType.IN, PredicateType.NOT_IN):
        for v in pred.values:
            i = d.index_of(_conv(ds, v))
            if i >= 0:
                lut[i] = True
        return ~lut if t is PredicateType.NOT_IN else lut
    if t is PredicateType.REGEXP_LIKE:
        try:
            rx = re.compile(str(pred.value))
        except re.error as e:
            raise QueryError(f"bad regex {pred.value!r}: {e}")
        reader = getattr(ds, "fst_index", None)
        if reader is not None:
            # the trie narrows to the literal prefix's dictIds first
            lut[reader.matching_ids(str(pred.value))] = True
            return lut
        for i in range(card):
            lut[i] = rx.search(str(d.get_value(i))) is not None
        return lut
    if t is PredicateType.JSON_MATCH:
        try:
            ast = parse_match_filter(str(pred.value))
        except ValueError as e:
            raise QueryError(f"bad JSON_MATCH filter: {e}")
        for i in range(card):
            lut[i] = match_json_value(d.get_value(i), ast)
        return lut
    try:
        reader = getattr(ds, "text_index", None)
        if reader is not None:
            lut[reader.matching_ids(str(pred.value))] = True
            return lut
        ast = parse_text_query(str(pred.value))
    except ValueError as e:
        raise QueryError(f"bad TEXT_MATCH query: {e}")
    for i in range(card):
        lut[i] = match_text_value(d.get_value(i), ast)
    return lut


def _compile_value(e: Expr, segment: ImmutableSegment, params: List[Any],
                   columns: List[str]) -> Tuple:
    if isinstance(e, Literal):
        if not isinstance(e.value, (int, float, bool)):
            raise PlanError(f"non-numeric literal {e} in value expression")
        params.append(np.float64(e.value))
        return ("lit",)
    if isinstance(e, Identifier):
        if e.name.startswith("$"):
            raise PlanError("virtual column in value expression -> host")
        cm = segment.metadata.column(e.name)
        if not cm.single_value:
            raise PlanError(f"MV column {e.name} in value expression")
        if not cm.data_type.is_numeric:
            raise PlanError(f"non-numeric column {e.name} in value expression")
        if e.name not in columns:
            columns.append(e.name)
        return ("col", e.name, cm.has_dictionary)
    if isinstance(e, Function):
        if e.name not in _ARITH_OPS:
            rewritten = _device_transform_rewrite(e)
            if rewritten is None:
                raise PlanError(f"transform {e.name} -> host path")
            return _compile_value(rewritten, segment, params, columns)
        args = tuple(_compile_value(a, segment, params, columns)
                     for a in e.args)
        return ("fn", e.name, args)
    raise PlanError(f"cannot compile value expression {e}")


# --------------------------------------------------------------------------
# the star-tree node plan (JAX plan.py:150-280): a kernel spec over the
# gathered records of one tree
# --------------------------------------------------------------------------

def startree_dim_key(col: str) -> str:
    """The staged node column of a split dimension's dictIds
    (``StagedSegment.startree_nodes``), never a forward index."""
    return f"stdim:{col}"


def startree_metric_key(fn: str, col: str) -> str:
    """The staged node column of a function-column pair."""
    return f"stmetric:{fn}__{col}"


@dataclass
class StarTreePlan:
    """A general-rung spec over a tree's gathered records: the filter is
    ``("true",)`` (the walk selected the records), the capacity the
    selected count's power-of-two pad. ``agg_map`` says how the rewritten
    leaves make the query's aggregations again: (base, leaf indices),
    COUNT the sum of the count column, AVG a sum and a count leaf."""

    spec: Tuple
    params: List[np.ndarray]
    columns: List[str]            # staged node columns the spec reads
    group_cols: List[str]         # the dimensions' names (key decode)
    group_cards: List[int]
    group_bases: List[int]
    group_strides: Optional[np.ndarray]
    num_groups: int
    agg_map: List[Tuple[str, List[int]]]
    # device -> params uploaded there (engine/kernels.py device_params)
    device_params: Dict[Any, Tuple] = field(default_factory=dict,
                                            repr=False, compare=False)


def plan_star_tree(ctx: QueryContext, segment: ImmutableSegment, tree,
                   matches: Dict[str, Any],
                   num_selected: int) -> StarTreePlan:
    """The node plan of a query the pick fitted to ``tree``; ``matches``
    are its resolved dictId matches per dimension. A predicated group
    dimension's key range narrows to its match bounds. Raises PlanError
    past ``MAX_DEVICE_GROUPS`` composed keys (the host walker serves)."""
    from pinot_tpu_torch.engine.startree_exec import _pairs_needed
    from pinot_tpu_torch.segment.startree import match_bounds

    aggs = [resolve_agg(f) for f in ctx.aggregations]
    params: List[np.ndarray] = []
    columns: List[str] = []
    group_cols: List[str] = []
    group_specs: List[Tuple] = []
    group_cards: List[int] = []
    group_bases: List[int] = []
    num_groups = 0
    strides = None
    if ctx.group_by:
        for e in ctx.group_by:
            col = e.name      # the pick admits identifiers on tree dims
            lo, hi = 0, segment.metadata.column(col).cardinality - 1
            if col in matches:
                mlo, mhi = match_bounds(matches[col])
                lo, hi = max(lo, mlo), min(hi, mhi)
                if lo > hi:
                    lo, hi = 0, 0   # unsatisfiable: one key
            group_cols.append(col)
            group_cards.append(hi - lo + 1)
            group_bases.append(lo)
            key = startree_dim_key(col)
            group_specs.append(("gdict", key))
            if key not in columns:
                columns.append(key)
        total = 1
        for c in group_cards:
            total *= c
            if total > MAX_DEVICE_GROUPS:
                raise PlanError("star-tree group key space too large "
                                "-> host walker")
        num_groups = _next_pow2(total)
        strides = _row_major_strides(group_cards)
        params.append(strides)
        params.append(np.asarray(group_bases, dtype=np.int64))

    agg_specs: List[Tuple] = []
    agg_map: List[Tuple[str, List[int]]] = []

    def leaf(fn: str, col: str) -> int:
        key = startree_metric_key(fn, col)
        acc = "i64" if fn == "count" else "f64"
        op = "sum" if fn in ("count", "sum") else fn
        agg_specs.append((op, False, ("col", key, False), acc))
        if key not in columns:
            columns.append(key)
        return len(agg_specs) - 1

    for agg, fn in zip(aggs, ctx.aggregations):
        pairs = _pairs_needed(agg, fn)
        if pairs is None:   # the pick admitted it
            raise PlanError(f"aggregation {agg.name} has no pre-agg pairs")
        if agg.base == "avg":
            (sfn, scol), (cfn, ccol) = pairs
            agg_map.append(("avg", [leaf(sfn, scol), leaf(cfn, ccol)]))
        else:
            (pfn, pcol), = pairs
            agg_map.append((agg.base, [leaf(pfn, pcol)]))

    capacity = max(128, _next_pow2(max(1, num_selected)))
    spec = (("true",), tuple(agg_specs), tuple(group_specs), num_groups,
            capacity)
    expected = expected_param_count(spec)
    if len(params) != expected:
        raise AssertionError(
            f"star-tree param pack/unpack drift: packed {len(params)} but "
            f"the spec consumes {expected} (spec={spec[:3]!r})")
    return StarTreePlan(spec=spec, params=params, columns=columns,
                        group_cols=group_cols, group_cards=group_cards,
                        group_bases=group_bases, group_strides=strides,
                        num_groups=num_groups, agg_map=agg_map)
