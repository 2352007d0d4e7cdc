"""Per-segment plan: QueryContext + segment metadata -> spec + params.

Counterpart of ``pinot_tpu/engine/plan.py`` (``plan_segment``,
``narrow_plan_groups``), cut to dictionary-encoded single-value columns:
eq/neq/range/lut filters, ``gdict`` group keys and ``gexpr`` keys (bounded
integral ``+ - *`` expressions), and the device DISTINCTCOUNTHLL with its
per-dictId register tables. The spec (a hashable
structural description) and the params (the runtime values, in the order
the kernel side consumes them) equal the JAX package's for the same SQL and
segment, so the eligibility rules downstream read the same input.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.engine.aggregates import AggDef, agg_value_expr, resolve_agg
from pinot_tpu_torch.engine.errors import PlanError, QueryError
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
from pinot_tpu_torch.utils.hll import DEFAULT_LOG2M

# composed group key space past which the JAX package leaves the device
MAX_DEVICE_GROUPS = 1 << 21

_I32_MAX = int(np.iinfo(np.int32).max)

_ARITH_OPS = {"plus", "minus", "times"}


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


def plan_segment(ctx: QueryContext, segment: ImmutableSegment) -> SegmentPlan:
    params: List[Any] = []
    columns: List[str] = []

    filter_spec = _compile_filter(ctx.filter, segment, params, columns)
    dict_ranges = (_conjunctive_dict_ranges(filter_spec, params)
                   if ctx.group_by else {})
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
        if agg.base == "distinctcounthll":
            # per-dictId (bucket, rank) tables from the dictionary's hashes;
            # the register update is a masked scatter-max on the device
            if not isinstance(vexpr, Identifier) or vexpr.name.startswith("$"):
                raise PlanError("DISTINCTCOUNTHLL argument must be a column")
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
        if agg.base == "distinctcount":
            if not isinstance(vexpr, Identifier) or vexpr.name.startswith("$"):
                raise PlanError("DISTINCTCOUNT argument must be a column")
            cm = segment.metadata.column(vexpr.name)
            if cm.cardinality > (1 << 20):
                raise PlanError("DISTINCTCOUNT cardinality too large -> host")
            agg_specs.append(("distinctcount", vexpr.name, cm.cardinality))
            if vexpr.name not in columns:
                columns.append(vexpr.name)
            continue
        vspec = (None if vexpr is None
                 else _compile_value(vexpr, segment, params, columns))
        agg_specs.append((agg.base, agg.mv, vspec,
                          _acc_dtype(agg.base, vexpr, segment)))

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
    ('float', None); integer bounds propagate through + - *."""
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
    if isinstance(e, Function) and e.name in _ARITH_OPS and len(e.args) == 2:
        kinds = [_value_kind(a, segment) for a in e.args]
        if all(k[0] == "int" for k in kinds):
            (_, la), (_, ra) = kinds
            if la is None or ra is None:
                return ("int", None)
            return ("int", la * ra if e.name == "times" else la + ra)
    return ("float", None)


def _acc_dtype(base: str, vexpr: Optional[Expr], segment: ImmutableSegment,
               fanout: int = 1) -> str:
    """``fanout`` bounds the values per doc (1 for single-value columns, the
    only ones the port stages): sums and counts add up to
    ``capacity * fanout`` terms."""
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
_FILTER_PARAMS = {"true": 0, "false": 0, "eq": 1, "neq": 1, "range": 1,
                  "lut": 1}
# params consumed per compiled value op ("fn" is structural)
_VALUE_PARAMS = {"lit": 1, "col": 0, "fn": 0}


def _count_value_params(vspec: Optional[Tuple]) -> int:
    if vspec is None:
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
    if isinstance(e, Function) and e.name in _ARITH_OPS and len(e.args) == 2:
        a = _value_bounds(e.args[0], segment)
        b = _value_bounds(e.args[1], segment)
        if a is None or b is None:
            return None
        (alo, ahi), (blo, bhi) = a, b
        if e.name == "plus":
            return (alo + blo, ahi + bhi)
        if e.name == "minus":
            return (alo - bhi, ahi - blo)
        corners = (alo * blo, alo * bhi, ahi * blo, ahi * bhi)
        return (min(corners), max(corners))
    return None


def _group_strategy(e: Expr, segment: ImmutableSegment,
                    dict_ranges: Dict[str, Tuple[int, int]]
                    ) -> Tuple[str, Any, int, int]:
    """-> (strategy, payload, cardinality, base): ``gdict`` with the column
    name (key = dictId - the filter-narrowed base), or ``gexpr`` with the
    expression (key = value - its lower bound)."""
    if isinstance(e, Identifier):
        if e.name.startswith("$"):
            raise PlanError("group-by on virtual column -> host path")
        cm = segment.metadata.column(e.name)
        lo, hi = dict_ranges.get(e.name, (0, cm.cardinality - 1))
        lo = max(0, lo)
        hi = min(cm.cardinality - 1, hi)
        if lo > hi:
            lo, hi = 0, 0  # unsatisfiable conjunction: a 1-slot key space
        return "gdict", e.name, hi - lo + 1, lo
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
    if not isinstance(pred.lhs, Identifier):
        raise PlanError(f"expression predicate {pred.lhs} -> host path")
    col = pred.lhs.name
    if col.startswith("$"):
        raise PlanError("virtual column predicate -> host path")
    ds = segment.data_source(col)
    d = ds.dictionary
    if col not in columns:
        columns.append(col)
    t = pred.type
    if t in (PredicateType.EQ, PredicateType.NOT_EQ):
        params.append(np.int32(d.index_of(_conv(ds, pred.value))))
        return ("eq" if t is PredicateType.EQ else "neq", col)
    if t is PredicateType.RANGE:
        lo = _conv(ds, pred.lower) if pred.lower is not None else None
        hi = _conv(ds, pred.upper) if pred.upper is not None else None
        a, b = d.range_to_dict_id_interval(lo, hi, pred.lower_inclusive,
                                           pred.upper_inclusive)
        params.append(np.array([a, b], dtype=np.int32))
        return ("range", col)
    # IN / NOT IN: boolean dictId lookup table
    lut = np.zeros(d.cardinality, dtype=bool)
    for v in pred.values:
        i = d.index_of(_conv(ds, v))
        if i >= 0:
            lut[i] = True
    if t is PredicateType.NOT_IN:
        lut = ~lut
    params.append(lut)
    return ("lut", col, d.cardinality)


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
        if not cm.data_type.is_numeric:
            raise PlanError(f"non-numeric column {e.name} in value expression")
        if e.name not in columns:
            columns.append(e.name)
        return ("col", e.name, cm.has_dictionary)
    if isinstance(e, Function):
        if e.name not in _ARITH_OPS:
            raise PlanError(f"transform {e.name} -> host path")
        args = tuple(_compile_value(a, segment, params, columns)
                     for a in e.args)
        return ("fn", e.name, args)
    raise PlanError(f"cannot compile value expression {e}")
