"""Star-tree fit, tree pick, predicate matches and the host walker.

Counterpart of ``pinot_tpu/engine/startree_exec.py`` (:37-409):

- ``pick_star_tree`` fits a query to a segment's trees: an aggregation
  with an AND-ed filter of EQ / IN / NOT_EQ / NOT_IN / RANGE predicates on
  split dimensions, identifier group keys on split dimensions, and
  COUNT / SUM / MIN / MAX / AVG whose function-column pairs the tree
  stores (a ``+ - *`` expression as its derived pair). Of the trees that
  fit, the cheapest by estimated records read serves, the lower index on a
  tie; where none fits, the most specific reason across trees is the
  decline (``_REASON_RANK``).
- ``resolve_matches`` turns the predicates into dictId matches per
  dimension: a set, a ``DictIdRange`` for a contiguous run past
  ``_MAX_RANGE_IDS``, or a decline.
- ``execute_with_matches`` is the host walker: the selected records'
  pre-aggregated columns summed with numpy. The device rung
  (``engine/startree_device.py``) serves first; the walker serves where
  the node plan raises ``PlanError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from pinot_tpu_torch.engine.aggregates import AggDef, agg_value_expr
from pinot_tpu_torch.engine.groupkeys import compose_group_keys
from pinot_tpu_torch.engine.host_eval import _matching_dict_ids
from pinot_tpu_torch.engine.index_exec import _flatten_and
from pinot_tpu_torch.engine.results import AggResult, GroupByResult, QueryStats
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    Function,
    Identifier,
    Predicate,
    PredicateType,
    canonical_arith_key,
)
from pinot_tpu_torch.segment.startree import DictIdRange, StarTree

# the most dictIds a match is materialised as a set; a contiguous run past
# it is a DictIdRange, a non-contiguous one declines to the scan rungs
_MAX_RANGE_IDS = 100_000


def _agg_pair(agg: AggDef, fn: Function) -> Optional[Tuple[str, str]]:
    """The (function, column) pair a tree stores for this aggregation;
    the column may be a derived pair's canonical key (``(a*b)``)."""
    if agg.mv:
        return None
    vexpr = agg_value_expr(fn)
    if agg.base == "count" and vexpr is None:
        return ("count", "*")
    if agg.base in ("sum", "min", "max") and vexpr is not None:
        key = canonical_arith_key(vexpr)
        if key is not None:
            return (agg.base, key)
    return None


def _pairs_needed(agg: AggDef, fn: Function
                  ) -> Optional[List[Tuple[str, str]]]:
    """The pairs a tree must store to answer this aggregation (AVG is a
    SUM and a COUNT)."""
    p = _agg_pair(agg, fn)
    if p is not None:
        return [p]
    vexpr = agg_value_expr(fn)
    if agg.base == "avg" and not agg.mv and vexpr is not None:
        key = canonical_arith_key(vexpr)
        if key is not None:
            return [("sum", key), ("count", "*")]
    return None


def _pair_column(fn: Function) -> str:
    """An aggregation's stored pair column: ``*`` for COUNT(*), a column,
    or a derived pair's key."""
    vexpr = agg_value_expr(fn)
    if vexpr is None:
        return "*"
    key = canonical_arith_key(vexpr)
    return key if key is not None else "*"


class StarTreePick(NamedTuple):
    """The chosen tree, its index in ``segment.star_trees`` (recorded in
    the decision and ``QueryStats.startree_tree_index``) and the AND-ed
    predicates."""

    tree: StarTree
    index: int
    preds: List[Predicate]


# how far a tree got through the fit checks before it failed: with several
# trees the most specific reason is the one recorded
_REASON_RANK = {
    "startree_group_off_split_order": 0,
    "startree_filter_non_dimension": 1,
    "startree_predicate_type_unsupported": 2,
    "startree_agg_not_pairable": 3,
    "startree_expression_agg_no_pair": 4,
    "startree_missing_function_pair": 5,
}


def _pred_match_estimate(segment, pred: Predicate, card: int) -> int:
    """The dictIds a predicate matches, estimated at plan time without
    materialising them."""
    t = pred.type
    if t is PredicateType.EQ:
        return 1
    if t is PredicateType.IN:
        return min(card, len(pred.values))
    if t is PredicateType.NOT_EQ:
        return max(1, card - 1)
    if t is PredicateType.NOT_IN:
        return max(1, card - len(pred.values))
    if t is PredicateType.RANGE:
        try:
            d = segment.data_source(pred.lhs.name).dictionary
            if d is not None:
                a, b = d.range_to_dict_id_interval(
                    pred.lower, pred.upper, pred.lower_inclusive,
                    pred.upper_inclusive)
                return max(0, int(b) - int(a) + 1)
        except (ValueError, TypeError, KeyError):
            pass
        return max(1, card // 3)
    return card


def _estimate_records(tree: StarTree, preds: List[Predicate],
                      group_cols: List[str], segment) -> float:
    """Records a fitting tree reads, estimated along its split order: a
    predicated dimension narrows to its match estimate, a grouped one (or
    one without star nodes) fans out to its cardinality, a free one takes
    the star child; at most the tree's record count."""
    by_col: Dict[str, int] = {}
    for p in preds:
        col = p.lhs.name
        card = segment.metadata.column(col).cardinality
        est = _pred_match_estimate(segment, p, card)
        by_col[col] = min(by_col.get(col, card), est)
    grouped = set(group_cols)
    est = 1.0
    for d in tree.config.dimensions_split_order:
        if d in by_col:
            est *= max(1, by_col[d])
        elif d in grouped or d in tree.config.skip_star_creation:
            est *= max(1, segment.metadata.column(d).cardinality)
    return min(est, float(tree.num_records))


def pick_star_tree(ctx: QueryContext, aggs: List[AggDef], segment,
                   on_decline=None) -> Optional[StarTreePick]:
    """The cheapest tree of the segment that fits the query (the lower
    index on a tie), or None. ``on_decline`` receives the reason code when
    the segment has trees and none fits; a segment without trees, or a
    query that is no aggregation, is not a decline."""

    def decline(reason: str):
        if on_decline is not None:
            on_decline(reason)
        return None

    trees = getattr(segment, "star_trees", None)
    if not trees or not ctx.aggregations:
        return None     # no trees, or no aggregation: not a decline
    if getattr(segment, "valid_doc_ids", None) is not None:
        # pre-aggregated records do not see the valid-doc bitmap
        return decline("startree_upsert_valid_docs")
    preds = _flatten_and(ctx.filter)
    if preds is None:
        return decline("startree_filter_or_not_shape")
    group_cols: List[str] = []
    for e in ctx.group_by:
        if not isinstance(e, Identifier):
            return decline("startree_group_expression")
        group_cols.append(e.name)

    # the pairs are the query's, the same for every tree
    needed: List[Tuple[str, str]] = []
    for agg, fn in zip(aggs, ctx.aggregations):
        ps = _pairs_needed(agg, fn)
        if ps is None:
            return decline("startree_expression_agg_no_pair"
                           if isinstance(agg_value_expr(fn), Function)
                           else "startree_agg_not_pairable")
        needed.extend(ps)

    reason: Optional[str] = None

    def note(r: str) -> None:
        nonlocal reason
        if reason is None or (_REASON_RANK.get(r, 0)
                              > _REASON_RANK.get(reason, 0)):
            reason = r

    fitting: List[Tuple[float, int, StarTree]] = []
    for ti, tree in enumerate(trees):
        dims = set(tree.config.dimensions_split_order)
        if any(c not in dims for c in group_cols):
            note("startree_group_off_split_order")
            continue
        ok = True
        for p in preds:
            if not isinstance(p.lhs, Identifier) or p.lhs.name not in dims:
                note("startree_filter_non_dimension")
                ok = False
                break
            if p.type not in (PredicateType.EQ, PredicateType.IN,
                              PredicateType.NOT_EQ, PredicateType.NOT_IN,
                              PredicateType.RANGE):
                note("startree_predicate_type_unsupported")
                ok = False
                break
        if not ok:
            continue
        missing = [c for f, c in needed if not tree.has_pair(f, c)]
        if missing:
            note("startree_expression_agg_no_pair"
                 if any(c.startswith("(") for c in missing)
                 else "startree_missing_function_pair")
            continue
        fitting.append((_estimate_records(tree, preds, group_cols, segment),
                        ti, tree))
    if not fitting:
        return decline(reason or "startree_no_fitting_tree")
    _est, ti, tree = min(fitting, key=lambda t: (t[0], t[1]))
    return StarTreePick(tree, ti, preds)


def _matching_ids(segment, pred: Predicate):
    """A predicate's dictId match: a set, a DictIdRange for a contiguous
    run past ``_MAX_RANGE_IDS``, or a decline code (a string)."""
    ds = segment.data_source(pred.lhs.name)
    if ds.dictionary is None:
        return "startree_raw_dimension"
    ids = _matching_dict_ids(ds, pred)
    if len(ids) > _MAX_RANGE_IDS:
        if int(ids[-1]) - int(ids[0]) + 1 == len(ids):
            return DictIdRange(int(ids[0]), int(ids[-1]))
        return "startree_dictid_overflow_noncontiguous"
    return set(int(i) for i in ids)


def _intersect(a, b):
    """The meet of two matches (set | DictIdRange)."""
    if isinstance(a, DictIdRange) and isinstance(b, DictIdRange):
        return DictIdRange(max(a.lo, b.lo), min(a.hi, b.hi))
    if isinstance(a, DictIdRange):
        return {v for v in b if v in a}
    if isinstance(b, DictIdRange):
        return {v for v in a if v in b}
    return a & b


def resolve_matches(segment, preds: List[Predicate], on_decline=None
                    ) -> Optional[Dict[str, Any]]:
    """AND-ed predicates -> a match per dimension, or None where one does
    not translate (``on_decline`` receives the code; the scan rungs
    serve). Shared by the walker and the device rung."""
    matches: Dict[str, Any] = {}
    for p in preds:
        ids = _matching_ids(segment, p)
        if isinstance(ids, str):
            if on_decline is not None:
                on_decline(ids)
            return None
        col = p.lhs.name
        matches[col] = ids if col not in matches \
            else _intersect(matches[col], ids)
    return matches


def execute_with_matches(ctx: QueryContext, aggs: List[AggDef], segment,
                         tree: StarTree, matches: Dict[str, Any],
                         stats: Optional[QueryStats] = None):
    """The host walker: the walk, then numpy over the selected records
    -> AggResult or GroupByResult. ``num_docs_scanned`` counts records."""
    group_cols = [e.name for e in ctx.group_by]
    idx = tree.select_records(matches, group_cols)
    if stats is not None:
        stats.num_segments_processed += 1
        stats.total_docs += segment.num_docs
        stats.num_docs_scanned += int(idx.shape[0])
        stats.num_segments_matched += 1 if idx.shape[0] else 0
    if not ctx.is_group_by:
        return AggResult([_scalar_state(tree, agg, fn, idx)
                          for agg, fn in zip(aggs, ctx.aggregations)])
    gb = GroupByResult()
    if idx.shape[0] == 0:
        return gb
    dim_pos = {d: i for i, d in enumerate(tree.config.dimensions_split_order)}
    key_ids = [np.asarray(tree.dims[idx, dim_pos[c]]) for c in group_cols]
    cards = [int(k.max()) + 1 if k.size else 1 for k in key_ids]
    uniq, gid, decode_codes = compose_group_keys(key_ids, cards)
    keys = [tuple(segment.data_source(c).dictionary.get_value(int(i))
                  for c, i in zip(group_cols, decode_codes(int(u))))
            for u in uniq]
    n = len(uniq)
    states_per_agg = [_grouped_states(tree, agg, fn, idx, gid, n)
                      for agg, fn in zip(aggs, ctx.aggregations)]
    for g, key in enumerate(keys):
        gb.groups[key] = [states_per_agg[a][g] for a in range(len(aggs))]
    return gb


def _metric(tree: StarTree, fn: str, col: str, idx: np.ndarray) -> np.ndarray:
    return np.asarray(tree.metrics[f"{fn}__{col}"][idx])


def _scalar_state(tree: StarTree, agg: AggDef, fn: Function,
                  idx: np.ndarray) -> Any:
    col = _pair_column(fn)
    if agg.base == "count":
        return int(_metric(tree, "count", "*", idx).sum())
    if idx.shape[0] == 0:
        return {"sum": 0.0, "min": float("inf"), "max": float("-inf"),
                "avg": (0.0, 0)}[agg.base]
    if agg.base == "sum":
        return float(_metric(tree, "sum", col, idx).sum())
    if agg.base == "min":
        return float(_metric(tree, "min", col, idx).min())
    if agg.base == "max":
        return float(_metric(tree, "max", col, idx).max())
    if agg.base == "avg":
        return (float(_metric(tree, "sum", col, idx).sum()),
                int(_metric(tree, "count", "*", idx).sum()))
    raise AssertionError(agg.base)


def _grouped_states(tree: StarTree, agg: AggDef, fn: Function,
                    idx: np.ndarray, gid: np.ndarray, n: int) -> List[Any]:
    col = _pair_column(fn)
    if agg.base == "count":
        out = np.zeros(n, dtype=np.int64)
        np.add.at(out, gid, _metric(tree, "count", "*", idx))
        return [int(v) for v in out]
    if agg.base == "sum":
        out = np.zeros(n)
        np.add.at(out, gid, _metric(tree, "sum", col, idx))
        return [float(v) for v in out]
    if agg.base == "min":
        out = np.full(n, np.inf)
        np.minimum.at(out, gid, _metric(tree, "min", col, idx))
        return [float(v) for v in out]
    if agg.base == "max":
        out = np.full(n, -np.inf)
        np.maximum.at(out, gid, _metric(tree, "max", col, idx))
        return [float(v) for v in out]
    if agg.base == "avg":
        s = np.zeros(n)
        c = np.zeros(n, dtype=np.int64)
        np.add.at(s, gid, _metric(tree, "sum", col, idx))
        np.add.at(c, gid, _metric(tree, "count", "*", idx))
        return [(float(a), int(b)) for a, b in zip(s, c)]
    raise AssertionError(agg.base)
