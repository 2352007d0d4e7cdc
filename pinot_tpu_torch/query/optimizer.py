"""Filter rewrites before planning.

Counterpart of ``pinot_tpu/query/optimizer.py``: fold constants, flatten
nested AND/OR, rewrite LIKE to an anchored REGEXP_LIKE, merge EQ/IN
children of an OR into one IN, merge ranges on the same expression under
an AND. The planner's filter spec depends on the rewritten tree, so the
rules and their order follow the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import List, Optional

from pinot_tpu_torch.query.expressions import (
    FilterNode,
    FilterOp,
    Predicate,
    PredicateType,
    fold_constants,
)


def like_to_regex(pattern: str) -> str:
    """SQL LIKE pattern -> anchored regex: ``%`` -> ``.*``, ``_`` -> ``.``,
    everything else escaped."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _flatten(node: FilterNode) -> FilterNode:
    if node.op in (FilterOp.AND, FilterOp.OR):
        children: List[FilterNode] = []
        for c in node.children:
            c = _flatten(c)
            if c.op is node.op:
                children.extend(c.children)
            else:
                children.append(c)
        if len(children) == 1:
            return children[0]
        return FilterNode(node.op, children=children)
    if node.op is FilterOp.NOT:
        return FilterNode.not_(_flatten(node.children[0]))
    return node


def _rewrite_like(node: FilterNode) -> FilterNode:
    if node.predicate is not None:
        p = node.predicate
        if p.type is PredicateType.LIKE:
            return FilterNode.pred(replace(
                p, type=PredicateType.REGEXP_LIKE,
                values=(like_to_regex(str(p.value)),)))
        return node
    return FilterNode(node.op,
                      children=tuple(_rewrite_like(c) for c in node.children))


def _merge_eq_in(node: FilterNode) -> FilterNode:
    """OR(EQ(c,a), EQ(c,b), ...) -> IN(c, a, b, ...)."""
    if node.op is FilterOp.OR:
        by_col = {}
        rest: List[FilterNode] = []
        for c in node.children:
            c = _merge_eq_in(c)
            p = c.predicate
            if p is not None and p.type in (PredicateType.EQ, PredicateType.IN):
                by_col.setdefault(p.lhs, []).extend(p.values)
            else:
                rest.append(c)
        merged: List[FilterNode] = []
        for lhs, values in by_col.items():
            uniq = tuple(dict.fromkeys(values))
            ptype = PredicateType.EQ if len(uniq) == 1 else PredicateType.IN
            merged.append(FilterNode.pred(Predicate(ptype, lhs, values=uniq)))
        children = merged + rest
        if len(children) == 1:
            return children[0]
        return FilterNode.or_(children)
    if node.op in (FilterOp.AND, FilterOp.NOT):
        return FilterNode(node.op,
                          children=tuple(_merge_eq_in(c) for c in node.children))
    return node


def _merge_ranges(node: FilterNode) -> FilterNode:
    """AND of ranges on the same expression -> one range."""
    if node.op is FilterOp.AND:
        by_col = {}
        rest: List[FilterNode] = []
        for c in node.children:
            c = _merge_ranges(c)
            p = c.predicate
            if p is not None and p.type is PredicateType.RANGE:
                by_col.setdefault(p.lhs, []).append(p)
            else:
                rest.append(c)
        merged: List[FilterNode] = []
        for lhs, preds in by_col.items():
            if len(preds) == 1:
                merged.append(FilterNode.pred(preds[0]))
                continue
            try:
                lo, lo_inc = None, False
                hi, hi_inc = None, False
                for p in preds:
                    if p.lower is not None and (
                            lo is None or p.lower > lo
                            or (p.lower == lo and not p.lower_inclusive)):
                        lo, lo_inc = p.lower, p.lower_inclusive
                    if p.upper is not None and (
                            hi is None or p.upper < hi
                            or (p.upper == hi and not p.upper_inclusive)):
                        hi, hi_inc = p.upper, p.upper_inclusive
                merged.append(FilterNode.pred(Predicate(
                    PredicateType.RANGE, lhs, lower=lo, upper=hi,
                    lower_inclusive=lo_inc, upper_inclusive=hi_inc)))
            except TypeError:
                # mixed-type bounds are not mergeable; each predicate then
                # reports its own conversion error
                merged.extend(FilterNode.pred(p) for p in preds)
        children = merged + rest
        if len(children) == 1:
            return children[0]
        return FilterNode.and_(children)
    if node.op in (FilterOp.OR, FilterOp.NOT):
        return FilterNode(node.op,
                          children=tuple(_merge_ranges(c) for c in node.children))
    return node


def _fold_filter(node: FilterNode) -> FilterNode:
    if node.predicate is not None:
        p = node.predicate
        folded = fold_constants(p.lhs)
        if folded is not p.lhs:
            return FilterNode.pred(replace(p, lhs=folded))
        return node
    return FilterNode(node.op,
                      children=tuple(_fold_filter(c) for c in node.children))


def optimize_filter(node: Optional[FilterNode]) -> Optional[FilterNode]:
    if node is None:
        return None
    node = _fold_filter(node)
    node = _flatten(node)
    node = _rewrite_like(node)
    node = _merge_eq_in(node)
    node = _merge_ranges(node)
    return _flatten(node)
