"""Server-side segment pruning: skip segments a filter provably excludes.

Counterpart of ``pinot_tpu/engine/pruner.py`` (``prune_segments``): before
planning and staging, each segment's column metadata is tested against the
query's filter tree: min/max bounds for EQ/RANGE/IN, partition
membership and the column's bloom filter (where it was built with one)
for EQ/IN. A segment prunes only when the filter is provably empty on it:
AND prunes if any conjunct proves empty, OR only if every branch does,
NOT and other predicates keep it.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    FilterNode,
    FilterOp,
    Identifier,
    Predicate,
    PredicateType,
)
from pinot_tpu_torch.spi.data import DataType
from pinot_tpu_torch.utils.partition import get_partition_function


def prune_segments(ctx: QueryContext, segments: List, stats=None) -> List:
    """The segments the query may still match; the others are counted in
    ``stats.num_segments_pruned``."""
    if ctx.filter is None:
        return segments
    kept = [s for s in segments if _may_match(ctx.filter, s)]
    if stats is not None:
        stats.num_segments_pruned += len(segments) - len(kept)
    return kept


def _may_match(node: FilterNode, seg) -> bool:
    if node.op is FilterOp.AND:
        return all(_may_match(c, seg) for c in node.children)
    if node.op is FilterOp.OR:
        return any(_may_match(c, seg) for c in node.children)
    if node.op is FilterOp.NOT:
        return True  # negations are not provable from min/max
    return _predicate_may_match(node.predicate, seg)


def _predicate_may_match(pred: Predicate, seg) -> bool:
    if not isinstance(pred.lhs, Identifier):
        return True
    cm = seg.metadata.columns.get(pred.lhs.name)
    if cm is None or not cm.single_value:
        return True
    t = pred.type

    def conv(v) -> Optional[Any]:
        try:
            v = cm.data_type.convert(v)
        except (TypeError, ValueError):
            return None
        if cm.data_type is DataType.FLOAT:
            # stored values are float32: compare at their precision
            v = float(np.float32(v))
        return v

    if t is PredicateType.EQ:
        v = conv(pred.value)
        return v is None or _value_may_match(seg, cm, v)
    if t is PredicateType.IN:
        vals = [v for v in (conv(x) for x in pred.values) if v is not None]
        return not vals or any(_value_may_match(seg, cm, v) for v in vals)
    if t is PredicateType.RANGE:
        return _range_overlaps(cm, pred, conv)
    return True


def _value_may_match(seg, cm, v) -> bool:
    return (_within_bounds(cm, v) and _partition_may_contain(cm, v)
            and _bloom_may_contain(seg, cm, v))


def _within_bounds(cm, v) -> bool:
    if cm.min_value is None or cm.max_value is None or cm.has_nulls:
        return True
    try:
        return cm.min_value <= v <= cm.max_value
    except TypeError:
        return True


def _partition_may_contain(cm, v) -> bool:
    if not cm.partition_function or not cm.partitions:
        return True
    fn = get_partition_function(cm.partition_function, cm.num_partitions)
    return fn.partition(v) in cm.partitions


def _bloom_may_contain(seg, cm, v) -> bool:
    """``v`` went through the stored precision (``conv``); the filter hashed
    the f64 widening of the stored values."""
    if not cm.has_bloom_filter:
        return True
    bf = seg.data_source(cm.name).bloom_filter
    return bf is None or bf.might_contain(v)


def _range_overlaps(cm, pred: Predicate, conv) -> bool:
    if cm.min_value is None or cm.max_value is None or cm.has_nulls:
        return True
    lo = conv(pred.lower) if pred.lower is not None else None
    hi = conv(pred.upper) if pred.upper is not None else None
    try:
        if lo is not None and (cm.max_value < lo if pred.lower_inclusive
                               else cm.max_value <= lo):
            return False
        if hi is not None and (cm.min_value > hi if pred.upper_inclusive
                               else cm.min_value >= hi):
            return False
    except TypeError:
        return True
    return True
