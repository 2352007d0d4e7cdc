"""Config recommendation engine: workload -> indexing suggestions.

Counterpart of ``pinot_tpu/controller/recommender.py`` (a copy, host
only), behind ``POST /tables/{table}/recommender``.

Re-design of the reference's rule-based recommender
(``pinot-controller/.../recommender/`` — ~60 classes of rules run by
RecommenderDriver over a RuleEngine InputManager): a compact rule set over
a parsed query workload + schema. Each rule inspects predicate/group-by
frequencies extracted from the SQL (the InputManager's "FixedLenBitset"
per-column usage maps collapse to plain Counters here) and emits config
fragments with human-readable reasons.

Rules (reference analogues):
- inverted index   <- frequent EQ/IN/range dict-column filters
  (InvertedSortedIndexJointRule)
- sorted column    <- the single most filtered column
- bloom filter     <- selective EQ filters (BloomFilterRule)
- range index      <- RANGE predicates on raw numeric columns
  (RangeIndexRule)
- no-dictionary    <- metric columns never filtered/grouped
  (NoDictionaryOnHeapDictionaryJointRule)
- json/text index  <- JSON_MATCH / TEXT_MATCH usage
- partitioning     <- dominant single-column EQ workloads
  (KafkaPartitionRule / SegmentPartitionRule flavor)
- star-tree        <- recurring (group-by set, aggregation) shapes
  (AggregateMetricsRule + star-tree generation)
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.query.context import QueryContext, compile_query
from pinot_tpu_torch.query.expressions import (
    FilterNode,
    FilterOp,
    Identifier,
    PredicateType,
)
from pinot_tpu_torch.engine.aggregates import agg_value_expr
from pinot_tpu_torch.spi.data import FieldType, Schema

# workload-share thresholds (the reference tunes these per rule; one knob
# per rule keeps the engine inspectable)
INVERTED_MIN_SHARE = 0.2
BLOOM_MIN_SHARE = 0.3
PARTITION_MIN_SHARE = 0.5
STARTREE_MIN_SHARE = 0.3


def _walk_predicates(node: Optional[FilterNode]):
    if node is None:
        return
    if node.op in (FilterOp.AND, FilterOp.OR, FilterOp.NOT):
        for c in node.children:
            yield from _walk_predicates(c)
        return
    yield node.predicate


class WorkloadStats:
    """Per-column usage counters over the parsed workload
    (the InputManager analogue)."""

    def __init__(self):
        self.num_queries = 0
        self.eq_filters = Counter()      # EQ/IN
        self.range_filters = Counter()
        self.regex_filters = Counter()
        self.text_filters = Counter()
        self.json_filters = Counter()
        self.group_by_sets = Counter()   # frozenset of group columns
        self.group_by_cols = Counter()
        self.agg_pairs = Counter()       # (fn, column) on group-by queries
        self.selected = Counter()        # any reference at all

    def add(self, ctx: QueryContext) -> None:
        self.num_queries += 1
        for col in ctx.referenced_columns():
            self.selected[col] += 1
        for p in _walk_predicates(ctx.filter):
            if not isinstance(p.lhs, Identifier):
                continue
            col = p.lhs.name
            if p.type in (PredicateType.EQ, PredicateType.IN):
                self.eq_filters[col] += 1
            elif p.type is PredicateType.RANGE:
                self.range_filters[col] += 1
            elif p.type is PredicateType.REGEXP_LIKE:
                self.regex_filters[col] += 1
            elif p.type is PredicateType.TEXT_MATCH:
                self.text_filters[col] += 1
            elif p.type is PredicateType.JSON_MATCH:
                self.json_filters[col] += 1
        if ctx.group_by:
            cols = tuple(sorted(e.name for e in ctx.group_by
                                if isinstance(e, Identifier)))
            if cols:
                self.group_by_sets[cols] += 1
                for c in cols:
                    self.group_by_cols[c] += 1
            for fn in ctx.aggregations:
                v = agg_value_expr(fn)
                if v is None:
                    col = "*"  # count(*)
                elif isinstance(v, Identifier) and not v.name.startswith("$"):
                    col = v.name
                else:
                    continue  # expression arg: not a star-tree metric pair
                # scoped to the group set: pairs from OTHER group-bys must
                # not leak into a tree recommended for this set
                self.agg_pairs[(cols, fn.name.upper(), col)] += 1


def recommend(schema: Schema, queries: List[str],
              qps: float = 0.0) -> Dict[str, Any]:
    """-> {"recommendations": {...config fragments...},
    "reasons": [...], "skipped": [unparseable sql]} ."""
    stats = WorkloadStats()
    skipped: List[str] = []
    for sql in queries:
        try:
            stats.add(compile_query(sql))
        except Exception:
            skipped.append(sql)
    n = max(stats.num_queries, 1)
    dims = {fs.name for fs in schema.field_specs
            if fs.field_type is not FieldType.METRIC}
    metrics = {fs.name for fs in schema.field_specs
               if fs.field_type is FieldType.METRIC}
    known = {fs.name for fs in schema.field_specs}

    rec: Dict[str, Any] = {}
    reasons: List[str] = []

    # inverted index + sorted column (InvertedSortedIndexJointRule)
    inv = [c for c, k in stats.eq_filters.most_common()
           if k / n >= INVERTED_MIN_SHARE and c in dims]
    if inv:
        sorted_col, rest = inv[0], inv[1:]
        rec["sortedColumn"] = [sorted_col]
        reasons.append(f"{sorted_col}: most-filtered column "
                       f"({stats.eq_filters[sorted_col]}/{n} queries) "
                       f"-> sorted column")
        if rest:
            rec["invertedIndexColumns"] = rest
            reasons.append(f"{rest}: EQ/IN filtered in >="
                           f"{INVERTED_MIN_SHARE:.0%} of queries "
                           f"-> inverted index")

    # bloom filters on selective EQ columns
    bloom = [c for c, k in stats.eq_filters.items()
             if k / n >= BLOOM_MIN_SHARE and c in known]
    if bloom:
        rec["bloomFilterColumns"] = sorted(bloom)
        reasons.append(f"{sorted(bloom)}: frequent EQ filters -> bloom "
                       "filter enables server-side segment pruning")

    # range index on numeric range-filtered columns
    rng = [c for c, k in stats.range_filters.items() if c in known]
    if rng:
        rec["rangeIndexColumns"] = sorted(rng)
        reasons.append(f"{sorted(rng)}: RANGE predicates -> range index")

    # text/json/fst indexes
    if stats.text_filters:
        rec["textIndexColumns"] = sorted(stats.text_filters)
        reasons.append(f"{sorted(stats.text_filters)}: TEXT_MATCH -> "
                       "tokenized text index")
    if stats.json_filters:
        rec["jsonIndexColumns"] = sorted(stats.json_filters)
        reasons.append(f"{sorted(stats.json_filters)}: JSON_MATCH -> "
                       "JSON flattening index")
    if stats.regex_filters:
        rec["fstIndexColumns"] = sorted(stats.regex_filters)
        reasons.append(f"{sorted(stats.regex_filters)}: REGEXP_LIKE -> "
                       "FST prefix index")

    # no-dictionary for unfiltered, ungrouped metrics
    nodict = [m for m in sorted(metrics)
              if not stats.eq_filters[m] and not stats.range_filters[m]
              and not stats.group_by_cols[m]]
    if nodict:
        rec["noDictionaryColumns"] = nodict
        reasons.append(f"{nodict}: metrics never filtered/grouped -> raw "
                       "encoding (saves the dictionary + gather)")

    # partitioning for dominant single-column EQ workloads at QPS
    part = [c for c, k in stats.eq_filters.items()
            if k / n >= PARTITION_MIN_SHARE and c in dims]
    if part and qps >= 100:
        col = part[0]
        rec["segmentPartitionConfig"] = {
            "columnPartitionMap": {col: {"functionName": "Murmur",
                                         "numPartitions": 8}}}
        reasons.append(f"{col}: EQ-filtered in >={PARTITION_MIN_SHARE:.0%} "
                       f"of a {qps:.0f}-QPS workload -> Murmur partitioning "
                       "for broker partition pruning")

    # star-tree for a recurring (group set, SUM/COUNT aggregations) shape
    if stats.group_by_sets:
        (top_set, hits) = stats.group_by_sets.most_common(1)[0]
        if hits / n >= STARTREE_MIN_SHARE:
            pairs = sorted({f"{fn}__{col}" for (gset, fn, col), k
                            in stats.agg_pairs.items()
                            if gset == top_set
                            and fn in ("SUM", "COUNT", "MIN", "MAX")})
            if pairs:
                rec["starTreeIndexConfigs"] = [{
                    "dimensionsSplitOrder": list(top_set),
                    "functionColumnPairs": pairs,
                    "maxLeafRecords": 10_000}]
                reasons.append(
                    f"group-by {list(top_set)} appears in {hits}/{n} "
                    f"queries with {pairs} -> star-tree pre-aggregation")

    return {"recommendations": rec, "reasons": reasons, "skipped": skipped,
            "numQueriesParsed": stats.num_queries}
