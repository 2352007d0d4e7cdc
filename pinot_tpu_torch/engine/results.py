"""Result model and reduce-side finalisation.

Counterpart of ``pinot_tpu/engine/results.py`` (``reduce_group_by``,
``reduce_aggregation``): merged group states -> HAVING -> ORDER BY ->
OFFSET / LIMIT -> rows. ``QueryStats.to_dict`` / ``from_dict`` are its
form on the DataTable wire (``common/datatable.py``); ``lexsort_runs`` and
``fold_grouped_runs`` are the broker's vectorized group-by merge
(``broker/reduce.py``). A query without GROUP BY reduces to its one row:
HAVING and OFFSET do not apply there, as in the JAX package. Selection
and DISTINCT build their ``ResultTable`` in the host engine
(``engine/host_engine.py``), with the column types of the selected
columns (``INT``, ``STRING_ARRAY``, ...).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.engine.aggregates import AggDef
from pinot_tpu_torch.engine.errors import QueryError, UnsupportedQueryError
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    Expr,
    FilterNode,
    FilterOp,
    Function,
    Literal,
    PredicateType,
)

_ARITH = {
    "plus": lambda a, b: a + b,
    "minus": lambda a, b: a - b,
    "times": lambda a, b: a * b,
    "divide": lambda a, b: (a / b) if b else float("nan"),
    "mod": lambda a, b: a % b,
}


@dataclass
class DataSchema:
    column_names: List[str]
    column_types: List[str]

    def to_dict(self) -> Dict[str, Any]:
        return {"columnNames": self.column_names,
                "columnDataTypes": self.column_types}


@dataclass
class ResultTable:
    schema: DataSchema
    rows: List[List[Any]]

    def to_dict(self) -> Dict[str, Any]:
        return {"dataSchema": self.schema.to_dict(), "rows": self.rows}


# the port's launch counters and their names on the wire (the JAX stats
# have none of them; both decoders ignore keys they do not know)
_WIRE_COUNTERS = (
    ("scan_launches", "scanLaunches"),
    ("probe_launches", "probeLaunches"),
    ("sharded_scan_launches", "shardedScanLaunches"),
    ("sharded_probe_launches", "shardedProbeLaunches"),
    ("general_launches", "generalLaunches"),
    ("topk_launches", "topkLaunches"),
    ("batch_general_launches", "batchGeneralLaunches"),
    ("index_launches", "indexLaunches"),
    ("startree_launches", "startreeLaunches"),
)


@dataclass
class QueryStats:
    num_segments_queried: int = 0
    num_segments_processed: int = 0
    num_segments_matched: int = 0
    num_segments_pruned: int = 0
    num_docs_scanned: int = 0
    total_docs: int = 0
    # the merged groups were cut to the executor's num_groups_limit
    num_groups_limit_reached: bool = False
    # scatter accounting, set by the broker after the gather (servers
    # leave them 0): responded < queried is the partial-result flag
    num_servers_queried: int = 0
    num_servers_responded: int = 0
    # fused-scan launches this query made (full scans and probes), per
    # segment and over a whole segment batch
    scan_launches: int = 0
    probe_launches: int = 0
    sharded_scan_launches: int = 0
    sharded_probe_launches: int = 0
    # segment calls of the general rung (engine/kernels.py) and of the
    # ordered-selection top-k (engine/selection_device.py)
    general_launches: int = 0
    topk_launches: int = 0
    # calls of the jnp combine over a segment batch, of the index rung's
    # docId gather and of the star-tree rung's node slice
    batch_general_launches: int = 0
    index_launches: int = 0
    startree_launches: int = 0
    # the group-by rung that served: dense | compact | hash | sort | index
    # | startree_device | startree (the host walker) | host, or "mixed"
    # when segments of one query took different rungs (the JAX package's
    # QueryStats.merge rule); and segments served per rung
    group_by_rung: Optional[str] = None
    rung_segments: Dict[str, int] = field(default_factory=dict)
    # the index in segment.star_trees of the tree that served, None off the
    # star-tree rungs; a table's segments share one tree config, so the
    # last segment's is kept (the JAX package's merge rule, :151)
    startree_tree_index: Optional[int] = None
    # path decisions (record_decision): decision key -> count
    decisions: Dict[str, int] = field(default_factory=dict)
    # residency counters of this query (engine/residency.py
    # QueryLease.staging_dict): hits, misses, evictions,
    # pinBlockedEvictions, spills, promotions, demotions, slices sum at
    # merge; stagedBytes and hostBytes take the max
    staging: Dict[str, int] = field(default_factory=dict)
    # launch coalescing of this query's batch launches
    # (parallel/launcher.py): launches, coalesced, launchesSaved sum at
    # merge; batchSize and queueWaitMs (LAUNCH_MAX_KEYS) take the max
    launch: Dict[str, float] = field(default_factory=dict)
    # the broker reduce path that produced the final table ('device' |
    # 'vectorized' | 'oracle'), set once by the broker (servers leave it
    # None)
    reduce_path: Optional[str] = None
    # phase -> ms (SEGMENT_PRUNING on the server), summed at merge
    phase_ms: Dict[str, float] = field(default_factory=dict)
    # the residency lease the query runs under (ResidencyManager
    # .begin_query), None outside a query or on an uncapped CPU run
    lease: Optional[Any] = field(default=None, repr=False, compare=False)

    def add_phase_ms(self, phase: str, ms: float) -> None:
        self.phase_ms[phase] = self.phase_ms.get(phase, 0.0) + ms

    def record_rung(self, rung: str) -> None:
        self.group_by_rung = (rung if self.group_by_rung in (None, rung)
                              else "mixed")
        self.rung_segments[rung] = self.rung_segments.get(rung, 0) + 1

    def merge(self, other: "QueryStats") -> None:
        """Fold another part of the same query in (JAX
        ``QueryStats.merge``): counters sum, the rung goes "mixed" when the
        parts differ, ``staging`` keys ending in ``Bytes`` and the launch
        keys of ``LAUNCH_MAX_KEYS`` take the max."""
        for name in ("num_segments_queried", "num_segments_processed",
                     "num_segments_matched", "num_segments_pruned",
                     "num_docs_scanned", "total_docs",
                     "num_servers_queried", "num_servers_responded",
                     "scan_launches",
                     "probe_launches", "sharded_scan_launches",
                     "sharded_probe_launches", "general_launches",
                     "topk_launches", "batch_general_launches",
                     "index_launches", "startree_launches"):
            setattr(self, name, getattr(self, name) + getattr(other, name))
        self.num_groups_limit_reached |= other.num_groups_limit_reached
        if other.group_by_rung is not None:
            self.group_by_rung = (
                other.group_by_rung
                if self.group_by_rung in (None, other.group_by_rung)
                else "mixed")
        if other.startree_tree_index is not None:
            self.startree_tree_index = other.startree_tree_index
        if other.reduce_path is not None:
            self.reduce_path = other.reduce_path
        for phase, ms in other.phase_ms.items():
            self.add_phase_ms(phase, ms)
        for mine, theirs in ((self.rung_segments, other.rung_segments),
                             (self.decisions, other.decisions)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v
        for k, v in other.staging.items():
            self.staging[k] = (max(self.staging.get(k, 0), v)
                               if k.endswith("Bytes")
                               else self.staging.get(k, 0) + v)
        merge_launch(self.launch, other.launch)

    def to_dict(self) -> Dict[str, Any]:
        """The wire form: the JAX ``QueryStats.to_dict`` keys (JAX
        ``results.py:180``), then the port's own counters under their own
        names where nonzero. The lease never goes on the wire."""
        counters = {wire: getattr(self, name)
                    for name, wire in _WIRE_COUNTERS if getattr(self, name)}
        return {
            "numSegmentsQueried": self.num_segments_queried,
            "numSegmentsProcessed": self.num_segments_processed,
            "numSegmentsMatched": self.num_segments_matched,
            "numSegmentsPrunedByServer": self.num_segments_pruned,
            "numDocsScanned": self.num_docs_scanned,
            "totalDocs": self.total_docs,
            "numGroupsLimitReached": self.num_groups_limit_reached,
            **({"numServersQueried": self.num_servers_queried,
                "numServersResponded": self.num_servers_responded}
               if self.num_servers_queried else {}),
            "phaseTimesMs": {k: round(v, 3)
                             for k, v in self.phase_ms.items()},
            **({"groupByRung": self.group_by_rung}
               if self.group_by_rung else {}),
            **({"startreeTreeIndex": self.startree_tree_index}
               if self.startree_tree_index is not None else {}),
            **({"reducePath": self.reduce_path}
               if self.reduce_path else {}),
            **({"staging": self.staging} if self.staging else {}),
            **({"launch": self.launch} if self.launch else {}),
            **({"decisions": self.decisions} if self.decisions else {}),
            **counters,
            **({"rungSegments": self.rung_segments}
               if self.rung_segments else {}),
        }

    @classmethod
    def from_dict(cls, st: Dict[str, Any]) -> "QueryStats":
        """Decode ``to_dict`` (or the JAX package's form); unknown keys
        are ignored."""
        out = cls(
            num_segments_queried=st.get("numSegmentsQueried", 0),
            num_segments_processed=st.get("numSegmentsProcessed", 0),
            num_segments_matched=st.get("numSegmentsMatched", 0),
            num_segments_pruned=st.get("numSegmentsPrunedByServer", 0),
            num_docs_scanned=st.get("numDocsScanned", 0),
            total_docs=st.get("totalDocs", 0),
            num_groups_limit_reached=st.get("numGroupsLimitReached", False),
            num_servers_queried=st.get("numServersQueried", 0),
            num_servers_responded=st.get("numServersResponded", 0),
            group_by_rung=st.get("groupByRung"),
            startree_tree_index=st.get("startreeTreeIndex"),
            reduce_path=st.get("reducePath"),
            staging=dict(st.get("staging", {})),
            launch=dict(st.get("launch", {})),
            phase_ms=dict(st.get("phaseTimesMs", {})),
            decisions=dict(st.get("decisions", {})),
            rung_segments=dict(st.get("rungSegments", {})))
        for name, wire in _WIRE_COUNTERS:
            setattr(out, name, int(st.get(wire, 0)))
        return out


# launch keys whose merge takes the max (the JAX launcher's
# LAUNCH_MAX_KEYS); the others sum
LAUNCH_MAX_KEYS = ("batchSize", "queueWaitMs")


def merge_launch(into: Dict[str, float], other: Dict[str, float]) -> None:
    """Fold one launch record into another, in place."""
    for k, v in other.items():
        into[k] = (max(into.get(k, 0), v) if k in LAUNCH_MAX_KEYS
                   else into.get(k, 0) + v)


def decision_key(point: str, chosen: str, declined: str,
                 reason: str) -> str:
    return f"{point}:{declined}->{chosen}:{reason}"


def record_decision(stats: Optional[QueryStats], point: str, chosen: str,
                    declined: str, reason: str) -> None:
    """Execution declined ``declined`` in favour of ``chosen`` at
    ``point`` because ``reason`` (``pinot_tpu/common/tracing.py``
    ``record_decision``, without the process-wide ledger). ``stats`` None
    (a routing probe outside a query) records nothing."""
    if stats is None:
        return
    key = decision_key(point, chosen, declined, reason)
    stats.decisions[key] = stats.decisions.get(key, 0) + 1


@dataclass
class AggResult:
    """Aggregation without group-by: one state per aggregation."""

    states: List[Any]

    def merge(self, other: "AggResult", aggs: List[AggDef]) -> None:
        self.states = [a.merge(s, o) for a, s, o in
                       zip(aggs, self.states, other.states)]


@dataclass
class GroupByResult:
    """group key (tuple of python values) -> [state per agg]."""

    groups: Dict[Tuple, List[Any]] = field(default_factory=dict)

    def merge(self, other: "GroupByResult", aggs: List[AggDef]) -> None:
        for key, states in other.groups.items():
            mine = self.groups.get(key)
            if mine is None:
                self.groups[key] = list(states)
            else:
                self.groups[key] = [a.merge(m, s) for a, m, s in
                                    zip(aggs, mine, states)]

    def trim(self, max_size: int) -> bool:
        """Keep the first ``max_size`` groups in insertion order (Pinot's
        numGroupsLimit); True when groups were cut."""
        if len(self.groups) <= max_size:
            return False
        self.groups = dict(list(self.groups.items())[:max_size])
        return True


# numeric states whose merge across servers is an elementwise ufunc fold;
# every other state (tuples, sketches, sets) merges through AggDef.merge
_VEC_STATE_FOLDS: Dict[str, Any] = {
    "count": np.add,
    "sum": np.add,
    "min": np.minimum,
    "max": np.maximum,
}


def lexsort_runs(sort_keys: List[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One stable ``np.lexsort`` over the concatenated key columns ->
    ``(order, starts)``: ``order`` puts equal keys next to each other
    (ties keep input order, the row oracle's dict-insertion order),
    ``starts`` marks each run's first sorted position. A NaN key equals
    nothing, so every NaN row is its own run, as in the oracle's dict."""
    n = int(len(sort_keys[0])) if sort_keys else 0
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    order = np.lexsort(tuple(reversed(sort_keys)))
    if n == 1:
        return order, np.zeros(1, np.int64)
    diff = np.zeros(n - 1, dtype=bool)
    for k in sort_keys:
        ks = k[order]
        diff |= ks[1:] != ks[:-1]
    starts = np.concatenate(
        (np.zeros(1, np.int64), np.flatnonzero(diff) + 1))
    return order, starts


def fold_grouped_runs(order: np.ndarray, starts: np.ndarray, n: int,
                      agg_entries: List[Tuple[str, Any]],
                      aggs: List[AggDef]) -> List[Any]:
    """Fold each run's states: -> one folded sequence per aggregation, in
    run (sorted) order. ``agg_entries[i]`` is ``("vec", array)`` for a
    numeric state (``aggs[i].base`` in ``_VEC_STATE_FOLDS``: one
    ``reduceat`` folds every group) or ``("obj", list)``, merged per run
    through ``AggDef.merge`` in ascending input order (merge-order
    sensitive sketches stay bit-identical to the oracle)."""
    out: List[Any] = []
    ends = np.concatenate((starts[1:], np.asarray([n], dtype=np.int64)))
    for (tag, data), agg in zip(agg_entries, aggs):
        if tag == "vec":
            out.append(_VEC_STATE_FOLDS[agg.base].reduceat(data[order],
                                                           starts))
        else:
            states = []
            for s, e in zip(starts, ends):
                run = order[s:e]
                st = data[int(run[0])]
                for i in run[1:]:
                    st = agg.merge(st, data[int(i)])
                states.append(st)
            out.append(states)
    return out


def _env_lookup(env: Dict[str, Any], expr: Expr) -> Any:
    key = str(expr)
    if key in env:
        return env[key]
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, Function) and expr.name in _ARITH:
        a = _env_lookup(env, expr.args[0])
        b = _env_lookup(env, expr.args[1])
        return _ARITH[expr.name](float(a), float(b))
    raise QueryError(f"expression {expr} is not in GROUP BY or an aggregation")


def _eval_scalar_filter(node: FilterNode, env: Dict[str, Any]) -> bool:
    """HAVING over one group's finalized values."""
    if node.op is FilterOp.AND:
        return all(_eval_scalar_filter(c, env) for c in node.children)
    if node.op is FilterOp.OR:
        return any(_eval_scalar_filter(c, env) for c in node.children)
    if node.op is FilterOp.NOT:
        return not _eval_scalar_filter(node.children[0], env)
    p = node.predicate
    v = _env_lookup(env, p.lhs)
    t = p.type
    if t is PredicateType.EQ:
        return v == p.value
    if t is PredicateType.NOT_EQ:
        return v != p.value
    if t is PredicateType.IN:
        return v in p.values
    if t is PredicateType.NOT_IN:
        return v not in p.values
    if t is PredicateType.RANGE:
        if p.lower is not None and (v < p.lower if p.lower_inclusive
                                    else v <= p.lower):
            return False
        if p.upper is not None and (v > p.upper if p.upper_inclusive
                                    else v >= p.upper):
            return False
        return True
    raise UnsupportedQueryError(f"HAVING predicate {t} not supported")


class _Reversible:
    """Sort-key wrapper supporting DESC for any comparable value."""

    __slots__ = ("v", "asc")

    def __init__(self, v, asc: bool):
        self.v = v
        self.asc = asc

    def __lt__(self, other: "_Reversible") -> bool:
        if self.v == other.v:
            return False
        lt = self.v < other.v
        return lt if self.asc else not lt

    def __eq__(self, other) -> bool:
        return self.v == other.v


def _finalize_cell(v: Any) -> Any:
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def _result_schema(ctx: QueryContext, aggs: List[AggDef],
                   schema_types: Dict[str, str]) -> Tuple[List[str], List[str]]:
    agg_types = {str(fn): a.result_type
                 for fn, a in zip(ctx.aggregations, aggs)}
    names: List[str] = []
    types: List[str] = []
    for e, alias in zip(ctx.select_expressions, ctx.aliases):
        names.append(alias if alias else str(e))
        k = str(e)
        types.append(agg_types.get(k) or schema_types.get(k) or "DOUBLE")
    return names, types


def reduce_group_by(ctx: QueryContext, aggs: List[AggDef],
                    merged: GroupByResult,
                    schema_types: Dict[str, str]) -> ResultTable:
    envs = []
    for key, states in merged.groups.items():
        env: Dict[str, Any] = {str(e): v for e, v in zip(ctx.group_by, key)}
        for fn, agg, st in zip(ctx.aggregations, aggs, states):
            env[str(fn)] = agg.finalize(st)
        envs.append(env)
    if ctx.having is not None:
        envs = [e for e in envs if _eval_scalar_filter(ctx.having, e)]
    if ctx.order_by:
        envs.sort(key=lambda env: tuple(
            _Reversible(_env_lookup(env, ob.expr), ob.ascending)
            for ob in ctx.order_by))
    rows_env = envs[ctx.offset: ctx.offset + ctx.limit]
    names, types = _result_schema(ctx, aggs, schema_types)
    rows = [[_finalize_cell(_env_lookup(env, e))
             for e in ctx.select_expressions] for env in rows_env]
    return ResultTable(DataSchema(names, types), rows)


def reduce_aggregation(ctx: QueryContext, aggs: List[AggDef],
                       merged: AggResult) -> ResultTable:
    env = {str(fn): agg.finalize(st)
           for fn, agg, st in zip(ctx.aggregations, aggs, merged.states)}
    names, types = _result_schema(ctx, aggs, {})
    row = [_finalize_cell(_env_lookup(env, e)) for e in ctx.select_expressions]
    return ResultTable(DataSchema(names, types), [row])
