"""Broker routing: segment -> server routes with pruning and replica
selection.

Counterpart of ``pinot_tpu/broker/routing.py``: the three instance
selectors (balanced, replica-group, strict replica-group), partition and
time pruning, the hybrid ``TimeBoundaryManager`` and the
``RoutingManager``, whose per-query path reads a per-table
``RoutingTable`` snapshot (replicas, resolved partition functions, time
ranges) built once from the state store and dropped by the store's prefix
watches, so a warmed route reads nothing from the store. Routing follows
the ExternalView: only segments a live server serves are routable.

Every routing outcome is a path decision (``engine/results.py``
``record_decision``): a prune records
``routing:all_servers->pruned:partition_prune`` / ``:time_prune``; a
configured pruner that could not prune records why
(``ROUTING_DECISION_REASONS``). Segments that lineage hides (a replaced
input, an output still in flight) are left out; the port's controller
writes no lineage yet, so ``_lineage_hidden`` finds nothing.
"""

from __future__ import annotations

import threading

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.common.tracing import record_decision
from pinot_tpu_torch.controller.state import (
    CONSUMING,
    ONLINE,
    ClusterStateStore,
)
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.expressions import (
    FilterNode,
    FilterOp,
    Identifier,
    PredicateType,
)
from pinot_tpu_torch.utils.partition import get_partition_function

# the codes the routing decision point records (JAX
# pinot_tpu/common/tracing.py:388 ROUTING_DECISION_REASONS): a prune that
# fired, or why a configured pruner could not help
ROUTING_DECISION_REASONS = frozenset({
    "partition_prune",
    "time_prune",
    "no_filter",
    "no_partition_predicate",
    "no_partition_metadata",
    "partition_all_match",
    "no_time_bound",
    "time_all_match",
})


class BalancedInstanceSelector:
    """Round-robin replica pick by requestId, dead instances excluded."""

    def select(self, segment: str, replicas: List[str], request_id: int,
               excluded: frozenset) -> Optional[str]:
        candidates = sorted(r for r in replicas if r not in excluded)
        if not candidates:
            return None
        return candidates[request_id % len(candidates)]


class ReplicaGroupInstanceSelector:
    """One replica group serves the whole query: requestId picks the
    group, so each query fans out to 1/N of the servers. A segment the
    picked group cannot serve falls back to any live replica."""

    def __init__(self, groups: List[List[str]]):
        self.groups = [set(g) for g in groups if g]

    def select(self, segment: str, replicas: List[str], request_id: int,
               excluded: frozenset) -> Optional[str]:
        live = sorted(r for r in replicas if r not in excluded)
        if not live:
            return None
        if self.groups:
            n = len(self.groups)
            for off in range(n):
                group = self.groups[(request_id + off) % n]
                in_group = [r for r in live if r in group]
                if in_group:
                    return in_group[0]
        return live[request_id % len(live)]


class StrictReplicaGroupInstanceSelector(ReplicaGroupInstanceSelector):
    """Strict variant: no fallback across groups. A segment the picked
    group cannot serve is unavailable for this query, so every segment of
    a query lands on one group (what upsert consistency needs)."""

    def select(self, segment: str, replicas: List[str], request_id: int,
               excluded: frozenset) -> Optional[str]:
        live = {r for r in replicas if r not in excluded}
        if not live or not self.groups:
            return None
        group = self.groups[request_id % len(self.groups)]
        in_group = sorted(live & group)
        return in_group[0] if in_group else None


# how wide a closed integer RANGE on the partition column may be before
# enumerating its values stops being cheaper than scattering everywhere
_MAX_PARTITION_RANGE_ENUM = 1024


def _int_literal(v) -> Optional[int]:
    """The literal as an int ONLY when it already is one — a string
    column's lexicographic range ('1'..'3' matches '25') must never be
    enumerated numerically."""
    return v if isinstance(v, int) and not isinstance(v, bool) else None


def _partition_filter_values(node: Optional[FilterNode]) -> Dict[str, List]:
    """column -> candidate literal values from top-level AND-ed EQ/IN
    predicates, plus closed integer RANGEs narrow enough to enumerate —
    the only shapes partition pruning can use soundly (a matched row's
    value is guaranteed to be in the returned list)."""
    out: Dict[str, List] = {}
    if node is None:
        return out

    def visit(n: FilterNode):
        if n.op is FilterOp.AND:
            for c in n.children:
                visit(c)
            return
        if n.op is not FilterOp.PREDICATE:
            return
        p = n.predicate
        if not isinstance(p.lhs, Identifier):
            return
        if p.type is PredicateType.EQ:
            out.setdefault(p.lhs.name, []).append(p.value)
        elif p.type is PredicateType.IN:
            out.setdefault(p.lhs.name, []).extend(p.values)
        elif p.type is PredicateType.RANGE:
            lo = _int_literal(p.lower)
            hi = _int_literal(p.upper)
            if lo is None or hi is None:
                return
            lo += 0 if p.lower_inclusive else 1
            hi -= 0 if p.upper_inclusive else 1
            if lo > hi or hi - lo + 1 > _MAX_PARTITION_RANGE_ENUM:
                return
            out.setdefault(p.lhs.name, []).extend(range(lo, hi + 1))

    visit(node)
    return out


def extract_time_interval(node: Optional[FilterNode], time_column: str
                          ) -> Tuple[Optional[int], Optional[int]]:
    """[lo, hi] bound on the time column implied by the filter (top-level
    AND-ed predicates only)."""
    lo: Optional[int] = None
    hi: Optional[int] = None
    if node is None:
        return lo, hi

    def visit(n: FilterNode):
        nonlocal lo, hi
        if n.op is FilterOp.AND:
            for c in n.children:
                visit(c)
            return
        if n.op is not FilterOp.PREDICATE:
            return
        p = n.predicate
        if not isinstance(p.lhs, Identifier) or p.lhs.name != time_column:
            return
        if p.type is PredicateType.EQ:
            v = int(p.value)
            lo = v if lo is None else max(lo, v)
            hi = v if hi is None else min(hi, v)
        elif p.type is PredicateType.RANGE:
            if p.lower is not None:
                v = int(p.lower) + (0 if p.lower_inclusive else 1)
                lo = v if lo is None else max(lo, v)
            if p.upper is not None:
                v = int(p.upper) - (0 if p.upper_inclusive else 1)
                hi = v if hi is None else min(hi, v)

    visit(node)
    return lo, hi


class TimeBoundaryManager:
    """A hybrid table's split point: the offline side serves ``time <=
    boundary``, the realtime side ``time > boundary``; the boundary is the
    largest offline end time less one time-column unit."""

    def __init__(self, store: ClusterStateStore):
        self.store = store

    def get_boundary(self, offline_table: str) -> Optional[int]:
        end_times = [md.end_time for md
                     in self.store.segment_metadata_list(offline_table)
                     if md.end_time is not None]
        if not end_times:
            return None
        return max(end_times) - 1


@dataclass(frozen=True)
class SegmentRouteInfo:
    """Everything routing needs about one segment, resolved when the
    table's snapshot is built."""

    replicas: Tuple[str, ...]                 # instances serving it (EV)
    # (start, end) time range; None = never time-prunable (missing
    # metadata, or a CONSUMING segment whose range is still growing)
    time_range: Optional[Tuple[int, int]]
    # per partitioned column: (column, partition function, partition set)
    partitions: Tuple[Tuple[str, object, frozenset], ...] = ()


@dataclass
class RoutingTable:
    """Per-table routing snapshot. Immutable once built; replaced (never
    mutated) when a watch invalidates it."""

    table: str
    version: int                              # store version at build
    segments: Dict[str, SegmentRouteInfo]
    time_column: Optional[str]
    partition_pruning: bool                   # pruner configured on table
    has_partition_metadata: bool              # any segment carries it
    selector: object


@dataclass
class RouteResult:
    """One query's routing outcome with its prune accounting: segments
    pruned by time and partition, and the servers the unpruned list
    would have asked."""

    routing: Dict[str, List[str]]
    unavailable: List[str]
    segments_total: int = 0
    segments_routed: int = 0
    time_pruned: int = 0
    partition_pruned: int = 0
    # scatter fan-out had no pruning happened vs what was actually used
    servers_unpruned: int = 0
    servers_routed: int = 0


class RoutingManager:
    """Watches the ExternalView and instance liveness and serves each
    query's routes from the per-table snapshots (no store read on a
    warmed route)."""

    def __init__(self, store: ClusterStateStore):
        self.store = store
        self.selector = BalancedInstanceSelector()
        self.time_boundary = TimeBoundaryManager(store)
        self._request_id = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        # table -> RoutingTable snapshot (guarded-by: _lock); invalidated
        # by the prefix watches below — the Helix-spectator push model
        self._tables: Dict[str, RoutingTable] = {}
        # (store version, dead-instance frozenset) (guarded-by: _lock)
        self._dead: Optional[Tuple[int, frozenset]] = None
        # table -> (store version at compute time, hidden segment set); the
        # version stamp closes the TOCTOU where a watch-driven clear lands
        # between computing the set and caching it (the stale insert would
        # otherwise persist until the next lineage mutation)
        self._lineage_cache: Dict[str, Tuple[int, frozenset]] = {}
        store.watch("lineage/",
                    lambda path, value: self._lineage_cache.clear())
        # routing follows every input that fed the snapshot: segment ZK
        # metadata, ExternalView, table config, instance partitions
        for prefix in ("segments/", "externalview/", "tables/",
                       "instancepartitions/"):
            store.watch(prefix, self._on_table_change)
        store.watch("instances/", self._on_instance_change)

    # -- watch callbacks ----------------------------------------------------------
    def _on_table_change(self, path: str, value) -> None:
        parts = path.split("/")
        if len(parts) < 2:
            return
        with self._lock:
            self._tables.pop(parts[1], None)

    def _on_instance_change(self, path: str, value) -> None:
        with self._lock:
            self._dead = None

    def _next_request_id(self) -> int:
        with self._lock:
            self._request_id += 1
            return self._request_id

    # -- snapshot build -----------------------------------------------------------
    def _routing_entry(self, table: str) -> RoutingTable:
        with self._lock:
            entry = self._tables.get(table)
        if entry is not None:
            return entry
        entry = self._build_entry(table)
        with self._lock:
            self._tables[table] = entry
        # a mutation racing this build may have fired the invalidating
        # watch BEFORE the insert above; self-evict so the stale snapshot
        # can't outlive the race (any post-mutation clear removes it too)
        if self.store.version != entry.version:
            with self._lock:
                if self._tables.get(table) is entry:
                    del self._tables[table]
        return entry

    def _build_entry(self, table: str) -> RoutingTable:
        ver = self.store.version
        ev = self.store.get_external_view(table)
        cfg = self.store.get_table_config(table)
        time_column = (cfg.validation_config.time_column_name
                       if cfg else None)
        pruners = (cfg.routing_config.segment_pruner_types if cfg else [])
        partition_pruning = any(p.lower() == "partition" for p in pruners)
        mds = {md.segment_name: md
               for md in self.store.segment_metadata_list(table)}

        segments: Dict[str, SegmentRouteInfo] = {}
        any_partition_md = False
        for seg, imap in ev.items():
            md = mds.get(seg)
            time_range = None
            parts: Tuple = ()
            if md is not None:
                # consuming segments are never time-pruned: their range is
                # still growing
                if (md.status != CONSUMING and md.start_time is not None
                        and md.end_time is not None):
                    time_range = (md.start_time, md.end_time)
                if partition_pruning and md.partition_metadata:
                    built = []
                    for col, pm in md.partition_metadata.items():
                        if pm and pm.get("partitions"):
                            fn = get_partition_function(
                                pm["functionName"], pm["numPartitions"])
                            built.append((col, fn,
                                          frozenset(pm["partitions"])))
                    parts = tuple(built)
                    any_partition_md = any_partition_md or bool(parts)
            segments[seg] = SegmentRouteInfo(
                replicas=tuple(sorted(
                    inst for inst, st in imap.items()
                    if st in (ONLINE, CONSUMING))),
                time_range=time_range, partitions=parts)
        return RoutingTable(
            table=table, version=ver, segments=segments,
            time_column=time_column, partition_pruning=partition_pruning,
            has_partition_metadata=any_partition_md,
            selector=self._build_selector(cfg, table))

    def _build_selector(self, cfg, table: str):
        """The table's instance selector from its routing config; part of
        the snapshot, so a config or instance-partitions change rebuilds it
        with the table entry."""
        kind = (cfg.routing_config.instance_selector_type
                if cfg else "balanced")
        if kind == "balanced":
            return self.selector
        groups = self.store.get_instance_partitions(table) or []
        return (StrictReplicaGroupInstanceSelector(groups)
                if kind == "strictReplicaGroup"
                else ReplicaGroupInstanceSelector(groups))

    def _dead_instances(self) -> frozenset:
        with self._lock:
            cached = self._dead
        if cached is not None:
            return cached[1]
        ver = self.store.version
        dead = frozenset(i.instance_id
                         for i in self.store.instances("SERVER")
                         if not i.alive)
        with self._lock:
            self._dead = (ver, dead)
        if self.store.version != ver:
            with self._lock:
                if self._dead is not None and self._dead[0] == ver:
                    self._dead = None
        return dead

    # -- the routing table ---------------------------------------------------
    def route(self, table: str, ctx: Optional[QueryContext] = None,
              request_id: Optional[int] = None,
              stats=None) -> RouteResult:
        """Routes from the cached snapshot (segments actually being
        served), prunes by partition + time metadata, picks one replica
        per segment. ``stats`` (a QueryStats, usually the broker-side
        one) receives the routing decision records."""
        if request_id is None:
            request_id = self._next_request_id()
        entry = self._routing_entry(table)
        dead = self._dead_instances()

        segments = list(entry.segments.keys())
        # lineage visibility: replaced inputs and in-flight outputs are
        # hidden
        hidden = self._lineage_hidden(table)
        if hidden:
            segments = [s for s in segments if s not in hidden]
        total = len(segments)

        after_time = self._time_prune(entry, ctx, segments, stats)
        pruned = self._partition_prune(entry, ctx, after_time, stats)
        res = RouteResult(
            routing={}, unavailable=[], segments_total=total,
            segments_routed=len(pruned),
            time_pruned=total - len(after_time),
            partition_pruned=len(after_time) - len(pruned))

        def select(seg_list):
            routing: Dict[str, List[str]] = {}
            unavailable: List[str] = []
            for segment in seg_list:
                replicas = list(entry.segments[segment].replicas)
                chosen = entry.selector.select(segment, replicas,
                                               request_id, dead)
                if chosen is None:
                    unavailable.append(segment)
                else:
                    routing.setdefault(chosen, []).append(segment)
            return routing, unavailable

        res.routing, res.unavailable = select(pruned)
        res.servers_routed = len(res.routing)
        if len(pruned) != total:
            # the counterfactual fan-out: same selector, same requestId,
            # over the UNPRUNED list — what the prune-ratio gates compare
            res.servers_unpruned = len(select(segments)[0])
        else:
            res.servers_unpruned = res.servers_routed
        return res

    def _lineage_hidden(self, table: str) -> frozenset:
        cached = self._lineage_cache.get(table)
        if cached is not None:
            return cached[1]
        ver = self.store.version
        hidden = set()
        # a completed replacement hides its inputs, one in progress (or
        # reverted) its outputs
        for e in self.store.get(f"lineage/{table}") or []:
            hidden.update(e["segmentsFrom"] if e.get("state") == "COMPLETED"
                          else e["segmentsTo"])
        hidden = frozenset(hidden)
        self._lineage_cache[table] = (ver, hidden)
        # a mutation racing this compute may have fired the invalidating
        # watch before the insert above: drop the stale set
        if self.store.version != ver:
            self._lineage_cache.pop(table, None)
        return hidden

    def _partition_prune(self, entry: RoutingTable,
                         ctx: Optional[QueryContext],
                         segments: List[str], stats) -> List[str]:
        """Partition pruning: top-level AND-ed EQ/IN predicates
        (+ narrow closed int ranges) on a partitioned column keep only
        segments whose recorded partition set contains a literal's
        partition. Every outcome is a recorded decision."""
        if not entry.partition_pruning:
            return segments  # pruner not configured: not a decline

        def declined(reason: str) -> None:
            if ctx is not None:
                record_decision(stats, "routing", "all_servers", "pruned",
                                reason)

        if ctx is None or ctx.filter is None:
            declined("no_filter")
            return segments
        if not entry.has_partition_metadata:
            declined("no_partition_metadata")
            return segments
        values = _partition_filter_values(ctx.filter)
        if not values:
            declined("no_partition_predicate")
            return segments
        out = []
        for seg in segments:
            info = entry.segments[seg]
            keep = True
            for col, fn, parts in info.partitions:
                lits = values.get(col)
                if not lits:
                    continue
                if not any(fn.partition(v) in parts for v in lits):
                    keep = False
                    break
            if keep:
                out.append(seg)
        if len(out) < len(segments):
            record_decision(stats, "routing", "pruned", "all_servers",
                            "partition_prune")
        else:
            declined("partition_all_match")
        return out

    def _time_prune(self, entry: RoutingTable, ctx: Optional[QueryContext],
                    segments: List[str], stats) -> List[str]:
        """Time pruning: drop the segments whose [start, end] time range
        cannot meet the query's time interval."""
        if ctx is None or entry.time_column is None:
            return segments  # no time column / bare routing probe:
            #                  pruner cannot apply — not a decline

        def declined(reason: str) -> None:
            record_decision(stats, "routing", "all_servers", "pruned",
                            reason)

        lo, hi = extract_time_interval(ctx.filter, entry.time_column)
        if lo is None and hi is None:
            declined("no_time_bound")
            return segments
        out = []
        for seg in segments:
            tr = entry.segments[seg].time_range
            if tr is None:
                out.append(seg)  # consuming / missing range: never pruned
                continue
            if hi is not None and tr[0] > hi:
                continue
            if lo is not None and tr[1] < lo:
                continue
            out.append(seg)
        if len(out) < len(segments):
            record_decision(stats, "routing", "pruned", "all_servers",
                            "time_prune")
        else:
            declined("time_all_match")
        return out
