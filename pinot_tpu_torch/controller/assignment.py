"""Segment assignment: which servers host each pushed segment.

Counterpart of ``pinot_tpu/controller/assignment.py`` (the balanced
assignment with failure domains, the replica-group assignment,
``compute_instance_partitions``, the partitioned assignment of a
realtime table's LLC segments, ``assignment_for_table``): for the same
servers and segments the IdealState equals the JAX package's. The
rebalance plan waits for the periodic tasks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.controller.state import ClusterStateStore


class SegmentAssignment:
    """Picks the instances of one segment."""

    def assign(self, segment: str, current: Dict[str, Dict[str, str]],
               instances: List[str], replication: int) -> List[str]:
        raise NotImplementedError


class BalancedSegmentAssignment(SegmentAssignment):
    """Least-loaded placement; with instance failure domains known, the
    replicas of one segment spread over distinct domains first."""

    def __init__(self, domains: Optional[Dict[str, str]] = None):
        # instance id -> failure domain (absent/None = its own domain)
        self._domains = domains or {}

    def assign(self, segment, current, instances, replication):
        if not instances:
            raise ValueError("no server instances to assign to")
        load = {i: 0 for i in instances}
        for seg_map in current.values():
            for inst in seg_map:
                if inst in load:
                    load[inst] += 1
        ranked = sorted(instances, key=lambda i: (load[i], i))
        n = min(replication, len(ranked))
        if not self._domains:
            return ranked[:n]
        # greedy domain-aware pick: an unused failure domain beats load
        # rank; fall back to used domains once every domain is covered
        chosen: List[str] = []
        used_domains = set()
        pool = list(ranked)
        while len(chosen) < n and pool:
            pick = next(
                (i for i in pool
                 if self._domains.get(i, i) not in used_domains),
                pool[0])
            pool.remove(pick)
            chosen.append(pick)
            used_domains.add(self._domains.get(pick, pick))
        return chosen


class ReplicaGroupSegmentAssignment(SegmentAssignment):
    """Instances split into ``replication`` groups; each segment takes one
    instance a group. ``groups`` may be the table's stored instance
    partitions (the broker's replica-group selectors read the same
    layout)."""

    def __init__(self, num_replica_groups: int,
                 groups: Optional[List[List[str]]] = None):
        self.num_replica_groups = num_replica_groups
        self._groups = groups

    def assign(self, segment, current, instances, replication):
        if not instances:
            raise ValueError("no server instances to assign to")
        groups = self._groups or compute_instance_partitions(
            instances, self.num_replica_groups)
        seg_index = len(current)
        out = []
        for g in groups[: replication]:
            if g:
                out.append(g[seg_index % len(g)])
        return out


def compute_instance_partitions(instances: List[str],
                                num_groups: int) -> List[List[str]]:
    """Deterministic instance -> replica-group split: the sorted instances
    dealt round-robin into ``num_groups`` groups."""
    groups: List[List[str]] = [[] for _ in range(max(num_groups, 1))]
    for i, inst in enumerate(sorted(instances)):
        groups[i % max(num_groups, 1)].append(inst)
    return groups


class PartitionedReplicaGroupAssignment(SegmentAssignment):
    """Partition-aware: a segment of stream partition P lands on the
    instance that owns P in each replica group (RealtimeSegmentAssignment's
    partition mode)."""

    def __init__(self, num_replica_groups: int = 1):
        self.num_replica_groups = num_replica_groups

    def assign(self, segment, current, instances, replication,
               partition: Optional[int] = None):
        if partition is None:
            partition = _partition_from_llc_name(segment)
        groups = compute_instance_partitions(instances,
                                             self.num_replica_groups)
        out = []
        for g in groups[: replication]:
            if g:
                out.append(g[partition % len(g)])
        return out


def _partition_from_llc_name(segment: str) -> int:
    """The partition of an LLC name, ``table__partition__sequence__seed``;
    0 for any other name."""
    parts = segment.split("__")
    if len(parts) >= 3:
        try:
            return int(parts[1])
        except ValueError:
            pass
    return 0


def assignment_for_table(store: ClusterStateStore, table: str,
                         tag: Optional[str] = None) -> Tuple[List[str], int]:
    """(eligible server instance ids, replication) for a table."""
    cfg = store.get_table_config(table)
    if cfg is None:
        raise KeyError(f"no table config for {table}")
    servers = [i.instance_id for i in store.instances("SERVER", only_alive=True)
               if tag is None or tag in i.tags]
    return servers, cfg.replication
