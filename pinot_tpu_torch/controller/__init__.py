"""The controller tier: the cluster state store (the Helix / ZooKeeper
role), segment assignment and rebalance, the cluster-mutation API with
its periodic tasks, segment lineage, tiers, the minion task manager, and
for realtime tables the LLC segment manager and the segment-completion
FSM."""

from pinot_tpu_torch.controller.state import (
    CONSUMING,
    ERROR,
    OFFLINE,
    ONLINE,
    ClusterStateStore,
    InstanceInfo,
    SegmentZKMetadata,
)
from pinot_tpu_torch.controller.assignment import (
    BalancedSegmentAssignment,
    PartitionedReplicaGroupAssignment,
    ReplicaGroupSegmentAssignment,
    SegmentAssignment,
    compute_instance_partitions,
    compute_target_assignment,
    rebalance_steps,
)
from pinot_tpu_torch.controller.completion import (
    FsmState,
    SegmentCompletionManager,
)
from pinot_tpu_torch.controller.controller import Controller
from pinot_tpu_torch.controller.llc import (
    LLCRealtimeSegmentManager,
    llc_segment_name,
    parse_llc_name,
)

__all__ = [
    "CONSUMING", "ERROR", "OFFLINE", "ONLINE",
    "ClusterStateStore", "InstanceInfo", "SegmentZKMetadata",
    "BalancedSegmentAssignment", "PartitionedReplicaGroupAssignment",
    "ReplicaGroupSegmentAssignment", "SegmentAssignment",
    "compute_instance_partitions", "compute_target_assignment",
    "rebalance_steps", "FsmState", "SegmentCompletionManager",
    "Controller", "LLCRealtimeSegmentManager", "llc_segment_name",
    "parse_llc_name",
]
