"""The controller tier: the cluster state store (the Helix / ZooKeeper
role), segment assignment, the cluster-mutation API, and for realtime
tables the LLC segment manager and the segment-completion FSM."""

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
    "compute_instance_partitions", "FsmState", "SegmentCompletionManager",
    "Controller", "LLCRealtimeSegmentManager", "llc_segment_name",
    "parse_llc_name",
]
