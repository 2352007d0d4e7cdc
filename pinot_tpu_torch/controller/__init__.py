"""The controller tier: the cluster state store (the Helix / ZooKeeper
role), segment assignment and the cluster-mutation API, for offline
tables."""

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
    ReplicaGroupSegmentAssignment,
    SegmentAssignment,
    compute_instance_partitions,
)
from pinot_tpu_torch.controller.controller import Controller

__all__ = [
    "CONSUMING", "ERROR", "OFFLINE", "ONLINE",
    "ClusterStateStore", "InstanceInfo", "SegmentZKMetadata",
    "BalancedSegmentAssignment", "ReplicaGroupSegmentAssignment",
    "SegmentAssignment", "compute_instance_partitions", "Controller",
]
