"""The minion role: background task workers (merge-rollup,
realtime-to-offline, purge, convert-to-raw) over the segment processing
framework, driven by the controller's task generation.

Counterpart of ``pinot_tpu/minion/``: ``minion/tasks.py`` holds the task
executors, ``minion/worker.py`` the ``MinionInstance`` that polls for
tasks. The segments a minion writes are served by the servers' executors
like any other (the fused scan on the card).
"""

from pinot_tpu_torch.minion.tasks import (
    TASK_EXECUTORS,
    BaseTaskExecutor,
    ConvertToRawIndexTaskExecutor,
    MergeRollupTaskExecutor,
    MinionContext,
    PurgeTaskExecutor,
    RealtimeToOfflineSegmentsTaskExecutor,
)
from pinot_tpu_torch.minion.worker import MinionInstance

__all__ = [
    "BaseTaskExecutor",
    "ConvertToRawIndexTaskExecutor",
    "MergeRollupTaskExecutor",
    "MinionContext",
    "MinionInstance",
    "PurgeTaskExecutor",
    "RealtimeToOfflineSegmentsTaskExecutor",
    "TASK_EXECUTORS",
]
