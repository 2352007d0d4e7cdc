"""Multi-segment combine: segment batches scanned in one launch.

Counterpart of ``pinot_tpu/parallel`` on one card: segments stack into
unified-dictionary batches (``batch.py``), the fused scan runs once over a
batch (``combine.py``), and ``ShardedQueryExecutor`` (``executor.py``) is
the server executor over that path.
"""

from pinot_tpu_torch.parallel.batch import SegmentBatch, StagedBatch
from pinot_tpu_torch.parallel.executor import ShardedQueryExecutor

__all__ = ["SegmentBatch", "StagedBatch", "ShardedQueryExecutor"]
