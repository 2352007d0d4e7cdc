"""Multi-segment combine: segment batches scanned in one call over a mesh.

Counterpart of ``pinot_tpu/parallel``: segments stack into
unified-dictionary batches (``batch.py``), the fused scan runs once over a
batch, or once a cell of a ``seg x doc`` mesh of devices with the cells'
partials folded on the mesh's root (``mesh.py``, ``combine.py``), and
``ShardedQueryExecutor`` (``executor.py``) is the server executor over
that path.
"""

from pinot_tpu_torch.parallel.batch import (
    MeshStagedBatch,
    SegmentBatch,
    StagedBatch,
)
from pinot_tpu_torch.parallel.executor import ShardedQueryExecutor
from pinot_tpu_torch.parallel.mesh import (
    DOC_AXIS,
    SEG_AXIS,
    CombineMesh,
    make_combine_mesh,
)

__all__ = ["CombineMesh", "DOC_AXIS", "MeshStagedBatch", "SEG_AXIS",
           "SegmentBatch", "ShardedQueryExecutor", "StagedBatch",
           "make_combine_mesh"]
