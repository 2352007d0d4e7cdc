"""Multi-segment combine on one card: the fused scan over a whole batch.

Counterpart of ``pinot_tpu/parallel/combine.py`` ``pad_segments`` (:286),
``build_sharded_pallas_kernel`` (:298) and ``build_sharded_pallas_probe``
(:360). On the TPU each ``(seg, doc)`` mesh cell runs the fused kernel over
its block of the batch and the cells merge with psum/pmin/pmax. On one
card the mesh has one cell: the CUDA fused-scan kernel runs once over all
``S * T`` tiles of the batch, every segment adds into the same outputs
(the batch's unified dictionaries give one group key space), and only the
matched-doc counts stay per segment. The merge across cards (the mesh
collectives as NCCL over four cards) is not part of this module.

Each wrapper has its own launch counter, so a run shows which path served;
the kernel is the same as the per-segment path's. ``BATCH_KERNELS`` is the
pair a staged batch's scans launch through.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pinot_tpu_torch.engine.fused_scan import (
    KernelCounter,
    ScanKernels,
    ScanOutputs,
    ScanProgram,
    counted_scan,
)

# devices on the segment axis of the combine: one card
SEG_SHARDS = 1

SHARDED_SCAN_COUNTER = KernelCounter("sharded_fused_scan")
SHARDED_PROBE_COUNTER = KernelCounter("sharded_fused_scan_probe")


def pad_segments(n: int, n_seg: int) -> int:
    """Segments padded up to a multiple of the seg-axis size."""
    return ((n + n_seg - 1) // n_seg) * n_seg


def _check_batch(prog: ScanProgram, probe: bool) -> None:
    if prog.probe != probe:
        raise ValueError("a probe program goes to sharded_fused_scan_probe, "
                         "a full scan to sharded_fused_scan")


def sharded_fused_scan(prog: ScanProgram, batch_words: List[torch.Tensor],
                       batch_values: List[torch.Tensor],
                       num_docs: torch.Tensor,
                       tiles: Optional[int] = None) -> ScanOutputs:
    """One launch of the fused scan over a segment batch: packed columns
    ``[S, T, W]``, value columns ``[S, T * TILE]``, ``num_docs`` [S] int64
    (``tiles`` = T when the plan reads no column). CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version."""
    _check_batch(prog, False)
    return counted_scan(prog, batch_words, batch_values, num_docs,
                        SHARDED_SCAN_COUNTER, tiles)


def sharded_fused_scan_probe(prog: ScanProgram,
                             batch_words: List[torch.Tensor],
                             num_docs: torch.Tensor) -> ScanOutputs:
    """The group-range probe over a segment batch, in one launch: its
    min/max rows cover every segment."""
    _check_batch(prog, True)
    return counted_scan(prog, batch_words, [], num_docs,
                        SHARDED_PROBE_COUNTER)


BATCH_KERNELS = ScanKernels(sharded_fused_scan, sharded_fused_scan_probe,
                            SHARDED_SCAN_COUNTER, SHARDED_PROBE_COUNTER)
