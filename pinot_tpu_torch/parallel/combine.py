"""Multi-segment combine on one card: one scan over a whole batch.

Counterpart of ``pinot_tpu/parallel/combine.py`` on one card:

- the fused scan (``pad_segments`` :286, ``build_sharded_pallas_kernel``
  :298, ``build_sharded_pallas_probe`` :360). On the TPU each ``(seg,
  doc)`` mesh cell runs the fused kernel over its block of the batch and
  the cells merge with psum/pmin/pmax. On one card the mesh has one cell:
  the CUDA fused-scan kernel runs once over all ``S * T`` tiles of the
  batch, every segment adds into the same outputs (the batch's unified
  dictionaries give one group key space), and only the matched-doc counts
  stay per segment. Each wrapper has its own launch counter, so a run
  shows which path served; the kernel is the same as the per-segment
  path's. ``BATCH_KERNELS`` is the pair a staged batch's scans launch
  through. ``sharded_fused_scan_many`` and ``sharded_fused_scan_probe_many``
  run Q same-layout programs of concurrent queries over one batch in one
  launch (the kernel's query axis; the counterpart of the launcher's
  ``jax.vmap`` over the sharded Pallas call, ``pinot_tpu/parallel/
  launcher.py:92-116``), each beside its plain version.
- the jnp combine (``build_sharded_kernel`` :192, ``_sparse_cross_combine``
  :118), which serves every plan the fused scan declines over a batch:
  ``batch_body_combine`` runs the general rung's body
  (``engine/kernels.py``) over each segment of the stacked batch on the
  device, merges the partials by ``partial_reduce_ops`` (a sparse
  group-by re-groups the segments' compacts by sort) and packs the merged
  tree with the per-segment matched counts into one f64 tensor;
  ``combine_to_host`` copies it to the host once a query (twice where a
  sparse group-by's hash table overflowed and the sort pass reruns).

The merge across cards (the mesh collectives as NCCL over four cards) is
not part of this module: on one card ``_cross_reduce`` is a no-op.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.engine import kernels
from pinot_tpu_torch.engine.fused_scan import (
    KernelCounter,
    ScanKernels,
    ScanOutputs,
    ScanProgram,
    counted_scan,
    counted_scan_many,
    fused_scan_many_plain,
)

# devices on the segment axis of the combine: one card
SEG_SHARDS = 1

SHARDED_SCAN_COUNTER = KernelCounter("sharded_fused_scan",
                                     "sharded_scan_launches")
SHARDED_PROBE_COUNTER = KernelCounter("sharded_fused_scan_probe",
                                      "sharded_probe_launches")
SHARDED_SCAN_MANY_COUNTER = KernelCounter("sharded_fused_scan_many",
                                          "sharded_scan_launches")
SHARDED_PROBE_MANY_COUNTER = KernelCounter(
    "sharded_fused_scan_probe_many", "sharded_probe_launches")
# calls of the jnp combine over a batch, on any device (PyTorch ops, as the
# per-segment general rung's RUNG_COUNTER)
BATCH_GENERAL_COUNTER = KernelCounter("batch_general",
                                      "batch_general_launches")


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


def sharded_fused_scan_many(progs: List[ScanProgram],
                            batch_words: List[torch.Tensor],
                            batch_values: List[torch.Tensor],
                            num_docs: torch.Tensor,
                            tiles: Optional[int] = None
                            ) -> List[ScanOutputs]:
    """Q full-scan programs of one layout (``ScanProgram.layout_key``)
    over one segment batch, in one launch of the query axis: one outputs
    each. CUDA tensors launch the kernel (or raise); CPU tensors run
    ``sharded_fused_scan_many_plain``."""
    for p in progs:
        _check_batch(p, False)
    return counted_scan_many(progs, batch_words, batch_values, num_docs,
                             SHARDED_SCAN_MANY_COUNTER, tiles)


def sharded_fused_scan_probe_many(progs: List[ScanProgram],
                                  batch_words: List[torch.Tensor],
                                  num_docs: torch.Tensor
                                  ) -> List[ScanOutputs]:
    """Q group-range probes of one layout over one batch, in one launch."""
    for p in progs:
        _check_batch(p, True)
    return counted_scan_many(progs, batch_words, [], num_docs,
                             SHARDED_PROBE_MANY_COUNTER)


def sharded_fused_scan_many_plain(progs: List[ScanProgram],
                                  batch_words: List[torch.Tensor],
                                  batch_values: List[torch.Tensor],
                                  num_docs: torch.Tensor,
                                  tiles: Optional[int] = None
                                  ) -> List[ScanOutputs]:
    """The query axis's plain version: one plain scan a program (the
    probe's too, with no value columns)."""
    return fused_scan_many_plain(progs, batch_words, batch_values, num_docs,
                                 tiles)


# --------------------------------------------------------------------------
# the jnp combine: the general rung's body over a segment batch
# --------------------------------------------------------------------------

def _segment_cols(cols: Dict[str, Dict[str, torch.Tensor]], s: int
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Segment ``s``'s view of the stacked columns: every per-doc array
    indexed on its leading ``[S]`` axis, the shared ``dictvals`` as is."""
    return {name: {k: (v if k == "dictvals" else v[s])
                   for k, v in tree.items()}
            for name, tree in cols.items()}


def _reduce(leaves: List[torch.Tensor], op: str) -> torch.Tensor:
    """The segments' partials of one leaf, merged (``_local_reduce``)."""
    v = torch.stack(leaves)
    if op == "sum":
        return v.sum(0)
    return v.amin(0) if op == "min" else v.amax(0)


def _neutral(dtype: torch.dtype, op: str):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _sparse_cross_combine(parts: List[Dict[str, Any]],
                          reducers: Dict[str, Tuple[str, ...]], K: int
                          ) -> Dict[str, Any]:
    """Merge the segments' sparse compacts (``_sparse_cross_combine``
    :118): each segment holds its own key set, so the ``[S * K]`` keys are
    sorted, re-grouped into one ``[K]`` compact (``compact_from_sorted``)
    and every leaf scatters by its key's rank. A segment whose compact
    overflowed propagates ``compact_n > K``, so the decode refuses the
    result rather than truncate it."""
    SENT = kernels._SENTINEL_KEY
    keys = torch.cat([p["ck"] for p in parts])
    seg_n = torch.stack([p["compact_n"] for p in parts]).max()
    sk, order = torch.sort(keys, stable=True)
    first, n_live, uniq = kernels.compact_from_sorted(sk, K)
    rank = torch.cumsum(first, 0) - 1
    rank = torch.where((sk != SENT) & (rank < K), rank, K)

    def merge_leaf(leaves: List[torch.Tensor], op: str) -> torch.Tensor:
        v = torch.cat(leaves).index_select(0, order)
        acc = torch.full((K + 1,), _neutral(v.dtype, op), dtype=v.dtype,
                         device=v.device)
        if op == "sum":
            acc.index_add_(0, rank, v)
        else:
            acc.scatter_reduce_(0, rank, v, "amin" if op == "min" else "amax")
        return acc[:K]

    out: Dict[str, Any] = {}
    for key, ops in reducers.items():
        if key == "num_matched":
            continue
        if isinstance(parts[0][key], tuple):
            out[key] = tuple(merge_leaf([p[key][j] for p in parts], op)
                             for j, op in enumerate(ops))
        else:
            out[key] = merge_leaf([p[key] for p in parts], ops[0])
    out["ck"] = uniq
    out["compact_n"] = torch.maximum(n_live, seg_n)
    out["rung"] = torch.stack([p["rung"] for p in parts]).max()
    return out


def batch_body_combine(spec: Tuple, cols: Dict[str, Dict[str, torch.Tensor]],
                       params: Tuple, num_docs: torch.Tensor,
                       sparse_rung: str = "hash") -> torch.Tensor:
    """One pass of the jnp combine of a plan over a staged batch -> one
    packed f64 tensor on the device (``kernels.output_layout(spec, S)``:
    the merged tree, then ``seg_matched`` [S]).

    ``cols`` maps each column to the batch's stacked arrays
    (``StagedBatch.column``), ``params`` are the plan's params on the same
    device, ``num_docs`` [S] int64. The body runs per segment with
    ``doc_offset`` 0; a sparse spec's segments all take ``sparse_rung``
    ("hash" or "sort"), and the packed ``rung`` flags a hash table that
    overflowed in any segment (``combine_to_host`` then runs the sort
    pass). Everything lies on ``num_docs``'s device."""
    device = kernels._check_device(cols, params, num_docs.device)
    sparse_k = kernels.sparse_mode(spec)
    body = kernels.build_kernel_body(spec, sparse_k=sparse_k,
                                     sparse_rung=sparse_rung)
    parts = [body(_segment_cols(cols, s), params, num_docs[s], 0, device)
             for s in range(num_docs.shape[0])]
    reducers = kernels.partial_reduce_ops(spec)
    if sparse_k:
        out = _sparse_cross_combine(parts, reducers, sparse_k)
    else:
        out = {}
        for key, ops in reducers.items():
            if isinstance(parts[0][key], tuple):
                out[key] = tuple(_reduce([p[key][j] for p in parts], op)
                                 for j, op in enumerate(ops))
            else:
                out[key] = _reduce([p[key] for p in parts], ops[0])
    # per-segment matched docs (numSegmentsMatched / numDocsScanned)
    out["seg_matched"] = torch.stack(
        [p["num_matched"] if "num_matched" in p else p["presence"].sum()
         for p in parts])
    return kernels.pack_outputs(out, spec)


def _rung_flag(packed: np.ndarray, spec: Tuple, num_seg: int) -> bool:
    """The packed ``rung`` leaf: some segment's hash table overflowed."""
    off = 0
    for key, size in kernels.output_layout(spec, num_seg):
        if key == "rung":
            return bool(packed[off] > 0)
        off += size
    return False


def combine_to_host(spec: Tuple, cols: Dict[str, Dict[str, torch.Tensor]],
                    params: Tuple, num_docs: torch.Tensor) -> np.ndarray:
    """The jnp combine of one plan over a staged batch, its packed outputs
    on the host: one pass and one device-to-host copy. A sparse spec runs
    the hash pass first; where any segment's hash table overflowed, every
    segment runs the sort pass and its outputs are copied instead (the
    TPU's ``lax.cond`` outside the segment vmap). Counts one call on
    ``BATCH_GENERAL_COUNTER``."""
    BATCH_GENERAL_COUNTER.add()
    S = num_docs.shape[0]
    packed = batch_body_combine(spec, cols, params, num_docs).cpu().numpy()
    if kernels.sparse_mode(spec) and _rung_flag(packed, spec, S):
        packed = batch_body_combine(spec, cols, params, num_docs,
                                    "sort").cpu().numpy()
    return packed
