"""Multi-segment combine: one scan over a whole batch, on one card or a
mesh of cells.

Counterpart of ``pinot_tpu/parallel/combine.py``:

- the fused scan (``build_sharded_pallas_kernel`` :298,
  ``build_sharded_pallas_probe`` :360). Without a mesh (plain tensors on
  one device) the CUDA fused-scan kernel runs once over all ``S * T``
  tiles of the batch: every segment adds into the same outputs (the
  batch's unified dictionaries give one group key space), and only the
  matched-doc counts stay per segment. Over a mesh (``parallel/mesh.py``;
  the inputs are ``Cells``) the kernel is launched once a cell, over the
  cell's block of ``S / n_seg`` segments x ``T / n_doc`` tiles, and the
  cells' outputs fold on the mesh's root (``fold_outputs``): the f64 sums
  and the i64 counts and sums add (the kernel's integer rows are i64
  already, where JAX widens its i32 rows before the ``psum``, :331-334),
  the min/max rows take ``amin`` / ``amax``, and the per-segment matched
  counts add over ``doc`` and join over ``seg``. The kernel is unchanged:
  each cell gets its own ``num_docs``, ``clamp(num_docs - doc_base, 0,
  T_l * TILE)`` with ``doc_base = di * T_l * TILE``, where JAX passes
  ``doc_base`` into the kernel (:321-326); the scan reads no doc index
  but its mask, so the two agree. Each wrapper has its own launch
  counter, which adds one a launch, so a mesh of ``n`` cells counts ``n``
  a scan; the kernel is the same as the per-segment path's.
  ``BATCH_KERNELS`` is the pair a staged batch's scans launch through.
  ``sharded_fused_scan_many`` and ``sharded_fused_scan_probe_many`` run Q
  same-layout programs of concurrent queries over one batch in one launch
  a cell (the kernel's query axis; the counterpart of the launcher's
  ``jax.vmap`` over the sharded Pallas call, ``pinot_tpu/parallel/
  launcher.py:92-116``), folded per program, each beside its plain
  version, which takes the same inputs.
- the jnp combine (``build_sharded_kernel`` :192, ``_sparse_cross_combine``
  :118), which serves every plan the fused scan declines over a batch:
  ``batch_body_combine`` runs the general rung's body
  (``engine/kernels.py``) over each segment of each cell on the cell's
  device (with the cell's ``doc_offset`` and local capacity on a mesh),
  merges the partials by ``partial_reduce_ops`` (a sparse group-by
  re-groups the segments' compacts by sort) and packs the merged tree
  with the per-segment matched counts into one f64 tensor;
  ``combine_to_host`` copies it to the host once a query (twice where a
  sparse group-by's hash table overflowed in any cell and the sort pass
  reruns).

``fold_partials`` (``parallel/mesh.py``) does every fold, on one device
too.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pinot_tpu_torch.engine import kernels
from pinot_tpu_torch.engine.fused_scan import (
    R_MAX,
    R_MIN,
    KernelCounter,
    ScanKernels,
    ScanOutputs,
    ScanProgram,
    _alloc_outputs,
    counted_scan,
    counted_scan_many,
    fused_scan_many_plain,
    fused_scan_plain,
)
from pinot_tpu_torch.parallel.mesh import (
    Cells,
    CombineMesh,
    fold_partials,
    fold_seg_matched,
    pad_segments,
)

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


def _check_batch(prog: ScanProgram, probe: bool) -> None:
    if prog.probe != probe:
        raise ValueError("a probe program goes to sharded_fused_scan_probe, "
                         "a full scan to sharded_fused_scan")


def _cell_args(c: int, words, values, num_docs: Cells,
               tiles: Optional[int]):
    """Cell ``c``'s block of a mesh scan's inputs."""
    return ([w[c] for w in words], [v[c] for v in values], num_docs[c],
            tiles // num_docs.mesh.n_doc if tiles else None)


def fold_outputs(prog: ScanProgram, outs: List[ScanOutputs],
                 mesh: CombineMesh) -> ScanOutputs:
    """The cells' scan outputs of one program, folded on the mesh's root
    into the outputs of the whole batch."""
    root = mesh.root
    S_l = outs[0].layout[4]
    out = _alloc_outputs(prog, S_l * mesh.n_seg, root)
    out.cnt.copy_(fold_partials([o.cnt for o in outs], "sum", root))
    if prog.n_isum:
        out.isum.copy_(fold_partials([o.isum for o in outs], "sum", root))
    if prog.n_fsum:
        out.fsum.copy_(fold_partials([o.fsum for o in outs], "sum", root))
    for kind, _e, r in prog.rows:
        if kind in (R_MIN, R_MAX):
            out.mm[r].copy_(fold_partials(
                [o.mm[r] for o in outs], "min" if kind == R_MIN else "max",
                root))
    out.matched.copy_(fold_seg_matched([o.matched for o in outs], mesh))
    return out


def _mesh_scan(prog: ScanProgram, words, values, num_docs: Cells, tiles,
               one) -> ScanOutputs:
    """``one(prog, words, values, num_docs, tiles)`` a cell, folded."""
    outs = [one(prog, *_cell_args(c, words, values, num_docs, tiles))
            for c in range(num_docs.mesh.size)]
    return fold_outputs(prog, outs, num_docs.mesh)


def _mesh_scan_many(progs: List[ScanProgram], words, values,
                    num_docs: Cells, tiles, many) -> List[ScanOutputs]:
    """``many(progs, ...)`` a cell, folded per program."""
    per_cell = [many(progs, *_cell_args(c, words, values, num_docs, tiles))
                for c in range(num_docs.mesh.size)]
    return [fold_outputs(p, [outs[q] for outs in per_cell], num_docs.mesh)
            for q, p in enumerate(progs)]


def sharded_fused_scan(prog: ScanProgram, batch_words: List,
                       batch_values: List, num_docs,
                       tiles: Optional[int] = None) -> ScanOutputs:
    """The fused scan over a segment batch: packed columns ``[S, T, W]``,
    value columns ``[S, T * TILE]``, ``num_docs`` [S] int64 (``tiles`` = T
    when the plan reads no column). Plain tensors: one launch. ``Cells``
    (a mesh): one launch a cell, with each cell's ``num_docs``, folded.
    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version."""
    _check_batch(prog, False)
    if isinstance(num_docs, Cells):
        return _mesh_scan(prog, batch_words, batch_values, num_docs, tiles,
                          lambda *a: counted_scan(*a[:4], SHARDED_SCAN_COUNTER,
                                                  a[4]))
    return counted_scan(prog, batch_words, batch_values, num_docs,
                        SHARDED_SCAN_COUNTER, tiles)


def sharded_fused_scan_probe(prog: ScanProgram, batch_words: List,
                             num_docs) -> ScanOutputs:
    """The group-range probe over a segment batch, one launch (a cell):
    its min/max rows cover every segment."""
    _check_batch(prog, True)
    if isinstance(num_docs, Cells):
        return _mesh_scan(prog, batch_words, [], num_docs, None,
                          lambda p, w, v, nd, t: counted_scan(
                              p, w, v, nd, SHARDED_PROBE_COUNTER))
    return counted_scan(prog, batch_words, [], num_docs,
                        SHARDED_PROBE_COUNTER)


def sharded_fused_scan_plain(prog: ScanProgram, batch_words: List,
                             batch_values: List, num_docs,
                             tiles: Optional[int] = None) -> ScanOutputs:
    """``sharded_fused_scan``'s plain version over the same inputs (the
    probe's too, with no value columns)."""
    if isinstance(num_docs, Cells):
        return _mesh_scan(prog, batch_words, batch_values, num_docs, tiles,
                          fused_scan_plain)
    return fused_scan_plain(prog, batch_words, batch_values, num_docs, tiles)


BATCH_KERNELS = ScanKernels(sharded_fused_scan, sharded_fused_scan_probe,
                            SHARDED_SCAN_COUNTER, SHARDED_PROBE_COUNTER)


def sharded_fused_scan_many(progs: List[ScanProgram], batch_words: List,
                            batch_values: List, num_docs,
                            tiles: Optional[int] = None
                            ) -> List[ScanOutputs]:
    """Q full-scan programs of one layout (``ScanProgram.layout_key``)
    over one segment batch, in one launch of the query axis (a cell): one
    outputs each. CUDA tensors launch the kernel (or raise); CPU tensors
    run ``sharded_fused_scan_many_plain``."""
    for p in progs:
        _check_batch(p, False)
    if isinstance(num_docs, Cells):
        return _mesh_scan_many(
            progs, batch_words, batch_values, num_docs, tiles,
            lambda ps, w, v, nd, t: counted_scan_many(
                ps, w, v, nd, SHARDED_SCAN_MANY_COUNTER, t))
    return counted_scan_many(progs, batch_words, batch_values, num_docs,
                             SHARDED_SCAN_MANY_COUNTER, tiles)


def sharded_fused_scan_probe_many(progs: List[ScanProgram],
                                  batch_words: List, num_docs
                                  ) -> List[ScanOutputs]:
    """Q group-range probes of one layout over one batch, in one launch
    (a cell)."""
    for p in progs:
        _check_batch(p, True)
    if isinstance(num_docs, Cells):
        return _mesh_scan_many(
            progs, batch_words, [], num_docs, None,
            lambda ps, w, v, nd, t: counted_scan_many(
                ps, w, v, nd, SHARDED_PROBE_MANY_COUNTER))
    return counted_scan_many(progs, batch_words, [], num_docs,
                             SHARDED_PROBE_MANY_COUNTER)


def sharded_fused_scan_many_plain(progs: List[ScanProgram],
                                  batch_words: List, batch_values: List,
                                  num_docs, tiles: Optional[int] = None
                                  ) -> List[ScanOutputs]:
    """The query axis's plain version: one plain scan a program (the
    probe's too, with no value columns), a cell over a mesh."""
    if isinstance(num_docs, Cells):
        return _mesh_scan_many(progs, batch_words, batch_values, num_docs,
                               tiles, fused_scan_many_plain)
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


def _neutral(dtype: torch.dtype, op: str):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _sparse_cross_combine(parts: List[Dict[str, Any]],
                          reducers: Dict[str, Tuple[str, ...]], K: int,
                          root: Optional[torch.device] = None
                          ) -> Dict[str, Any]:
    """Merge the segments' sparse compacts on ``root`` (the first part's
    device by default)
    (``_sparse_cross_combine`` :118): each segment holds its own key set,
    so the ``[S * K]`` keys are joined, sorted, re-grouped into one
    ``[K]`` compact (``compact_from_sorted``) and every leaf scatters by
    its key's rank. A segment whose compact overflowed propagates
    ``compact_n > K``, so the decode refuses the result rather than
    truncate it."""
    SENT = kernels._SENTINEL_KEY
    root = parts[0]["ck"].device if root is None else root
    keys = fold_partials([p["ck"] for p in parts], "cat", root)
    seg_n = fold_partials([p["compact_n"] for p in parts], "max", root)
    sk, order = torch.sort(keys, stable=True)
    first, n_live, uniq = kernels.compact_from_sorted(sk, K)
    rank = torch.cumsum(first, 0) - 1
    rank = torch.where((sk != SENT) & (rank < K), rank, K)

    def merge_leaf(leaves: List[torch.Tensor], op: str) -> torch.Tensor:
        v = fold_partials(leaves, "cat", root).index_select(0, order)
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
    out["rung"] = fold_partials([p["rung"] for p in parts], "max", root)
    return out


def batch_body_combine(spec: Tuple, cols, params, num_docs,
                       sparse_rung: str = "hash") -> torch.Tensor:
    """One pass of the jnp combine of a plan over a staged batch -> one
    packed f64 tensor (``kernels.output_layout(spec, S)``: the merged
    tree, then ``seg_matched`` [S]).

    On one device ``cols`` maps each column to the batch's stacked
    arrays (``StagedBatch.column``), ``params`` are the plan's params on
    that device and ``num_docs`` is [S] int64. Over a mesh ``num_docs`` is
    ``Cells`` of each cell's segments' doc counts, and ``cols`` and
    ``params`` are lists of the same, one a cell on its device: the body
    runs with the cell's local capacity (``capacity / n_doc``) and
    ``doc_offset``. A sparse spec's segments all take ``sparse_rung``
    ("hash" or "sort"), and the packed ``rung`` flags a hash table that
    overflowed in any segment (``combine_to_host`` then runs the sort
    pass). The result lies on the mesh's root (or the one device)."""
    if isinstance(num_docs, Cells):
        mesh: Optional[CombineMesh] = num_docs.mesh
        cells = list(zip(cols, params, num_docs))
        root, n_doc = mesh.root, mesh.n_doc
    else:
        mesh = None
        cells = [(cols, params, num_docs)]
        root, n_doc = num_docs.device, 1
    local_cap = spec[-1] // n_doc
    sparse_k = kernels.sparse_mode(spec)
    body = kernels.build_kernel_body(
        spec, capacity_override=local_cap if n_doc > 1 else 0,
        sparse_k=sparse_k, sparse_rung=sparse_rung)
    parts: List[Dict[str, Any]] = []
    rows: List[torch.Tensor] = []
    for c, (cc, cp, nd) in enumerate(cells):
        device = kernels._check_device(cc, cp, nd.device)
        offset = (c % n_doc) * local_cap
        mine = [body(_segment_cols(cc, s), cp, nd[s], offset, device)
                for s in range(nd.shape[0])]
        parts += mine
        # per-segment matched docs (numSegmentsMatched / numDocsScanned)
        rows.append(torch.stack(
            [p["num_matched"] if "num_matched" in p
             else p["presence"].sum() for p in mine]))
    reducers = kernels.partial_reduce_ops(spec)
    if sparse_k:
        out = _sparse_cross_combine(parts, reducers, sparse_k, root)
    else:
        out = {}
        for key, ops in reducers.items():
            if isinstance(parts[0][key], tuple):
                out[key] = tuple(fold_partials([p[key][j] for p in parts],
                                               op, root)
                                 for j, op in enumerate(ops))
            else:
                out[key] = fold_partials([p[key] for p in parts], ops[0],
                                         root)
    out["seg_matched"] = (rows[0] if mesh is None
                          else fold_seg_matched(rows, mesh))
    return kernels.pack_outputs(out, spec)


def _rung_flag(packed: np.ndarray, spec: Tuple, num_seg: int) -> bool:
    """The packed ``rung`` leaf: some segment's hash table overflowed."""
    off = 0
    for key, size in kernels.output_layout(spec, num_seg):
        if key == "rung":
            return bool(packed[off] > 0)
        off += size
    return False


def combine_to_host(spec: Tuple, cols, params, num_docs) -> np.ndarray:
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
