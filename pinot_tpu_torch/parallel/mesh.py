"""The combine mesh: a ``seg x doc`` grid of device cells, and the fold.

Counterpart of ``pinot_tpu/parallel/combine.py`` ``make_combine_mesh``
(:80), ``SEG_AXIS`` / ``DOC_AXIS`` (:40-41) and ``pad_segments`` (:286).
A multi-segment query's batch is split over the ``seg`` axis (each row of
cells holds ``S / n_seg`` segments) and each segment's tiles over the
``doc`` axis (each column of cells holds ``T / n_doc`` tiles); a cell is
a ``torch.device``, and cells may repeat a device (several cells sharing
one card run one after another on it). ``Cells`` is a batch-wide tensor
held as one block a cell, each on its cell's device.

The fold across cards. Where the JAX package merges the cells' partials
with ``psum`` / ``pmin`` / ``pmax`` and ``all_gather`` inside one
``shard_map`` program, the port copies each cell's partials to the mesh's
root device (its first cell) with ``Tensor.to(root, non_blocking=True)``
and folds them there with PyTorch ops (``fold_partials``). On a host
whose cards are joined by NVLink that copy is a peer copy; where cells
share a card nothing moves. This is the only path, whatever the layout.
It departs from NCCL through ``torch.distributed`` on purpose:
``torch.distributed`` needs a process a card, and the port's executor,
like JAX's single-controller mesh, is one process driving every card.
The partials are sized by groups, not docs (a few MB at most: SSB Q3.2's
slot space), so the copies are small next to the scan. The fold runs on
the root only; the JAX mesh replicates the merged result on every
device, which nothing here reads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

SEG_AXIS = "seg"
DOC_AXIS = "doc"


def pad_segments(n: int, n_seg: int) -> int:
    """Segments padded up to a multiple of the seg-axis size."""
    return ((n + n_seg - 1) // n_seg) * n_seg


def _cell_device(d: Union[str, torch.device]) -> torch.device:
    """A cell's device, indexed; a CUDA cell on a missing card raises."""
    dev = torch.device(d)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh cell {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh cell {dev} requested but "
                           "torch.cuda.is_available() is False")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh cell {dev}: this host has "
                           f"{torch.cuda.device_count()} cards")
    return torch.device("cuda", index)


class CombineMesh:
    """``n_seg x n_doc`` cells, row-major: cell ``c = si * n_doc + di``
    holds segment block ``si`` and tile block ``di``."""

    def __init__(self, cells: Sequence[Union[str, torch.device]],
                 n_seg: int, n_doc: int):
        if n_seg < 1 or n_doc < 1 or len(cells) != n_seg * n_doc:
            raise ValueError(f"{len(cells)} cells do not make a "
                             f"{n_seg}x{n_doc} mesh")
        self.cells: Tuple[torch.device, ...] = tuple(_cell_device(c)
                                                     for c in cells)
        self.n_seg = n_seg
        self.n_doc = n_doc
        self.shape = {SEG_AXIS: n_seg, DOC_AXIS: n_doc}

    @property
    def size(self) -> int:
        return len(self.cells)

    @property
    def root(self) -> torch.device:
        """Where the cells' partials fold: the first cell's device."""
        return self.cells[0]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices of the cells, in cell order."""
        return tuple(dict.fromkeys(self.cells))

    @property
    def key(self) -> str:
        """The mesh's identity: the root device's name for one cell (a
        single device's), else its shape and cells."""
        if self.size == 1:
            return str(self.root)
        return (f"{self.n_seg}x{self.n_doc}["
                + ",".join(str(c) for c in self.cells) + "]")

    def __repr__(self) -> str:
        return f"CombineMesh({self.key})"


def make_combine_mesh(devices: Optional[Sequence] = None,
                      doc_shards: int = 1) -> CombineMesh:
    """Mesh over every visible card (or ``devices``): segments over
    ``seg``, the doc dimension over ``doc``. ``doc_shards`` must divide
    the cell count. With no ``devices`` a host without a card raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_combine_mesh() takes every visible "
                               "CUDA card and this host has none; pass "
                               "devices= (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if n == 0 or doc_shards < 1 or n % doc_shards:
        raise ValueError(f"doc_shards {doc_shards} !| {n} devices")
    return CombineMesh(devices, n // doc_shards, doc_shards)


def single_cell(device: Union[str, torch.device]) -> CombineMesh:
    """The 1x1 mesh on one device: the batch path of one card."""
    return CombineMesh([device], 1, 1)


class Cells:
    """A batch-wide tensor of logical ``shape`` as one block a cell: the
    segment axis (dim 0) split over ``seg`` and the doc axis (dim 1 of a
    batch array) over ``doc``, block ``c`` on cell ``c``'s device."""

    __slots__ = ("mesh", "blocks", "shape")

    def __init__(self, mesh: CombineMesh, blocks: List[torch.Tensor],
                 shape: Tuple[int, ...]):
        if len(blocks) != mesh.size:
            raise ValueError(f"{len(blocks)} blocks for {mesh.size} cells")
        self.mesh = mesh
        self.blocks = blocks
        self.shape = tuple(shape)

    def reshape(self, *shape: int) -> "Cells":
        """The same blocks: a block-split tensor takes no reshape but the
        one that keeps its logical shape (``engine/fused_scan.py``'s
        staging reshapes a batch's columns to ``[S, -1, ...]``)."""
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        total = 1
        for s in self.shape:
            total *= s
        want = tuple(total // known if s == -1 else s for s in shape)
        if want != self.shape:
            raise ValueError(f"a mesh's blocks keep their shape "
                             f"{self.shape}, not {want}")
        return self

    def __getitem__(self, c: int) -> torch.Tensor:
        return self.blocks[c]

    def __len__(self) -> int:
        return len(self.blocks)

    def __iter__(self):
        return iter(self.blocks)

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.blocks)


def fold_partials(parts: Sequence[torch.Tensor], op: str,
                  root: torch.device) -> torch.Tensor:
    """The cells' partials of one output, copied to ``root`` and folded
    there: ``op`` "sum", "min" or "max" over the parts, or "cat" to join
    them in order. A part on ``root`` is not copied."""
    moved = [p.to(root, non_blocking=True) for p in parts]
    if op == "cat":
        return torch.cat(moved)
    if len(moved) == 1:
        return moved[0]
    v = torch.stack(moved)
    if op == "sum":
        return v.sum(0)
    if op == "min":
        return v.amin(0)
    if op == "max":
        return v.amax(0)
    raise ValueError(f"no fold {op!r}")


def fold_seg_matched(rows: Sequence[torch.Tensor],
                     mesh: CombineMesh) -> torch.Tensor:
    """Per-segment matched-doc counts of the whole batch from each cell's
    ``[S / n_seg]`` row: summed over ``doc``, joined over ``seg``."""
    per_seg = [fold_partials([rows[si * mesh.n_doc + di]
                              for di in range(mesh.n_doc)], "sum", mesh.root)
               for si in range(mesh.n_seg)]
    return fold_partials(per_seg, "cat", mesh.root)


__all__ = ["CombineMesh", "Cells", "DOC_AXIS", "SEG_AXIS", "fold_partials",
           "fold_seg_matched", "make_combine_mesh", "pad_segments",
           "single_cell"]
