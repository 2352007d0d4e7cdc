"""The broker's group-by merge on the card, as PyTorch ops.

Counterpart of ``pinot_tpu/parallel/reduce_device.py``, which is
``jax.jit`` over ``shard_map`` and jnp (not Pallas). When the servers'
tables never crossed a wire, the concatenated (keys, states) block of a
group-by merges on the device instead of the host lexsort; the host then
only restores insertion order, trims, orders and boxes the output
(``broker/reduce.py``).

- Keys encode to one non-negative i64 composite a row
  (``encode_composite_keys``): injective codes (first-occurrence ranks
  for strings, ``np.unique`` ranks for f64, an offset from the minimum for
  i64), so equal rows and only equal rows collide.
- The block is padded to ``_merge_cap`` rows with inert pads (a dropped
  slot, or the pad key, and each fold's identity).
- **Dense rung** (composite space <= ``DENSE_SLOTS``): each state is
  scattered into ``space`` slots, ``index_add_`` for a sum or count and
  ``scatter_reduce_`` (``amin`` / ``amax``) for a min or max, and the
  ``amin`` of the arrival index marks the live slots (a slot no row
  touched keeps the i32 maximum).
- **Sort rung** (larger spaces): one stable sort of the composite keys,
  first-occurrence run boundaries, a rank per row, and each state folded
  by its run's rank.

The merge runs over the broker merge mesh (JAX ``broker_mesh`` :77): a
tuple of devices, every visible card by default (``broker_mesh()``,
cached; a host without a card raises) or the caller's. The padded rows
are cut into one shard a device, each copied to its device. On the dense
rung each device scatters its shard into the full slot space; at or
under ``_PSUM_SLOTS`` slots the partials fold on the root (the first
device) with ``parallel/mesh.py`` ``fold_partials``, where JAX all-reduces
them (``_axis_reduce`` :187); above it the slice exchange (JAX
``_slice_reduce`` :203): device j receives slice j of every partial,
padded with the fold's identity, folds it, and the root joins the slices.
On the sort rung the shards gather on the root and one argsort runs
there, where JAX all-gathers them and runs the argsort on every device
(:279). The partials move with ``Tensor.to``: a peer copy between cards,
nothing where the devices are one (``parallel/mesh.py`` says why not
``torch.distributed``). A failed merge raises. Only order-independent
folds reach it (the caller declines non-integral or large f64 sums, i64
sums near overflow, NaN keys and object states), so the merged states
are bit-identical to the host fold's whatever order the devices add
them in.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.common.bounds import (
    F64_EXACT_INT_BOUND,
    I64_KEY_SPACE_BOUND,
    I64_PAD_SENTINEL,
)
from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine.fused_scan import KernelCounter
from pinot_tpu_torch.parallel.mesh import fold_partials
from pinot_tpu_torch.spi.config import CommonConstants

# composite keys are non-negative and < I64_KEY_SPACE_BOUND, so i64 max
# sorts strictly after every live key
_PAD_KEY = I64_PAD_SENTINEL

# the dense rung's slot budget and the padded-row ceiling (spi/config.py)
DENSE_SLOTS = CommonConstants.DEFAULT_DEVICE_REDUCE_DENSE_SLOTS
MAX_MERGE_ROWS = CommonConstants.DEFAULT_DEVICE_REDUCE_MAX_ROWS

# dense slot spaces at or under this many slots fold on the root; larger
# ones take the slice exchange, each device folding one slice
_PSUM_SLOTS = 1 << 12

_I32_MAX = int(np.iinfo(np.int32).max)

_MESH: Optional[Tuple[torch.device, ...]] = None

# calls of the merge (one a group-by the device route serves)
MERGE_COUNTER = KernelCounter("device_group_merge")


def encode_composite_keys(key_cols: List[np.ndarray]
                          ) -> Tuple[Optional[np.ndarray], int]:
    """Concatenated key columns -> (one non-negative i64 composite a row,
    the composite space), or ``(None, 0)`` when the space cannot fit the
    i64 budget (the caller declines ``reduce_device_key_space_overflow``).
    The codes need only be injective: the caller restores insertion order
    from the earliest row of each group, so code order never reaches the
    output. NaN keys never reach here (declined before)."""
    n = int(key_cols[0].shape[0]) if key_cols else 0
    comp = np.zeros(n, dtype=np.int64)
    space = 1
    for a in key_cols:
        if a.dtype.kind == "i":
            lo = int(a.min())
            r = int(a.max()) - lo + 1
            codes = a.astype(np.int64) - lo
        elif a.dtype.kind == "f":
            _, inv = np.unique(a, return_inverse=True)
            codes = inv.astype(np.int64).reshape(n)
            r = int(codes.max()) + 1 if n else 1
        else:
            lut: Dict = {}
            codes = np.fromiter(
                (lut.setdefault(v, len(lut)) for v in a.tolist()),
                dtype=np.int64, count=n)
            r = len(lut) if n else 1
        if r < 1 or space > I64_KEY_SPACE_BOUND // r:
            return None, 0
        comp = comp * r + codes
        space *= r
    return comp, space


def f64_sum_exact(arr: np.ndarray) -> bool:
    """True when folding ``arr`` is order-independent in f64: finite,
    integral and of total absolute mass under 2^53 (every partial sum is
    then an exactly representable integer)."""
    if not bool(np.isfinite(arr).all()):
        return False
    if not bool((arr == np.floor(arr)).all()):
        return False
    return float(np.abs(arr).sum()) < F64_EXACT_INT_BOUND


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def broker_mesh(devices: Optional[Sequence] = None
                ) -> Tuple[torch.device, ...]:
    """The broker merge mesh: ``devices``, or (cached) every visible card;
    a host without a card raises."""
    global _MESH
    if devices is not None:
        return tuple(resolve_device(d) for d in devices)
    if _MESH is None:
        if not torch.cuda.is_available():
            raise RuntimeError("broker_mesh() takes every visible cuda card "
                               "and torch.cuda.is_available() is False; "
                               "pass devices=")
        _MESH = tuple(torch.device("cuda", i)
                      for i in range(torch.cuda.device_count()))
    return _MESH


def _merge_cap(n: int, n_dev: int = 1) -> int:
    """Padded row capacity: ``n`` rounded up to the next multiple of
    ``next_pow2(n) / 8`` (at most 8 capacities a power of two, and a pad
    tail under 12.5%), and of ``n_dev``, the merge mesh's size."""
    step = max(_next_pow2(n) // 8, n_dev, 1)
    return -(-max(n, 1) // step) * step


def _pad_identity(arr: np.ndarray, op: str):
    """The fold's identity for the pad tail (pads land in a dropped slot
    either way; the identity keeps them inert even there)."""
    if op == "sum":
        return 0
    if arr.dtype.kind == "i":
        info = np.iinfo(arr.dtype)
        return info.max if op == "min" else info.min
    return np.inf if op == "min" else -np.inf


def _fold(vals: torch.Tensor, slot: torch.Tensor, slots: int, op: str,
          identity) -> torch.Tensor:
    """``vals`` folded by ``op`` into ``slots`` slots at ``slot``."""
    out = torch.full((slots,), identity, dtype=vals.dtype,
                     device=vals.device)
    if op == "sum":
        return out.index_add_(0, slot, vals)
    return out.scatter_reduce_(0, slot, vals,
                               "amin" if op == "min" else "amax")


def _slice_exchange(parts: List[torch.Tensor], op: str, identity,
                    mesh: Tuple[torch.device, ...]) -> torch.Tensor:
    """The devices' ``[m]`` slot partials folded by slices (JAX
    ``_slice_reduce``): each padded with ``identity`` to a multiple of the
    mesh's size, device j folds slice j of every partial, the root joins
    the slices."""
    n_dev, m = len(mesh), int(parts[0].shape[0])
    w = -(-m // n_dev)
    padded = [torch.cat((p, torch.full((w * n_dev - m,), identity,
                                       dtype=p.dtype, device=p.device)))
              for p in parts]
    slices = [fold_partials([p[j * w:(j + 1) * w] for p in padded], op, d)
              for j, d in enumerate(mesh)]
    return fold_partials(slices, "cat", mesh[0])[:m]


def device_group_merge(comp: np.ndarray, space: int, vals: List[np.ndarray],
                       ops: List[str],
                       device: Union[str, torch.device, Sequence] = "cuda"
                       ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Merge the concatenated group-by block over ``device``: one device,
    or a merge mesh (a sequence of devices, ``broker_mesh``).

    -> ``(first_idx, folded)``: per merged group, in ascending composite
    order, the earliest input row and one folded state array per
    aggregation (``ops[i]`` in sum / min / max), the contract of the host
    path's ``lexsort_runs`` + ``fold_grouped_runs`` + ``order[starts]``.
    """
    mesh = (broker_mesh(device) if isinstance(device, (list, tuple))
            else (resolve_device(device),))
    root, n_dev = mesh[0], len(mesh)
    n = int(comp.shape[0])
    cap = _merge_cap(n, n_dev)
    rung = merge_rung(space)
    comp_p = np.full(cap, space if rung == "dense" else _PAD_KEY,
                     dtype=np.int64)
    comp_p[:n] = comp
    idx_p = np.full(cap, _I32_MAX, dtype=np.int32)
    idx_p[:n] = np.arange(n, dtype=np.int32)
    vals_p = []
    for v, op in zip(vals, ops):
        vp = np.full(cap, _pad_identity(v, op), dtype=v.dtype)
        vp[:n] = v
        vals_p.append(vp)
    # one shard of the padded rows a device
    cuts = [j * cap // n_dev for j in range(n_dev + 1)]

    def shards(a: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(a[cuts[j]:cuts[j + 1]]).to(d)
                for j, d in enumerate(mesh)]

    keys, idx = shards(comp_p), shards(idx_p)
    vals_d = [shards(vp) for vp in vals_p]
    MERGE_COUNTER.add()
    if rung == "dense":
        # pads carry comp == space: one extra slot swallows them; each
        # device scatters its shard into the whole slot space
        def fold(parts: List[torch.Tensor], op: str, identity):
            if n_dev > 1 and space > _PSUM_SLOTS:
                return _slice_exchange(parts, op, identity, mesh)
            return fold_partials(parts, op, root)

        min_idx = fold([_fold(i, k, space + 1, "min", _I32_MAX)[:space]
                        for i, k in zip(idx, keys)], "min", _I32_MAX)
        live = torch.nonzero(min_idx < _I32_MAX).squeeze(1)
        first = min_idx[live]
        leaves = []
        for vd, a, op in zip(vals_d, vals, ops):
            ident = _pad_identity(a, op)
            leaves.append(fold([_fold(v, k, space + 1, op, ident)[:space]
                                for v, k in zip(vd, keys)], op, ident)[live])
    else:
        # the shards gather on the root, which sorts them once
        kk = fold_partials(keys, "cat", root)
        sk, order = torch.sort(kk, stable=True)
        valid = sk != _PAD_KEY
        head = torch.ones(1, dtype=torch.bool, device=root)
        starts = valid & torch.cat((head, sk[1:] != sk[:-1]))
        rank = torch.cumsum(starts, 0) - 1
        rank = torch.where(valid, rank, torch.full_like(rank, cap))
        k = int(starts.sum())
        first = _fold(fold_partials(idx, "cat", root)[order], rank, cap + 1,
                      "min", _I32_MAX)[:k]
        leaves = [_fold(fold_partials(vd, "cat", root)[order], rank, cap + 1,
                        op, _pad_identity(a, op))[:k]
                  for vd, a, op in zip(vals_d, vals, ops)]
    first_idx = first.cpu().numpy().astype(np.int64)
    folded = [lf.cpu().numpy() for lf in leaves]
    return first_idx, folded


def merge_rung(space: int) -> str:
    """The rung ``device_group_merge`` takes for a composite space."""
    return "dense" if space <= DENSE_SLOTS else "sort"


__all__ = ["DENSE_SLOTS", "MAX_MERGE_ROWS", "MERGE_COUNTER", "broker_mesh",
           "device_group_merge", "encode_composite_keys", "f64_sum_exact",
           "merge_rung"]
