"""Theta sketch: mergeable approximate distinct counting with set algebra.

Counterpart of ``pinot_tpu/utils/theta.py`` (a copy: the port imports
nothing of the JAX package).

Re-design of the reference's theta-sketch aggregations
(``DistinctCountThetaSketchAggregationFunction`` over the DataSketches
library): a KMV (k minimum values) theta sketch — keep the k smallest 64-bit
hashes seen; theta is the (k+1)-th smallest (as a fraction of hash space),
retained hashes stay strictly below it, and the distinct estimate is
``retained / theta`` once sampling kicks in.

TPU-shaped on purpose: updates are vectorized numpy (hash -> sort -> trim),
and merge is a concatenate + k-smallest trim — both expressible as on-device
sort/top-k if sketch building ever moves into a kernel. Unlike the
DataSketches binary layout, serialization here is a simple header + the
sorted retained hashes (u64 little-endian); set operations (union /
intersection / a-not-b) follow the standard theta algebra.
"""

from __future__ import annotations

import struct
from typing import Any, Sequence

import numpy as np

from pinot_tpu_torch.utils.hll import hash_values

DEFAULT_NOMINAL_ENTRIES = 4096  # ref: the DataSketches default (2^12)

_MAX_HASH = float(1 << 64)


def _below(hashes: np.ndarray, theta: float) -> np.ndarray:
    """The hashes under ``theta`` of the hash space."""
    if theta >= 1.0:
        return hashes
    return hashes[hashes < np.uint64(int(theta * _MAX_HASH))]


class ThetaSketch:
    """KMV theta sketch over 64-bit hashes."""

    def __init__(self, nominal_entries: int = DEFAULT_NOMINAL_ENTRIES,
                 hashes: np.ndarray = None, theta: float = 1.0):
        if nominal_entries < 1:
            raise ValueError("nominal_entries must be >= 1")
        self.k = int(nominal_entries)
        # sorted unique uint64 hashes, all strictly below theta * 2^64
        self.hashes = (np.empty(0, dtype=np.uint64) if hashes is None
                       else hashes)
        self.theta = float(theta)

    # -- building ----------------------------------------------------------
    def add_values(self, values: Sequence[Any]) -> "ThetaSketch":
        if len(values):
            self._absorb(hash_values(values))
        return self

    def _absorb(self, new_hashes: np.ndarray) -> None:
        merged = np.unique(np.concatenate([self.hashes, new_hashes]))
        self._trim(merged)

    def _trim(self, sorted_hashes: np.ndarray) -> None:
        limit = np.uint64(int(self.theta * _MAX_HASH)) \
            if self.theta < 1.0 else None
        if limit is not None:
            sorted_hashes = sorted_hashes[sorted_hashes < limit]
        if sorted_hashes.size > self.k:
            # theta drops to the (k+1)-th smallest: retained stay below it
            cut = sorted_hashes[self.k]
            self.theta = float(cut) / _MAX_HASH
            sorted_hashes = sorted_hashes[:self.k]
        self.hashes = sorted_hashes

    # -- set algebra (ref: theta sketch union/intersection/aNotB) ----------
    def merge(self, other: "ThetaSketch") -> "ThetaSketch":
        """Union (in place); theta = min(thetas), retained trimmed to k."""
        self.theta = min(self.theta, other.theta)
        merged = np.unique(np.concatenate([self.hashes, other.hashes]))
        self._trim(merged)
        return self

    def intersect(self, other: "ThetaSketch") -> "ThetaSketch":
        """Intersection (a new sketch): theta = min(thetas), the hashes
        both retain below it."""
        theta = min(self.theta, other.theta)
        common = np.intersect1d(self.hashes, other.hashes)
        return ThetaSketch(self.k, _below(common, theta), theta)

    def a_not_b(self, other: "ThetaSketch") -> "ThetaSketch":
        """Difference (a new sketch): theta = min(thetas), the hashes this
        sketch retains and ``other`` does not, below it."""
        theta = min(self.theta, other.theta)
        kept = np.setdiff1d(self.hashes, other.hashes)
        return ThetaSketch(self.k, _below(kept, theta), theta)

    def estimate(self) -> float:
        if self.theta >= 1.0:
            return float(self.hashes.size)  # exact below k
        # standard theta estimator: retained / theta (every retained hash is
        # strictly below theta by construction after _trim, so no -1 term —
        # the (k-1)/theta form applies to theta = k-th smallest, not ours)
        return self.hashes.size / self.theta if self.hashes.size else 0.0

    # -- wire ----------------------------------------------------------------
    def serialize(self) -> bytes:
        return (struct.pack("<IdI", self.k, self.theta, self.hashes.size)
                + self.hashes.astype("<u8").tobytes())

    @classmethod
    def deserialize(cls, raw: bytes) -> "ThetaSketch":
        k, theta, n = struct.unpack_from("<IdI", raw, 0)
        hashes = np.frombuffer(raw, dtype="<u8", count=n, offset=16).copy()
        return cls(k, hashes, theta)

    @classmethod
    def of(cls, values: Sequence[Any],
           nominal_entries: int = DEFAULT_NOMINAL_ENTRIES) -> "ThetaSketch":
        return cls(nominal_entries).add_values(values)
