"""HyperLogLog: the approximate distinct-count sketch.

Counterpart of ``pinot_tpu/utils/hll.py``, copied so the port imports
nothing of the JAX package: a numpy register array (default log2m = 8)
with vectorized 64-bit hashing. Per-dictId (bucket, rank) tables
(``dictionary_register_luts``) turn register updates into a masked
scatter-max on the device, and register merge is an elementwise max.
Hashes, registers and estimates equal the JAX package's bit for bit.

Serialized form: log2m byte + raw registers (bytes), stable across the wire.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

import numpy as np

DEFAULT_LOG2M = 8  # ref: CommonConstants.Helix.DEFAULT_HYPERLOGLOG_LOG2M


def _hash64(values: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit mix (splitmix64 finalizer) over int64 input."""
    x = values.astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def hash_values(values: Sequence[Any]) -> np.ndarray:
    """Arbitrary python/numpy values -> uint64 hashes (strings/bytes via
    FNV-1a; numerics via splitmix64)."""
    arr = np.asarray(values)
    if arr.dtype.kind in ("i", "u"):
        return _hash64(arr.astype(np.int64))
    if arr.dtype.kind == "f":
        return _hash64(arr.astype(np.float64).view(np.int64))
    out = np.empty(len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        data = v if isinstance(v, bytes) else str(v).encode("utf-8")
        h = 0xCBF29CE484222325
        for b in data:
            h = (h ^ b) * 0x100000001B3 & 0xFFFFFFFFFFFFFFFF
        out[i] = h
    # FNV-1a avalanches poorly in the high bits (which HLL uses for the
    # register index); finish with the splitmix64 mixer
    return _hash64(out.view(np.int64))


def register_updates(hashes: np.ndarray, log2m: int):
    """(register index, rank) per hash — the HLL update decomposed so the
    device path can precompute per-dictId (bucket, rank) lookup tables and
    turn register updates into a masked scatter-max on device (the same
    max-merge shape as dictId presence; see engine/kernels.py)."""
    idx = (hashes >> np.uint64(64 - log2m)).astype(np.int64)
    rest = hashes << np.uint64(log2m)
    # rank = leading zeros of the remaining bits + 1 (capped)
    width = 64 - log2m
    rank = np.full(hashes.shape, width + 1, dtype=np.int32)
    bits = rest
    found = np.zeros(hashes.shape, dtype=bool)
    for r in range(1, width + 1):
        top = (bits >> np.uint64(63)).astype(bool)
        newly = top & ~found
        rank[newly] = r
        found |= top
        bits = bits << np.uint64(1)
        if found.all():
            break
    return idx, rank


def dictionary_register_luts(values, log2m: int = DEFAULT_LOG2M):
    """(bucket [card] i32, rank [card] i32) for a dictionary's values —
    the device HLL's plan-time parameters."""
    idx, rank = register_updates(hash_values(list(values)), log2m)
    return idx.astype(np.int32), rank.astype(np.int32)


class HyperLogLog:
    def __init__(self, log2m: int = DEFAULT_LOG2M,
                 registers: Optional[np.ndarray] = None):
        self.log2m = log2m
        self.m = 1 << log2m
        self.registers = (registers if registers is not None
                          else np.zeros(self.m, dtype=np.uint8))

    # -- updates -------------------------------------------------------------
    def add_hashes(self, hashes: np.ndarray) -> None:
        if hashes.size == 0:
            return
        idx, rank = register_updates(hashes, self.log2m)
        np.maximum.at(self.registers, idx, rank.astype(np.uint8))

    def add_values(self, values: Sequence[Any]) -> None:
        self.add_hashes(hash_values(values))

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if other.log2m != self.log2m:
            raise ValueError("cannot merge HLLs with different log2m")
        return HyperLogLog(self.log2m,
                           np.maximum(self.registers, other.registers))

    # -- estimate (standard HLL with small/large range corrections) ----------
    def cardinality(self) -> int:
        m = self.m
        regs = self.registers.astype(np.float64)
        alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(
            m, 0.7213 / (1 + 1.079 / m))
        est = alpha * m * m / np.sum(np.exp2(-regs))
        if est <= 2.5 * m:
            zeros = int(np.count_nonzero(self.registers == 0))
            if zeros:
                est = m * np.log(m / zeros)
        elif est > (1 << 32) / 30.0:
            est = -(1 << 32) * np.log(1.0 - est / (1 << 32))
        return int(round(est))

    # -- serde (wire state) --------------------------------------------------
    def serialize(self) -> bytes:
        return bytes([self.log2m]) + self.registers.tobytes()

    @classmethod
    def deserialize(cls, raw: bytes) -> "HyperLogLog":
        if not raw:
            raise ValueError("empty HyperLogLog payload")
        log2m = raw[0]
        if len(raw) != 1 + (1 << log2m):
            raise ValueError(
                f"HyperLogLog payload length {len(raw)} != 1 + 2^{log2m}")
        regs = np.frombuffer(raw[1:], dtype=np.uint8).copy()
        return cls(log2m, regs)

    @classmethod
    def of(cls, values: Sequence[Any],
           log2m: int = DEFAULT_LOG2M) -> "HyperLogLog":
        h = cls(log2m)
        h.add_values(values)
        return h
