"""HyperLogLog register arithmetic, frozen for the reference.

A copy of the sketch the system states (log2m = 8 registers; a value's
64-bit hash is FNV-1a over its UTF-8 bytes for a string, the integer itself
for an int, finished by the splitmix64 mixer; the register is the hash's
top log2m bits, the rank the leading zeros of the rest plus one; the
estimate is the standard one with the small and large range corrections).
It is kept here so that the reference never calls the program's own sketch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

LOG2M = 8
_M64 = 0xFFFFFFFFFFFFFFFF


def _mix(x: int) -> int:
    """splitmix64's finalizer on a 64-bit word."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def hash_value(v) -> int:
    if isinstance(v, (int, np.integer)):
        return _mix(int(v) & _M64)
    h = 0xCBF29CE484222325
    for b in str(v).encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & _M64
    return _mix(h)


def register_of(h: int, log2m: int = LOG2M) -> Tuple[int, int]:
    """(register index, rank) of one hash."""
    idx = h >> (64 - log2m)
    rest = (h << log2m) & _M64
    width = 64 - log2m
    for r in range(1, width + 1):
        if rest >> 63:
            return idx, r
        rest = (rest << 1) & _M64
    return idx, width + 1


def register_luts(values: Sequence, log2m: int = LOG2M
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(register [n], rank [n]) for each value."""
    pairs = [register_of(hash_value(v), log2m) for v in values]
    return (np.array([p[0] for p in pairs], dtype=np.int64),
            np.array([p[1] for p in pairs], dtype=np.int64))


def cardinality(registers: np.ndarray) -> int:
    m = registers.shape[0]
    regs = registers.astype(np.float64)
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    est = alpha * m * m / np.sum(np.exp2(-regs))
    if est <= 2.5 * m:
        zeros = int(np.count_nonzero(registers == 0))
        if zeros:
            est = m * np.log(m / zeros)
    elif est > (1 << 32) / 30.0:
        est = -(1 << 32) * np.log(1.0 - est / (1 << 32))
    return int(round(est))
