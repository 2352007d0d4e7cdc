"""Bloom filter over a column's distinct values, for segment pruning.

Counterpart of ``pinot_tpu/utils/bloom.py``, copied so the port imports
nothing of the JAX package: a bit array probed ``k`` times with
Kirsch-Mitzenmacher double hashing of the 64-bit ``hash_values`` hash,
built in one vectorized pass. The sizing, hashing and bits equal the JAX
package's, so both prune the same segments.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np

from pinot_tpu_torch.utils.hll import hash_values

DEFAULT_FPP = 0.05
MAX_BITS = 1 << 23  # 1 MiB cap per column filter


class BloomFilter:
    def __init__(self, bits: np.ndarray, num_hashes: int):
        self.bits = bits  # uint64 words
        self.num_hashes = num_hashes
        self.num_bits = bits.shape[0] * 64

    @classmethod
    def from_values(cls, values: Sequence[Any],
                    fpp: float = DEFAULT_FPP) -> "BloomFilter":
        n = max(len(values), 1)
        m = int(-n * math.log(fpp) / (math.log(2) ** 2))
        m = min(max(64, -(-m // 64) * 64), MAX_BITS)
        k = max(1, round(m / n * math.log(2)))
        bits = np.zeros(m // 64, dtype=np.uint64)
        h = hash_values(list(values))
        h1 = h
        h2 = (h >> np.uint64(17)) | (h << np.uint64(47))
        for i in range(k):
            idx = (h1 + np.uint64(i) * h2) % np.uint64(m)
            np.bitwise_or.at(bits, (idx >> np.uint64(6)).astype(np.int64),
                             np.uint64(1) << (idx & np.uint64(63)))
        return cls(bits, k)

    def might_contain(self, value: Any) -> bool:
        # python-int arithmetic: uint64 wraparound without numpy warnings
        h = int(hash_values([value])[0])
        mask64 = (1 << 64) - 1
        h1 = h
        h2 = ((h >> 17) | (h << 47)) & mask64
        for i in range(self.num_hashes):
            idx = ((h1 + i * h2) & mask64) % self.num_bits
            if not (int(self.bits[idx >> 6]) >> (idx & 63)) & 1:
                return False
        return True

    def to_array(self) -> np.ndarray:
        """The filter as one uint64 array: ``[k, words...]``."""
        return np.concatenate([np.asarray([self.num_hashes], dtype=np.uint64),
                               self.bits])

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "BloomFilter":
        """``to_array``'s inverse (a ``bloom.npy`` of a segment on disk)."""
        arr = np.asarray(arr, dtype=np.uint64)
        return cls(arr[1:].copy(), int(arr[0]))
