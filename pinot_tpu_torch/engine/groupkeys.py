"""Composite group-key encode/decode of the host group-by.

Counterpart of ``pinot_tpu/engine/groupkeys.py`` (``compose_group_keys``).
A key space no larger than the rows is factorised with ``np.bincount``
(linear) where the JAX package sorts with ``np.unique``: the outputs are
the same arrays.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np


def compose_group_keys(code_arrays: Sequence[np.ndarray],
                       cardinalities: Sequence[int]
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  Callable[[int], Tuple[int, ...]]]:
    """Pack per-column integer codes into one int64 key per row.

    Returns (unique_keys, group_id_per_row, decode) where ``decode`` maps a
    packed key back to the per-column code tuple. Cardinalities are the
    per-column key-space sizes (the packing strides).

    When the product of cardinalities would overflow int64, falls back to
    tuple keys via lexicographic np.unique over the stacked code columns
    (the reference's map/array-based generator past the long-key limit,
    DictionaryBasedGroupKeyGenerator cardinality ladder).
    """
    cards = [int(c) for c in cardinalities]

    key_space = 1
    for card in cards:
        key_space *= max(card, 1)
    if key_space >= 2 ** 63:
        stacked = np.stack([np.asarray(c, dtype=np.int64)
                            for c in code_arrays], axis=1)
        uniq_rows, gid = np.unique(stacked, axis=0, return_inverse=True)
        uniq = np.arange(len(uniq_rows), dtype=np.int64)

        def decode(key: int) -> Tuple[int, ...]:
            return tuple(int(p) for p in uniq_rows[int(key)])

        return uniq, gid.ravel(), decode

    combined = np.asarray(code_arrays[0], dtype=np.int64)
    for codes, card in zip(code_arrays[1:], cardinalities[1:]):
        combined = combined * int(card) + np.asarray(codes, dtype=np.int64)
    uniq, gid = unique_inverse(combined, key_space)

    def decode(key: int) -> Tuple[int, ...]:
        parts = []
        for card in reversed(cards[1:]):
            parts.append(key % card)
            key //= card
        parts.append(key)
        return tuple(int(p) for p in reversed(parts))

    return uniq, gid, decode


def unique_inverse(codes: np.ndarray, space: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(codes, return_inverse=True)`` of non-negative int codes
    below ``space``: by counting when the space is no larger than the
    codes, by sorting otherwise."""
    codes = np.asarray(codes)
    if space > max(codes.size, 1 << 16):
        uniq, inv = np.unique(codes, return_inverse=True)
        return uniq, inv.ravel()
    present = np.bincount(codes, minlength=space) > 0
    uniq = np.flatnonzero(present)
    rank = np.cumsum(present) - 1
    return uniq.astype(codes.dtype, copy=False), rank[codes]
