"""Named numeric-exactness bounds: the constants that license device and
vectorized sums.

Counterpart of ``pinot_tpu/common/bounds.py`` (a copy). Every exactness
guard of the broker reduce and its device merge compares against one of
these named constants, never a raw ``1 << 62`` / ``1 << 53`` literal.
"""

from __future__ import annotations

# i64 fold headroom: a signed-64 accumulator overflows at 2^63, so any
# fold whose total absolute mass stays strictly under 2^62 keeps a 2x
# margin under the overflow line.
I64_FOLD_BOUND = 1 << 62

# f64 exact-integer bound: float64 carries a 53-bit mantissa, so every
# integer with |v| < 2^53 is exactly representable and integral partial
# sums under this mass are order-independent (the device's scatter order
# may differ from the host's reduceat order without changing a bit).
F64_EXACT_INT_BOUND = float(1 << 53)

# composite-key space budget: group-by key columns encode injectively into
# one non-negative i64 composite per row; capping the space strictly under
# 2^62 keeps every live code below the pad sentinel.
I64_KEY_SPACE_BOUND = 1 << 62

# i64 max as the pad key: live composite keys are non-negative and below
# I64_KEY_SPACE_BOUND, so it sorts strictly after every live key on the
# device merge's sort rung.
I64_PAD_SENTINEL = (1 << 63) - 1
