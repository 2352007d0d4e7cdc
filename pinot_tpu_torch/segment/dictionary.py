"""Per-column sorted dictionaries.

Counterpart of ``pinot_tpu/segment/dictionary.py``. Values are sorted
ascending, so dictId order is value order and a range predicate becomes a
dictId interval. Both kinds hold a sorted numpy array: numeric values in the
type's stored dtype, strings as a numpy unicode array (code-point order,
which is the byte order of their UTF-8 encoding).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.spi.data import DataType
from pinot_tpu_torch.utils.hll import dictionary_register_luts


class Dictionary:
    def __init__(self, values: np.ndarray, data_type: DataType):
        if values.ndim != 1:
            raise ValueError("dictionary values must be one-dimensional")
        self._values = values
        self.data_type = data_type
        self._hll_luts: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return int(self._values.shape[0])

    @property
    def cardinality(self) -> int:
        return len(self)

    @property
    def values(self) -> np.ndarray:
        return self._values

    def insertion_index_of(self, value: Any) -> int:
        """dictId of ``value``, or ``-(insertion_point + 1)`` when absent."""
        i = int(np.searchsorted(self._values, value))
        if i < len(self) and self._values[i] == value:
            return i
        return -(i + 1)

    def index_of(self, value: Any) -> int:
        """value -> dictId, or -1 when absent."""
        i = self.insertion_index_of(value)
        return i if i >= 0 else -1

    def get_value(self, dict_id: int) -> Any:
        return self._values[int(dict_id)].item()

    def get_values(self, dict_ids: Sequence[int]) -> List[Any]:
        return self._values[np.asarray(dict_ids, dtype=np.int64)].tolist()

    @property
    def min_value(self) -> Any:
        return self.get_value(0)

    @property
    def max_value(self) -> Any:
        return self.get_value(len(self) - 1)

    def device_values(self) -> Optional[np.ndarray]:
        """The sorted value array of a numeric dictionary (dictId -> value
        gather when staging value columns); None for strings."""
        return self._values if self.data_type.is_numeric else None

    def hll_register_luts(self, log2m: int) -> Tuple[np.ndarray, np.ndarray]:
        """Memoized (bucket, rank) int32 register tables over this
        dictionary's values: the device HLL's plan-time parameters (string
        hashing is a Python loop, so it is paid once per dictionary)."""
        luts = self._hll_luts.get(log2m)
        if luts is None:
            luts = dictionary_register_luts(self.get_values(range(len(self))),
                                            log2m)
            self._hll_luts[log2m] = luts
        return luts

    def range_to_dict_id_interval(self, lo: Any, hi: Any, lo_inclusive: bool,
                                  hi_inclusive: bool) -> Tuple[int, int]:
        """Value range -> closed dictId interval [a, b] (empty iff a > b)."""
        n = len(self)
        if lo is None:
            a = 0
        else:
            idx = self.insertion_index_of(lo)
            if idx >= 0:
                a = idx if lo_inclusive else idx + 1
            else:
                a = -idx - 1
        if hi is None:
            b = n - 1
        else:
            idx = self.insertion_index_of(hi)
            if idx >= 0:
                b = idx if hi_inclusive else idx - 1
            else:
                b = -idx - 2
        return a, b


def encode_strings(values: Sequence[Any]) -> Tuple[np.ndarray, np.ndarray]:
    """Strings as the JAX package stores them on disk: (int64 byte offsets
    [n + 1], uint8 blob of their UTF-8 bytes in turn)."""
    encoded = [v if isinstance(v, bytes) else str(v).encode("utf-8")
               for v in values]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    if encoded:
        offsets[1:] = np.cumsum([len(e) for e in encoded])
    blob = np.frombuffer(b"".join(encoded), dtype=np.uint8).copy()
    return offsets, blob


def decode_strings(offsets: np.ndarray, blob: np.ndarray) -> List[str]:
    """``encode_strings``'s inverse."""
    raw = np.asarray(blob, dtype=np.uint8).tobytes()
    off = np.asarray(offsets, dtype=np.int64).tolist()
    return [raw[off[i]:off[i + 1]].decode("utf-8")
            for i in range(len(off) - 1)]


def build_dictionary(sorted_unique_values: Sequence[Any],
                     data_type: DataType) -> Dictionary:
    if data_type.is_numeric:
        arr = np.asarray(sorted_unique_values, dtype=data_type.stored_np)
    else:
        arr = np.asarray([str(v) for v in sorted_unique_values], dtype=np.str_)
    if arr.size > 1 and not bool(np.all(arr[:-1] < arr[1:])):
        raise ValueError("dictionary values must be sorted and unique")
    return Dictionary(arr, data_type)
