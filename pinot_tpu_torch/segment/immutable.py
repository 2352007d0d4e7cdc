"""Immutable in-memory segment + per-column DataSource access.

Counterpart of ``pinot_tpu/segment/immutable.py``. Every array is
``padded_capacity`` rows long, zeros past ``num_docs``:

- single-value dictionary column: ``forward_index`` holds dictIds;
- raw single-value column: ``forward_index`` holds the values, in the
  data type's stored dtype, and there is no dictionary;
- multi-value column (always dictionary-encoded): ``forward_index`` is the
  dense ``[capacity, max(max_num_multi_values, 1)]`` dictId matrix the JAX
  package's ``dense_mv()`` builds from its flat forward index (zeros past
  each row's count), with ``mv_counts`` the values per row;
- ``null_bitmap``: rows that are null (a null MV row stores the null
  default as its one value, as the JAX creator does), or None.

An upsert-managed segment carries ``valid_doc_ids``, a bool array over its
docs: only its true docs are live. ``star_trees`` holds the segment's
star-trees (``segment/startree.py``) in memory, in config order (the JAX
segment loads them from disk at first use, :273-281).

A column built with indexes (``convert.py``, ``spi/table.py``) reads them
here with the semantics of ``pinot_tpu/segment/immutable.py`` (:80-213):
``inverted_index`` and ``doc_ids_for_dict_id`` (the postings),
``range_order`` and ``range_sorted_values`` (a raw column's sorted-order
permutation), ``bloom_filter``, ``fst_index``, ``text_index`` and
``json_index``; each is None where the column has no such index.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.metadata import ColumnMetadata, SegmentMetadata


@dataclass
class ColumnIndexes:
    """A column's in-memory indexes (None: not built)."""

    # (doc-count offsets [cardinality + 1] int64, docIds int32): dictId
    # i's ascending docs at [offsets[i]:offsets[i + 1]]
    inverted: Optional[Tuple[np.ndarray, np.ndarray]] = None
    # [num_docs] int32 docs in ascending value order (raw column)
    range_order: Optional[np.ndarray] = None
    bloom: Any = None     # utils.bloom.BloomFilter
    fst: Any = None       # segment.fstindex.FstIndexReader
    text: Any = None      # segment.textindex.TextIndexReader
    json: Any = None      # segment.jsonindex.JsonIndexReader

    def any(self) -> bool:
        return any(v is not None for v in (self.inverted, self.range_order,
                                           self.bloom, self.fst, self.text,
                                           self.json))


class DataSource:
    """One column's read access: metadata, dictionary (None for a raw
    column), forward index, MV counts, null bitmap and indexes."""

    def __init__(self, name: str, metadata: ColumnMetadata,
                 dictionary: Optional[Dictionary], forward_index: np.ndarray,
                 mv_counts: Optional[np.ndarray] = None,
                 null_bitmap: Optional[np.ndarray] = None,
                 indexes: Optional[ColumnIndexes] = None):
        self.name = name
        self.metadata = metadata
        self.dictionary = dictionary
        self.forward_index = forward_index
        self.mv_counts = mv_counts
        self.null_bitmap = null_bitmap
        ix = indexes or ColumnIndexes()
        self.inverted_index = ix.inverted
        self.range_order = ix.range_order
        self.bloom_filter = ix.bloom
        self.fst_index = ix.fst
        self.text_index = ix.text
        self.json_index = ix.json

    def doc_ids_for_dict_id(self, dict_id: int) -> np.ndarray:
        """Ascending int32 docIds holding ``dict_id`` (its postings)."""
        inv = self.inverted_index
        if inv is None:
            raise ValueError(f"no inverted index on column {self.name!r}")
        offsets, docs = inv
        return docs[int(offsets[dict_id]):int(offsets[dict_id + 1])]

    @cached_property
    def range_sorted_values(self) -> Optional[np.ndarray]:
        """The values in sorted order, gathered once: a RANGE lookup is a
        binary search and a slice of ``range_order``."""
        order = self.range_order
        if order is None:
            return None
        return np.asarray(self.forward_index[:order.shape[0]])[order]

    def dense_mv(self) -> Tuple[np.ndarray, np.ndarray]:
        """(dictIds [capacity, max_mv] int32, counts [capacity] int32) of a
        multi-value column: the JAX package's ``DataSource.dense_mv``."""
        if self.metadata.single_value:
            raise ValueError(f"column {self.name!r} is single-value")
        return self.forward_index, self.mv_counts


class ImmutableSegment:
    def __init__(self, metadata: SegmentMetadata,
                 sources: Dict[str, DataSource]):
        cap = metadata.padded_capacity
        for name, ds in sources.items():
            fwd = ds.forward_index
            cm = ds.metadata
            ok = (fwd.shape == (cap,) if cm.single_value
                  else fwd.ndim == 2 and fwd.shape[0] == cap
                  and ds.mv_counts is not None
                  and ds.mv_counts.shape == (cap,))
            if not ok or (ds.null_bitmap is not None
                          and ds.null_bitmap.shape != (cap,)):
                raise ValueError(f"column {name!r}: arrays do not span the "
                                 f"padded capacity {cap}")
        self.metadata = metadata
        self._sources = sources
        self.valid_doc_ids = None
        self.star_trees: List[Any] = []

    @property
    def segment_name(self) -> str:
        return self.metadata.segment_name

    @property
    def num_docs(self) -> int:
        return self.metadata.num_docs

    @property
    def padded_capacity(self) -> int:
        return self.metadata.padded_capacity

    def data_source(self, name: str) -> DataSource:
        try:
            return self._sources[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in segment "
                           f"{self.segment_name!r}") from None
