"""Immutable in-memory segment + per-column DataSource access.

Counterpart of ``pinot_tpu/segment/immutable.py``. Every column is
dictionary-encoded and single-value; its forward index is a numpy array of
dictIds, ``padded_capacity`` long (zeros past ``num_docs``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.metadata import ColumnMetadata, SegmentMetadata


class DataSource:
    """One column's read access: metadata, dictionary and forward index."""

    def __init__(self, name: str, metadata: ColumnMetadata,
                 dictionary: Dictionary, forward_index: np.ndarray):
        self.name = name
        self.metadata = metadata
        self.dictionary = dictionary
        self.forward_index = forward_index


class ImmutableSegment:
    def __init__(self, metadata: SegmentMetadata,
                 sources: Dict[str, DataSource]):
        for name, ds in sources.items():
            if ds.forward_index.shape != (metadata.padded_capacity,):
                raise ValueError(
                    f"column {name!r}: forward index shape "
                    f"{ds.forward_index.shape} != ({metadata.padded_capacity},)")
        self.metadata = metadata
        self._sources = sources

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
