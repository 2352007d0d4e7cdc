"""Table indexing config: the indexes a segment is built with.

Counterpart of ``pinot_tpu/spi/table.py`` ``IndexingConfig`` (:90-142),
cut to the knobs the port's in-memory segment builder honours (no star
tree, partition or realtime settings, no JSON round trip).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class IndexingConfig:
    """Column lists per index kind:

    - ``inverted_index_columns``: per-dictId posting lists (dictionary
      columns, single- or multi-value);
    - ``range_index_columns``: the sorted-order permutation of a raw
      single-value column's values;
    - ``bloom_filter_columns``: a bloom filter over the distinct values;
    - ``fst_index_columns``, ``text_index_columns``,
      ``json_index_columns``: the REGEXP_LIKE, TEXT_MATCH and JSON_MATCH
      indexes of single-value string columns;
    - ``no_dictionary_columns``: raw (value) encoding, single-value
      numeric columns only."""

    inverted_index_columns: List[str] = field(default_factory=list)
    range_index_columns: List[str] = field(default_factory=list)
    bloom_filter_columns: List[str] = field(default_factory=list)
    fst_index_columns: List[str] = field(default_factory=list)
    text_index_columns: List[str] = field(default_factory=list)
    json_index_columns: List[str] = field(default_factory=list)
    no_dictionary_columns: List[str] = field(default_factory=list)
