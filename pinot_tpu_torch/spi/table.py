"""Table indexing config: the indexes a segment is built with.

Counterpart of ``pinot_tpu/spi/table.py`` ``StarTreeIndexConfig`` (:49) and
``IndexingConfig`` (:90-142), cut to the knobs the port's in-memory segment
builder honours (no partition or realtime settings, no JSON round trip).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class StarTreeIndexConfig:
    """One star-tree: the dimensions in split order, the dimensions that
    get no star child, the function-column pairs (``"SUM__revenue"``,
    ``"COUNT__*"``, ``"SUM__a*b"`` for a derived pair) and the record
    count at which a node stops splitting."""

    dimensions_split_order: List[str] = field(default_factory=list)
    skip_star_node_creation_for_dimensions: List[str] = field(
        default_factory=list)
    function_column_pairs: List[str] = field(default_factory=list)
    max_leaf_records: int = 10_000


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
      numeric columns only;
    - ``star_tree_index_configs``: the star-trees built over the segment;
      with none, ``enable_default_star_tree`` builds one over the
      dimensions of bounded cardinality (``segment/convert.py``)."""

    inverted_index_columns: List[str] = field(default_factory=list)
    range_index_columns: List[str] = field(default_factory=list)
    bloom_filter_columns: List[str] = field(default_factory=list)
    fst_index_columns: List[str] = field(default_factory=list)
    text_index_columns: List[str] = field(default_factory=list)
    json_index_columns: List[str] = field(default_factory=list)
    no_dictionary_columns: List[str] = field(default_factory=list)
    star_tree_index_configs: List[StarTreeIndexConfig] = field(
        default_factory=list)
    enable_default_star_tree: bool = False
