"""Carry segments across as plain arrays.

``segment_from_arrays`` builds a port segment from per-column numpy arrays:
a dictionary column's sorted values and dictIds (dense dictIds plus counts
per row for a multi-value column), a raw column's values, a null bitmap,
and the segment's upsert valid-doc snapshot. It plays the role weights play
in a model port: the tests take these arrays out of a segment the JAX
package built (``columns_of`` reads any segment with the
``metadata.columns`` / ``data_source(c)`` interface: ``dictionary``,
``forward_index``, ``dense_mv()``, ``null_bitmap``), so both packages scan
identical data.

``indexing`` (``spi/table.py`` ``IndexingConfig``) builds a column's
indexes in memory from its dictIds and values, as the JAX creator builds
them (``pinot_tpu/segment/creator.py``): inverted postings
(``build_inverted_index``), the range permutation of a raw column, the
bloom filter, and the FST, text and JSON indexes of a string column.
``is_sorted`` is computed for every single-value column. Its star-tree
configs (or, with none, ``enable_default_star_tree``) build the segment's
star-trees from the built columns, as the JAX creator's
``_build_star_trees`` does (:178-275). ``star_trees_of`` reads a segment's
trees (a port segment's or one the JAX package loaded) as plain arrays,
and ``segment_from_arrays(..., star_trees=)`` attaches such trees instead
of building them, so both packages read byte-identical trees.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.segment.dictionary import Dictionary, build_dictionary
from pinot_tpu_torch.segment.fstindex import FstIndexBuilder, FstIndexReader
from pinot_tpu_torch.segment.immutable import (
    ColumnIndexes,
    DataSource,
    ImmutableSegment,
)
from pinot_tpu_torch.segment.jsonindex import JsonIndexReader, build_json_index
from pinot_tpu_torch.segment.metadata import (
    ColumnMetadata,
    SegmentMetadata,
    pad_capacity,
)
from pinot_tpu_torch.segment.startree import (
    StarTree,
    StarTreeBuilder,
    StarTreeConfig,
    derived_pair_expr,
)
from pinot_tpu_torch.segment.textindex import TextIndexReader, build_text_index
from pinot_tpu_torch.spi.data import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.spi.table import IndexingConfig
from pinot_tpu_torch.utils.bloom import BloomFilter


@dataclass
class ColumnArrays:
    """One column's arrays, each ``num_docs`` (or ``padded_capacity``) rows.

    - dictionary column: ``dictionary`` (sorted unique values) and
      ``dict_ids`` ([rows] dictIds; for a multi-value column the dense
      [rows, max values] dictIds, zero past each row's ``mv_counts``);
    - raw single-value numeric column: ``values``, no dictionary;
    - ``null``: [rows] bool, the rows that are null (they hold the null
      default value).
    ``min_value`` / ``max_value`` are checked against the data when given;
    ``partition_function``, ``num_partitions`` and ``partitions`` are the
    column's partition metadata, carried as given.
    """

    data_type: DataType
    field_type: FieldType
    dictionary: Optional[np.ndarray] = None
    dict_ids: Optional[np.ndarray] = None
    min_value: Any = None
    max_value: Any = None
    values: Optional[np.ndarray] = None
    mv_counts: Optional[np.ndarray] = None
    null: Optional[np.ndarray] = None
    partition_function: Optional[str] = None
    num_partitions: int = 0
    partitions: Optional[List[int]] = None


def _narrow_id_dtype(cardinality: int) -> np.dtype:
    if cardinality <= (1 << 8):
        return np.dtype(np.uint8)
    if cardinality <= (1 << 16):
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def _rows(col: str, arr: np.ndarray, num_docs: int, capacity: int
          ) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.shape[0] not in (num_docs, capacity):
        raise ValueError(f"column {col!r}: {arr.shape[0]} rows for "
                         f"{num_docs} docs")
    return arr[:num_docs]


def _padded(live: np.ndarray, capacity: int, dtype) -> np.ndarray:
    out = np.zeros((capacity,) + live.shape[1:], dtype=dtype)
    out[:live.shape[0]] = live
    return out


def build_inverted_index(dict_ids_flat: np.ndarray,
                         mv_counts: Optional[np.ndarray], num_docs: int,
                         cardinality: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per dictId, the ascending docIds holding it (JAX
    ``creator.py:82``): -> (doc-count offsets [cardinality + 1] int64,
    docIds int32, dictId ``i``'s at ``[offsets[i]:offsets[i + 1]]``). A
    multi-value column's ``dict_ids_flat`` holds each row's values in
    turn (``mv_counts`` of them); a value a row holds twice lists the doc
    twice, as in the JAX index."""
    if mv_counts is None:
        doc_ids = np.arange(num_docs, dtype=np.int64)
        ids = np.asarray(dict_ids_flat[:num_docs])
    else:
        doc_ids = np.repeat(np.arange(num_docs, dtype=np.int64), mv_counts)
        ids = np.asarray(dict_ids_flat)
    # docs ascend in input order, so a stable sort by dictId is the JAX
    # index's lexsort by (dictId, doc)
    order = np.argsort(ids, kind="stable")
    offsets = np.zeros(cardinality + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(ids.astype(np.int64),
                                        minlength=cardinality))
    return offsets, doc_ids[order].astype(np.int32)


def _is_sorted(live: np.ndarray) -> bool:
    return bool(np.all(live[:-1] <= live[1:])) if live.shape[0] > 1 else True


def _indexes(col: str, a: ColumnArrays, cfg: IndexingConfig,
             d: Optional[Dictionary], live: np.ndarray,
             counts: Optional[np.ndarray], num_docs: int
             ) -> Optional[ColumnIndexes]:
    """The indexes ``cfg`` asks of this column, built from its dictIds
    (``live``: [num_docs] dictIds, or the flat entries of a multi-value
    column, or a raw column's values). None when it asks for none."""
    ix = ColumnIndexes()
    if d is None:
        if col in cfg.range_index_columns and num_docs:
            ix.range_order = np.argsort(live, kind="stable").astype(np.int32)
        if col in cfg.bloom_filter_columns:
            ix.bloom = BloomFilter.from_values(list(np.unique(live)))
        return ix if ix.any() else None
    card = d.cardinality
    if col in cfg.inverted_index_columns:
        ix.inverted = build_inverted_index(live, counts, num_docs, card)
    if col in cfg.bloom_filter_columns:
        ix.bloom = BloomFilter.from_values(d.get_values(range(card)))
    single_string = counts is None and not a.data_type.is_numeric
    if single_string and col in cfg.fst_index_columns:
        ix.fst = FstIndexReader(*FstIndexBuilder(
            [str(v) for v in d.get_values(range(card))]).build(), d)
    if single_string and col in cfg.text_index_columns:
        ix.text = TextIndexReader(*build_text_index(d.get_values(
            range(card))), card, value_of=d.get_value)
    if single_string and col in cfg.json_index_columns:
        ix.json = JsonIndexReader(*build_json_index(
            d.values[live].tolist(), num_docs), num_docs)
    return ix if ix.any() else None


def _column(col: str, a: ColumnArrays, num_docs: int, capacity: int,
            indexing: Optional[IndexingConfig] = None) -> DataSource:
    null = None
    if a.null is not None:
        null = _padded(_rows(col, a.null, num_docs, capacity).astype(bool),
                       capacity, bool)
    mv_counts = None
    max_mv = 0
    if a.dictionary is None:
        if a.values is None or a.mv_counts is not None \
                or not a.data_type.is_numeric:
            raise ValueError(f"column {col!r}: a raw column is single-value "
                             "numeric values")
        live = _rows(col, a.values, num_docs, capacity).astype(
            a.data_type.stored_np)
        d = None
        card = int(np.unique(live).shape[0])
        lo = live.min().item() if num_docs else None
        hi = live.max().item() if num_docs else None
        fwd = _padded(live, capacity, live.dtype)
        entries = live
        counts = None
        is_sorted = _is_sorted(live)
    else:
        d = build_dictionary(a.dictionary, a.data_type)
        card = d.cardinality
        ids = _rows(col, a.dict_ids, num_docs, capacity)
        counts = None
        if a.mv_counts is None:
            entries = ids
            fwd = _padded(ids, capacity, _narrow_id_dtype(card))
            is_sorted = _is_sorted(ids)
        else:
            is_sorted = False
            counts = _rows(col, a.mv_counts, num_docs, capacity).astype(
                np.int32)
            max_mv = int(counts.max()) if num_docs else 0
            ids = ids[:, :max(max_mv, 1)]
            entries = ids[np.arange(ids.shape[1])[None, :] < counts[:, None]]
            fwd = _padded(ids, capacity, np.int32)
            mv_counts = _padded(counts, capacity, np.int32)
        if entries.size and (int(entries.min()) < 0
                             or int(entries.max()) >= card):
            raise ValueError(f"column {col!r}: dictId outside [0, {card})")
        lo = d.min_value if card else None
        hi = d.max_value if card else None
    for given, derived, what in ((a.min_value, lo, "min"),
                                 (a.max_value, hi, "max")):
        if given is not None and given != derived:
            raise ValueError(f"column {col!r}: {what} stat {given!r} "
                             f"disagrees with the data ({derived!r})")
    ix = (_indexes(col, a, indexing, d, entries, counts, num_docs)
          if indexing is not None else None)
    cm = ColumnMetadata(
        name=col, data_type=a.data_type, field_type=a.field_type,
        cardinality=card, min_value=lo, max_value=hi,
        has_dictionary=d is not None, single_value=a.mv_counts is None,
        has_nulls=bool(null is not None and null.any()),
        max_num_multi_values=max_mv,
        partition_function=a.partition_function,
        num_partitions=a.num_partitions,
        partitions=list(a.partitions or []),
        is_sorted=is_sorted)
    if ix is not None:
        cm.has_inverted_index = ix.inverted is not None
        cm.has_range_index = ix.range_order is not None
        cm.has_bloom_filter = ix.bloom is not None
        cm.has_fst_index = ix.fst is not None
        cm.has_text_index = ix.text is not None
        cm.has_json_index = ix.json is not None
    return DataSource(col, cm, d, fwd, mv_counts,
                      null if cm.has_nulls else None, indexes=ix)


def segment_from_arrays(name: str, num_docs: int,
                        columns: Mapping[str, ColumnArrays],
                        table_name: Optional[str] = None,
                        valid_doc_ids: Optional[np.ndarray] = None,
                        indexing: Optional[IndexingConfig] = None,
                        star_trees: Optional[Sequence[Dict[str, Any]]] = None
                        ) -> ImmutableSegment:
    """``valid_doc_ids`` ([num_docs] bool) makes the segment
    upsert-managed: only its true docs are live. ``indexing`` names the
    columns' indexes and the star-trees to build; ``star_trees`` (as
    ``star_trees_of`` gives them) are attached instead of the configured
    trees."""
    capacity = pad_capacity(num_docs)
    table = table_name or name
    schema = Schema(table, [FieldSpec(c, a.data_type, a.field_type,
                                      single_value=a.mv_counts is None)
                            for c, a in columns.items()])
    sources = {col: _column(col, a, num_docs, capacity, indexing)
               for col, a in columns.items()}
    md = SegmentMetadata(segment_name=name, table_name=table, schema=schema,
                         num_docs=num_docs, padded_capacity=capacity,
                         columns={c: ds.metadata for c, ds in sources.items()})
    seg = ImmutableSegment(md, sources)
    if valid_doc_ids is not None:
        seg.valid_doc_ids = _rows("valid_doc_ids", valid_doc_ids, num_docs,
                                  capacity).astype(bool)
    if star_trees is not None:
        attach_star_trees(seg, star_trees)
    elif indexing is not None:
        seg.star_trees = _build_star_trees(seg, indexing)
        md.star_tree_count = len(seg.star_trees)
    return seg


def attach_star_trees(seg: ImmutableSegment,
                      trees: Sequence[Dict[str, Any]]) -> None:
    """Give the segment these trees (as ``star_trees_of`` gives them)."""
    seg.star_trees = [StarTree(StarTreeConfig.from_dict(t["config"]),
                               t["dims"], dict(t["metrics"]), t["nodes"])
                      for t in trees]
    seg.metadata.star_tree_count = len(seg.star_trees)


def _star_tree_configs(seg: ImmutableSegment, cfg: IndexingConfig
                       ) -> List[StarTreeConfig]:
    configs = [StarTreeConfig.from_spi(c) for c in cfg.star_tree_index_configs]
    if cfg.enable_default_star_tree and not configs:
        default = _default_star_tree_config(seg.metadata)
        if default is not None:
            configs = [default]
    return configs


def _build_star_trees(seg: ImmutableSegment, cfg: IndexingConfig
                      ) -> List[StarTree]:
    """The configured trees over the segment's built columns; a tree
    whose dimension is not a dictionary single-value column, or whose
    metric is not a numeric single-value column, is skipped with a
    warning (JAX ``creator.py:178``). Build seconds go to the metadata."""
    md = seg.metadata
    n = md.num_docs
    trees: List[StarTree] = []
    build_s: List[float] = []
    for tc in _star_tree_configs(seg, cfg):
        try:
            dim_ids = {}
            for d in tc.dimensions_split_order:
                cm = md.columns[d]
                if not (cm.has_dictionary and cm.single_value):
                    raise ValueError(f"dimension {d} must be a "
                                     "dict-encoded SV column")
                dim_ids[d] = np.asarray(
                    seg.data_source(d).forward_index[:n]).astype(np.int32)
            metric_vals: Dict[str, np.ndarray] = {}
            for _fn, col in tc.function_column_pairs:
                if col == "*":
                    continue
                expr = derived_pair_expr(col)
                for c in (expr.columns() if expr is not None else [col]):
                    if c in metric_vals:
                        continue
                    cm = md.columns[c]
                    if not (cm.single_value and cm.data_type.is_numeric):
                        raise ValueError(f"metric {c} must be a numeric "
                                         "SV column")
                    ds = seg.data_source(c)
                    fwd = np.asarray(ds.forward_index[:n])
                    metric_vals[c] = (ds.dictionary.values[fwd]
                                      if cm.has_dictionary else fwd)
            t0 = time.perf_counter()
            trees.append(StarTreeBuilder(tc).build(dim_ids, metric_vals, n))
            build_s.append(round(time.perf_counter() - t0, 4))
        except (ValueError, KeyError) as e:
            logging.getLogger(__name__).warning(
                "skipping star-tree for %s: %s", md.segment_name, e)
    md.star_tree_build_s = build_s
    return trees


def _default_star_tree_config(md: SegmentMetadata
                              ) -> Optional[StarTreeConfig]:
    """``enable_default_star_tree`` (JAX ``creator.py:258``): the
    dictionary single-value dimensions of cardinality 2 to 10 000 by
    descending cardinality, COUNT(*) and SUM of every numeric
    single-value metric."""
    dims = [(cm.cardinality, name) for name, cm in md.columns.items()
            if cm.has_dictionary and cm.single_value
            and cm.field_type is not FieldType.METRIC
            and 1 < cm.cardinality <= 10_000]
    if not dims:
        return None
    split = [n for _, n in sorted(dims, reverse=True)]
    pairs = [("count", "*")]
    for name, cm in md.columns.items():
        if cm.field_type is FieldType.METRIC and cm.data_type.is_numeric \
                and cm.single_value:
            pairs.append(("sum", name))
    return StarTreeConfig(split, pairs, max_leaf_records=10_000)


def star_trees_of(segment) -> List[Dict[str, Any]]:
    """Per star-tree of a segment (a port segment or one loaded by the
    JAX package): ``config`` (``StarTreeConfig.to_dict``), ``dims``,
    ``nodes`` and ``metrics`` as numpy arrays (not copied)."""
    return [{"config": t.config.to_dict(), "dims": np.asarray(t.dims),
             "nodes": np.asarray(t.nodes),
             "metrics": {k: np.asarray(v) for k, v in t.metrics.items()}}
            for t in getattr(segment, "star_trees", None) or []]


def columns_of(segment) -> Dict[str, ColumnArrays]:
    """Per-column arrays of a segment (a port segment or one loaded by the
    JAX package), in the order of its schema's fields."""
    n = segment.num_docs
    out: Dict[str, ColumnArrays] = {}
    # in the schema's field order, which ``SELECT *`` lists
    order = {c: i for i, c in
             enumerate(segment.metadata.schema.column_names)}
    for col, cm in sorted(segment.metadata.columns.items(),
                          key=lambda kv: order.get(kv[0], len(order))):
        ds = segment.data_source(col)
        dt = DataType.from_string(cm.data_type.label)
        a = ColumnArrays(data_type=dt,
                         field_type=FieldType(cm.field_type.value),
                         min_value=cm.min_value, max_value=cm.max_value,
                         partition_function=cm.partition_function,
                         num_partitions=cm.num_partitions,
                         partitions=list(cm.partitions))
        if not cm.has_dictionary:
            a.values = np.asarray(ds.forward_index)[:n]
        else:
            a.dictionary = np.asarray(
                ds.dictionary.get_values(range(cm.cardinality)),
                dtype=dt.stored_np if dt.is_numeric else np.str_)
            if cm.single_value:
                a.dict_ids = np.asarray(ds.forward_index)[:n]
            else:
                dense, counts = ds.dense_mv()
                a.dict_ids = np.asarray(dense)[:n]
                a.mv_counts = np.asarray(counts)[:n]
        if ds.null_bitmap is not None:
            a.null = np.asarray(ds.null_bitmap)[:n]
        out[col] = a
    return out
