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
star-trees (``segment/startree.py``) in config order.

A column built with indexes (``convert.py``, ``spi/table.py``) reads them
here with the semantics of ``pinot_tpu/segment/immutable.py`` (:80-213):
``inverted_index`` and ``doc_ids_for_dict_id`` (the postings),
``range_order`` and ``range_sorted_values`` (a raw column's sorted-order
permutation), ``bloom_filter``, ``fst_index``, ``text_index``,
``json_index`` and ``geo_index`` (``segment/geoindex.py``); each is None
where the column has no such index.

``load_segment(dir)`` reads a segment directory in the JAX package's
layout (``segment/creator.py`` writes it; JAX :38-213, :320-336) into the
same ``ImmutableSegment``, so staging, residency, the pruner and every rung
take it unchanged. At load every file the metadata names is mapped
(``native.MmapBuffer``, ``native.load_npy``; no copy, no descriptor kept
open), so a segment whose directory is deleted afterwards still reads.
Each ``startree<i>/`` directory is opened and its files mapped at load too
(``StarTreeFiles``); the trees are decoded from those maps at first use,
so a directory written again under the same name (replaced whole, by
rename) leaves a loaded segment with the trees it was loaded with.
Each column's arrays are made at first use and kept: a packed forward
index is unpacked on the host (and narrowed to the dictIds' dtype, as the
in-memory builder stores them), a compressed one decompressed, a
multi-value column made the dense ``[capacity, k]`` matrix with
``mv_counts``, a numeric dictionary copied, and the indexes read from
their files (never rebuilt). A raw column's values, the null bitmap, the
range permutation and the FST arrays stay read-only maps of the files.
``segment_dir`` names the directory (None for a segment built in memory),
the star-trees load at first use (JAX :272-282), and ``verify_crc``
recomputes the CRC-32 of ``columns/`` against the metadata's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.segment.dictionary import (
    Dictionary,
    build_dictionary,
    decode_strings,
)
from pinot_tpu_torch.segment.metadata import (
    METADATA_FILE,
    ColumnMetadata,
    SegmentMetadata,
)

COLUMNS_DIR = "columns"


def narrow_id_dtype(cardinality: int) -> np.dtype:
    """The dtype a single-value column's dictIds are held in."""
    if cardinality <= (1 << 8):
        return np.dtype(np.uint8)
    if cardinality <= (1 << 16):
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


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
    geo: Any = None       # segment.geoindex.GeoIndexReader

    def any(self) -> bool:
        return any(v is not None for v in (self.inverted, self.range_order,
                                           self.bloom, self.fst, self.text,
                                           self.json, self.geo))


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
        self.geo_index = ix.geo

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
                 sources: Dict[str, DataSource],
                 segment_dir: Optional[str] = None,
                 tree_files: Optional[List[Any]] = None):
        cap = metadata.padded_capacity
        for name, ds in sources.items():
            if isinstance(ds, _DiskDataSource):
                continue        # checked when its arrays are made
            _check_spans(name, ds, cap)
        self.metadata = metadata
        self._sources = sources
        self.segment_dir = segment_dir
        self.valid_doc_ids = None
        # a loaded segment's mapped tree files (``StarTreeFiles``), decoded
        # into ``star_trees`` at first use
        self._tree_files = tree_files
        self._star_trees: Optional[List[Any]] = (
            None if tree_files is not None else [])

    @property
    def segment_name(self) -> str:
        return self.metadata.segment_name

    @property
    def num_docs(self) -> int:
        return self.metadata.num_docs

    @property
    def padded_capacity(self) -> int:
        return self.metadata.padded_capacity

    @property
    def star_trees(self) -> List[Any]:
        """The star-trees; a loaded segment decodes the tree files it
        mapped at load at first use."""
        trees = self._star_trees
        if trees is None:
            trees = [f.decode() for f in self._tree_files]
            self._star_trees = trees
        return trees

    @star_trees.setter
    def star_trees(self, trees: List[Any]) -> None:
        self._star_trees = list(trees)

    def data_source(self, name: str) -> DataSource:
        try:
            return self._sources[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in segment "
                           f"{self.segment_name!r}") from None

    def get_value(self, column: str, doc_id: int) -> Any:
        """One doc's value of a column (a list for a multi-value column),
        read on the host (JAX :303)."""
        ds = self.data_source(column)
        cm = ds.metadata
        if cm.single_value:
            v = ds.forward_index[doc_id]
            if cm.has_dictionary:
                return ds.dictionary.get_value(int(v))
            return cm.data_type.convert(v.item())
        dense, counts = ds.dense_mv()
        return ds.dictionary.get_values(dense[doc_id, :int(counts[doc_id])])

    def __repr__(self) -> str:
        return (f"ImmutableSegment({self.segment_name!r}, "
                f"docs={self.num_docs}, columns={len(self.metadata.columns)})")


def _check_spans(name: str, ds: DataSource, cap: int) -> None:
    fwd = ds.forward_index
    cm = ds.metadata
    ok = (fwd.shape == (cap,) if cm.single_value
          else fwd.ndim == 2 and fwd.shape[0] == cap
          and ds.mv_counts is not None and ds.mv_counts.shape == (cap,))
    if not ok or (ds.null_bitmap is not None
                  and ds.null_bitmap.shape != (cap,)):
        raise ValueError(f"column {name!r}: arrays do not span the "
                         f"padded capacity {cap}")


class _ColumnFiles:
    """A loaded column's files, every one mapped at load: ``npy[suffix]``
    the ``.npy`` arrays, ``bin[suffix]`` the ``.bin`` buffers."""

    def __init__(self, col_dir: str, name: str, cm: ColumnMetadata):
        from pinot_tpu_torch.native import MmapBuffer, load_npy

        npy, bins = [], []
        if cm.has_dictionary:
            npy += ["dict"] if cm.data_type.is_numeric \
                else ["dictoff", "dictblob"]
        if cm.stored_dtype is None:
            raise ValueError(f"column {name!r}: no storedDtype in metadata")
        if cm.stored_dtype.startswith("packed:"):
            bins.append("fwdpk")
        elif cm.compression_codec:
            bins.append("fwdcc")
        else:
            npy.append("fwd")
        if not cm.single_value:
            npy.append("mvoff")
        if cm.has_nulls:
            npy.append("null")
        if cm.has_inverted_index:
            npy += ["invoff", "invbo"]
            bins.append("inv")
        if cm.has_bloom_filter:
            npy.append("bloom")
        if cm.has_range_index:
            npy.append("rangeord")
        if cm.has_text_index:
            npy += ["txtoff", "txtblob", "txtinvoff", "txtinvbo"]
            bins.append("txtinv")
        if cm.has_json_index:
            npy += ["jkeysoff", "jkeysblob", "jinvoff", "jinvbo"]
            bins.append("jinv")
        if cm.has_fst_index:
            from pinot_tpu_torch.segment.fstindex import FST_FILES

            npy += list(FST_FILES)
        if cm.has_geo_index:
            npy += ["geocells", "geometa"]
            # an index written before the coordinate arrays existed reads
            # its candidates' points from the dictionary (JAX :150-153)
            if os.path.exists(os.path.join(col_dir, f"{name}.geolng.npy")):
                npy += ["geolng", "geolat"]
        self.npy = {s: load_npy(os.path.join(col_dir, f"{name}.{s}.npy"))
                    for s in npy}
        self.bin = {s: MmapBuffer(os.path.join(col_dir, f"{name}.{s}.bin"))
                    for s in bins}

    def bytes_of(self, suffix: str) -> np.ndarray:
        return self.bin[suffix].as_array(np.uint8)


class _DiskDataSource(DataSource):
    """A loaded column: the ``DataSource`` interface over its mapped
    files, each array made at first use."""

    def __init__(self, name: str, metadata: ColumnMetadata,
                 seg_md: SegmentMetadata, files: _ColumnFiles):
        self.name = name
        self.metadata = metadata
        self._capacity = seg_md.padded_capacity
        self._num_docs = seg_md.num_docs
        self._files = files

    @cached_property
    def dictionary(self) -> Optional[Dictionary]:
        cm = self.metadata
        if not cm.has_dictionary:
            return None
        f = self._files.npy
        if cm.data_type.is_numeric:
            # owned: its values reach the card as plan parameters
            values = np.array(f["dict"], dtype=cm.data_type.stored_np)
        else:
            values = np.asarray(decode_strings(f["dictoff"], f["dictblob"]),
                                dtype=np.str_)
        return build_dictionary(values, cm.data_type)

    @cached_property
    def _forward(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        from pinot_tpu_torch import native
        from pinot_tpu_torch.segment.compression import read_compressed

        cm, cap, n = self.metadata, self._capacity, self._num_docs
        f = self._files
        counts = None
        if cm.stored_dtype.startswith("packed:"):
            bits = int(cm.stored_dtype.split(":", 1)[1])
            ids = native.bitunpack(f.bytes_of("fwdpk"), cap, bits)
            fwd = ids.astype(narrow_id_dtype(cm.cardinality))
        elif cm.compression_codec:
            fwd = read_compressed(f.bin["fwdcc"].path,
                                  blob=f.bin["fwdcc"].read())
        elif cm.single_value:
            fwd = f.npy["fwd"]
        else:
            # the JAX package's dense_mv (:213): flat dictIds with row
            # offsets -> [capacity, max(max values, 1)], zero past counts
            offsets = np.asarray(f.npy["mvoff"], dtype=np.int64)
            row_counts = np.diff(offsets)
            counts = np.zeros(cap, dtype=np.int32)
            counts[:n] = row_counts
            fwd = np.zeros((cap, max(cm.max_num_multi_values, 1)),
                           dtype=np.int32)
            rows = np.repeat(np.arange(n), row_counts)
            cols = np.arange(offsets[-1]) - np.repeat(offsets[:-1],
                                                      row_counts)
            fwd[rows, cols] = f.npy["fwd"]
        if fwd.shape[0] != cap:
            raise ValueError(f"column {self.name!r}: {fwd.shape[0]} rows on "
                             f"disk for the padded capacity {cap}")
        return fwd, counts

    @property
    def forward_index(self) -> np.ndarray:
        return self._forward[0]

    @property
    def mv_counts(self) -> Optional[np.ndarray]:
        return self._forward[1]

    @cached_property
    def null_bitmap(self) -> Optional[np.ndarray]:
        if not self.metadata.has_nulls:
            return None
        nb = self._files.npy["null"]
        if nb.shape != (self._capacity,):
            raise ValueError(f"column {self.name!r}: null bitmap of "
                             f"{nb.shape} for the padded capacity "
                             f"{self._capacity}")
        return nb

    @cached_property
    def inverted_index(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if not self.metadata.has_inverted_index:
            return None
        from pinot_tpu_torch.native import varint_decode_lists

        f = self._files
        offsets = np.array(f.npy["invoff"], dtype=np.int64)
        return offsets, varint_decode_lists(f.bytes_of("inv"),
                                            f.npy["invbo"], offsets)

    @cached_property
    def range_order(self) -> Optional[np.ndarray]:
        if not self.metadata.has_range_index:
            return None
        return self._files.npy["rangeord"]

    @cached_property
    def bloom_filter(self):
        if not self.metadata.has_bloom_filter:
            return None
        from pinot_tpu_torch.utils.bloom import BloomFilter

        return BloomFilter.from_array(self._files.npy["bloom"])

    @cached_property
    def fst_index(self):
        if not self.metadata.has_fst_index:
            return None
        from pinot_tpu_torch.segment.fstindex import FST_FILES, FstIndexReader

        return FstIndexReader(*(self._files.npy[s] for s in FST_FILES),
                              self.dictionary)

    @cached_property
    def text_index(self):
        if not self.metadata.has_text_index:
            return None
        from pinot_tpu_torch.segment.textindex import text_index_from_files

        f = self._files
        d = self.dictionary
        return text_index_from_files(
            {**f.npy, "txtinv": f.bytes_of("txtinv")},
            self.metadata.cardinality, value_of=d.get_value)

    @cached_property
    def geo_index(self):
        if not self.metadata.has_geo_index:
            return None
        from pinot_tpu_torch.segment.geoindex import GeoIndexReader

        return GeoIndexReader.from_files(self._files.npy, self.dictionary)

    @cached_property
    def json_index(self):
        if not self.metadata.has_json_index:
            return None
        from pinot_tpu_torch.segment.jsonindex import json_index_from_files

        f = self._files
        return json_index_from_files({**f.npy, "jinv": f.bytes_of("jinv")},
                                     self._num_docs)


def load_segment(segment_dir: str) -> ImmutableSegment:
    """A segment directory (the JAX package's layout) as an
    ``ImmutableSegment``; raises ``FileNotFoundError`` where the directory
    holds no ``metadata.json`` or a file its metadata names."""
    md_path = os.path.join(segment_dir, METADATA_FILE)
    if not os.path.isfile(md_path):
        raise FileNotFoundError(f"not a segment directory (no "
                                f"{METADATA_FILE}): {segment_dir}")
    md = SegmentMetadata.load(md_path)
    col_dir = os.path.join(segment_dir, COLUMNS_DIR)
    sources: Dict[str, DataSource] = {
        name: _DiskDataSource(name, cm, md, _ColumnFiles(col_dir, name, cm))
        for name, cm in md.columns.items()}
    from pinot_tpu_torch.segment.startree import StarTreeFiles

    tree_files = []
    for i in range(md.star_tree_count):
        files = StarTreeFiles.map(segment_dir, i)
        if files is None:
            raise FileNotFoundError(f"{segment_dir}: star-tree {i} of "
                                    f"{md.star_tree_count} is missing")
        tree_files.append(files)
    return ImmutableSegment(md, sources, segment_dir=segment_dir,
                            tree_files=tree_files)


def verify_crc(segment_dir: str) -> bool:
    """The CRC-32 of the directory's ``columns/`` files equals the one its
    metadata recorded."""
    from pinot_tpu_torch.segment.creator import compute_dir_crc

    md = SegmentMetadata.load(os.path.join(segment_dir, METADATA_FILE))
    return compute_dir_crc(os.path.join(segment_dir, COLUMNS_DIR)) == md.crc
