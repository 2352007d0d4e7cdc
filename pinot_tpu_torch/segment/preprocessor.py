"""Segment reload: add the newly configured indexes to a segment on disk.

Counterpart of ``pinot_tpu/segment/preprocessor.py`` (:35-120): when a
table's indexing config gains an index its segments were built without,
``preprocess_segment`` builds just the missing index files from the data
already on disk (the dictionary and the forward index), the same bytes
the writer would have written, then rewrites the column flags and the CRC
in ``metadata.json``. The kinds are JAX's: inverted, bloom, text, JSON and
range. ``reload_segment`` is the server's half: preprocess, then swap the
served segment for the directory loaded again, with the served segment's
upsert valid-doc view (JAX's swap drops it, so there a reloaded upsert
segment serves every row again).

Replicas in one process may serve one directory (``file://`` serves in
place), so unlike JAX:

- one process-wide lock per segment directory serialises the rewrites;
- each new file, and ``metadata.json``, is written under a temporary name
  and renamed into place, so a reader never sees half a file;
- the served segment is swapped whenever the directory's CRC differs from
  its own, so a replica whose peer already added the index (nothing left
  to add) still serves it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List

import numpy as np

from pinot_tpu_torch.segment.convert import build_inverted_index
from pinot_tpu_torch.segment.creator import (
    compute_dir_crc,
    postings_files,
    write_file,
)
from pinot_tpu_torch.segment.immutable import (
    COLUMNS_DIR,
    ImmutableSegment,
    load_segment,
)
from pinot_tpu_torch.segment.jsonindex import build_json_index, json_index_files
from pinot_tpu_torch.segment.metadata import METADATA_FILE, SegmentMetadata
from pinot_tpu_torch.segment.textindex import build_text_index, text_index_files
from pinot_tpu_torch.segment.upsert import attach_valid_docs
from pinot_tpu_torch.spi.table import IndexingConfig
from pinot_tpu_torch.utils.bloom import BloomFilter

log = logging.getLogger(__name__)

_locks_guard = threading.Lock()
_dir_locks: Dict[str, threading.Lock] = {}  # guarded-by: _locks_guard


def dir_lock(segment_dir: str) -> threading.Lock:
    """The process-wide lock of one segment directory."""
    key = os.path.realpath(segment_dir)
    with _locks_guard:
        lock = _dir_locks.get(key)
        if lock is None:
            lock = _dir_locks[key] = threading.Lock()
        return lock


def preprocess_segment(segment_dir: str, indexing: IndexingConfig
                       ) -> List[str]:
    """Build every configured index the segment lacks; -> the
    ``<column>:<kind>`` labels added (empty: up to date)."""
    with dir_lock(segment_dir):
        return _preprocess_locked(segment_dir, indexing)


def _preprocess_locked(segment_dir: str, indexing: IndexingConfig
                       ) -> List[str]:
    seg = load_segment(segment_dir)
    md = seg.metadata
    n = md.num_docs
    col_dir = os.path.join(segment_dir, COLUMNS_DIR)
    added: List[str] = []

    def put(name: str, files) -> None:
        for suffix, data in files.items():
            ext = "npy" if isinstance(data, np.ndarray) else "bin"
            write_file(os.path.join(col_dir, f"{name}.{suffix}.{ext}"), data)

    for name, cm in md.columns.items():
        ds = seg.data_source(name)
        string_sv = (cm.single_value and not cm.data_type.is_numeric
                     and cm.has_dictionary)
        if name in indexing.inverted_index_columns \
                and not cm.has_inverted_index and cm.has_dictionary:
            fwd = np.asarray(ds.forward_index)
            if cm.single_value:
                ids, counts = fwd[:n], None
            else:
                counts = np.asarray(ds.mv_counts[:n])
                ids = fwd[:n][np.arange(fwd.shape[1])[None, :]
                              < counts[:, None]]
            put(name, postings_files("inv", *build_inverted_index(
                ids, counts, n, cm.cardinality)))
            cm.has_inverted_index = True
            added.append(f"{name}:inverted")
        if name in indexing.bloom_filter_columns and not cm.has_bloom_filter:
            values = (ds.dictionary.get_values(range(cm.cardinality))
                      if cm.has_dictionary
                      else list(np.unique(np.asarray(ds.forward_index[:n]))))
            put(name, {"bloom": BloomFilter.from_values(values).to_array()})
            cm.has_bloom_filter = True
            added.append(f"{name}:bloom")
        if name in indexing.text_index_columns and not cm.has_text_index \
                and string_sv:
            put(name, text_index_files(*build_text_index(
                ds.dictionary.get_values(range(cm.cardinality)))))
            cm.has_text_index = True
            added.append(f"{name}:text")
        if name in indexing.json_index_columns and not cm.has_json_index \
                and string_sv:
            values = ds.dictionary.get_values(np.asarray(ds.forward_index[:n]))
            put(name, json_index_files(*build_json_index(values, n)))
            cm.has_json_index = True
            added.append(f"{name}:json")
        if name in indexing.range_index_columns and not cm.has_range_index \
                and not cm.has_dictionary and cm.single_value and n:
            data = np.asarray(ds.forward_index[:n])
            put(name, {"rangeord": np.argsort(data, kind="stable")
                       .astype(np.int32)})
            cm.has_range_index = True
            added.append(f"{name}:range")
    if added:
        md.crc = compute_dir_crc(col_dir)
        md.save(os.path.join(segment_dir, METADATA_FILE))
        log.info("reload of %s added indexes: %s", segment_dir, added)
    return added


def reload_segment(tdm, segment: ImmutableSegment, indexing: IndexingConfig
                   ) -> List[str]:
    """Preprocess ``segment``'s directory and, where its CRC now differs
    from the served segment's, swap in the directory loaded again
    (``tdm.add_segment``: queries in flight finish on the old one). An
    upsert segment's valid-doc view goes with it: a reload adds indexes
    and leaves the rows and their order as they were. -> the indexes this
    call added."""
    seg_dir = segment.segment_dir
    if seg_dir is None:
        raise ValueError(f"segment {segment.segment_name!r} has no "
                         "directory to reload")
    with dir_lock(seg_dir):
        added = _preprocess_locked(seg_dir, indexing)
        crc = SegmentMetadata.load(os.path.join(seg_dir, METADATA_FILE)).crc
        if crc != segment.metadata.crc:
            fresh = load_segment(seg_dir)
            if segment.valid_doc_ids is not None:
                attach_valid_docs(fresh, segment.valid_doc_ids)
            tdm.add_segment(fresh)
    return added
