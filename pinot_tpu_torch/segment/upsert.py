"""Upsert: one live doc per primary key across a table's realtime
segments.

Counterpart of ``pinot_tpu/segment/upsert.py``: a per-partition primary
key -> record location map. When a record with a newer-or-equal
comparison value (by default the time column) arrives for a known key,
the older doc goes invalid in its segment's valid-doc bitmap; an older
record is invalidated itself. Every execution path ANDs the bitmap into
its filter (``validdocs`` on the device rungs, ``eval_filter`` on the
host engine), so each key shows one live doc.

``_LiveValidDocs`` is the live view a consuming segment carries as its
``valid_doc_ids``: each read sees the bitmap as it is now, and its
``version`` (bumped on every change) keys the device snapshot cache
(``engine/mutable_staging.py``). Its JAX home is
``pinot_tpu/server/data_manager.py:25-51``; here it sits beside the
manager it reads, for the standalone consumer and the server alike.
"""

from __future__ import annotations

import threading

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.spi.table import UpsertMode


@dataclass
class RecordLocation:
    """Where a key's live doc is."""

    segment_name: str
    doc_id: int
    comparison_value: Any


class PartitionUpsertMetadataManager:
    """One per (table, stream partition); thread-safe: a consumer indexes
    while queries read bitmaps."""

    def __init__(self, primary_key_columns: List[str],
                 comparison_column: Optional[str]):
        self.primary_key_columns = primary_key_columns
        self.comparison_column = comparison_column
        self._locations: Dict[Tuple, RecordLocation] = {}
        # per segment, a counter bumped on every bitmap change
        self._versions: Dict[str, int] = {}
        self._valid: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    # -- reads ------------------------------------------------------------------
    def valid_docs(self, segment_name: str) -> Optional[np.ndarray]:
        with self._lock:
            v = self._valid.get(segment_name)
            return None if v is None else v.copy()

    def valid_docs_version(self, segment_name: str) -> int:
        with self._lock:
            return self._versions.get(segment_name, 0)

    def _bump_locked(self, segment_name: str) -> None:
        self._versions[segment_name] = \
            self._versions.get(segment_name, 0) + 1

    @property
    def num_keys(self) -> int:
        with self._lock:
            return len(self._locations)

    # -- segment lifecycle ------------------------------------------------------
    def add_segment(self, segment) -> np.ndarray:
        """Index a sealed segment's keys; -> its valid bitmap (shared,
        changed in place on invalidation)."""
        n = segment.num_docs
        keys = self._segment_keys(segment)
        cmp_vals = self._read_column(segment, self.comparison_column)
        with self._lock:
            valid = np.ones(n, dtype=bool)
            self._valid[segment.segment_name] = valid
            self._bump_locked(segment.segment_name)
            for doc_id in range(n):
                self._upsert_locked(keys[doc_id], segment.segment_name,
                                    doc_id, cmp_vals[doc_id])
            return valid

    def remove_segment(self, segment_name: str) -> None:
        with self._lock:
            self._valid.pop(segment_name, None)
            dead = [k for k, loc in self._locations.items()
                    if loc.segment_name == segment_name]
            for k in dead:
                del self._locations[k]

    def replace_segment(self, segment) -> np.ndarray:
        """A sealed segment replaces the consuming one of its name: the
        same rows in the same order, so the bitmap carries over."""
        with self._lock:
            old = self._valid.get(segment.segment_name)
            n = segment.num_docs
            valid = np.ones(n, dtype=bool)
            if old is not None:
                m = min(n, old.shape[0])
                valid[:m] = old[:m]
            self._valid[segment.segment_name] = valid
            self._bump_locked(segment.segment_name)
            return valid

    # -- rows of a consuming segment --------------------------------------------
    def add_record(self, segment_name: str, doc_id: int, key: Tuple,
                   comparison_value: Any) -> None:
        """After ``MutableSegment.index`` of the row at ``doc_id``."""
        with self._lock:
            valid = self._valid.get(segment_name)
            if valid is None or doc_id >= valid.shape[0]:
                grown = np.ones(max(doc_id + 1, 1024), dtype=bool)
                if valid is not None:
                    grown[:valid.shape[0]] = valid
                valid = grown
                self._valid[segment_name] = valid
            self._bump_locked(segment_name)
            self._upsert_locked(key, segment_name, doc_id, comparison_value)

    def _upsert_locked(self, key: Tuple, segment_name: str, doc_id: int,
                       cmp_value: Any) -> None:
        loc = self._locations.get(key)
        if loc is not None:
            # newer-or-equal wins; a null comparison value is the oldest
            incoming_older = (
                (cmp_value is None and loc.comparison_value is not None)
                or (cmp_value is not None and loc.comparison_value is not None
                    and cmp_value < loc.comparison_value))
            if incoming_older:
                valid = self._valid.get(segment_name)
                if valid is not None and doc_id < valid.shape[0]:
                    valid[doc_id] = False
                    self._bump_locked(segment_name)
                return
            old_valid = self._valid.get(loc.segment_name)
            if old_valid is not None and loc.doc_id < old_valid.shape[0]:
                old_valid[loc.doc_id] = False
                self._bump_locked(loc.segment_name)
        self._locations[key] = RecordLocation(segment_name, doc_id, cmp_value)

    # -- helpers ----------------------------------------------------------------
    def key_of_row(self, row: Dict[str, Any]) -> Tuple:
        return tuple(row.get(c) for c in self.primary_key_columns)

    def _segment_keys(self, segment) -> List[Tuple]:
        cols = [self._read_column(segment, c)
                for c in self.primary_key_columns]
        return list(zip(*cols)) if cols else []

    @staticmethod
    def _read_column(segment, column: str) -> List[Any]:
        ds = segment.data_source(column)
        fwd = np.asarray(ds.forward_index[:segment.num_docs])
        if ds.dictionary is not None:
            return ds.dictionary.get_values(fwd)
        return fwd.tolist()


class TableUpsertMetadataManager:
    """table -> its partitions' managers."""

    def __init__(self, primary_key_columns: List[str],
                 comparison_column: Optional[str]):
        self.primary_key_columns = primary_key_columns
        self.comparison_column = comparison_column
        self._partitions: Dict[int, PartitionUpsertMetadataManager] = {}
        self._lock = threading.Lock()

    def partition_managers(self) -> List[PartitionUpsertMetadataManager]:
        with self._lock:
            return list(self._partitions.values())

    def partition(self, p: int) -> PartitionUpsertMetadataManager:
        with self._lock:
            m = self._partitions.get(p)
            if m is None:
                m = PartitionUpsertMetadataManager(
                    self.primary_key_columns, self.comparison_column)
                self._partitions[p] = m
            return m


def table_upsert_manager(table_config, schema,
                         time_column: Optional[str] = None
                         ) -> Optional[TableUpsertMetadataManager]:
    """The upsert manager a realtime table's config asks for, or None
    (JAX: ``pinot_tpu/server/server.py:200-226``): keyed on the schema's
    primary key; the config's comparison column decides, else
    ``time_column`` (a cluster's server passes the table's time column, as
    the JAX server does), else the latest arrival wins (the standalone
    consumer). PARTIAL raises: the JAX package serves it as FULL, and the
    port does not take that on."""
    uc = table_config.upsert_config
    if uc is None or uc.mode is UpsertMode.NONE:
        return None
    if uc.mode is not UpsertMode.FULL:
        raise ValueError(f"upsert mode {uc.mode.value} is not implemented")
    if not schema.primary_key_columns:
        raise ValueError(f"upsert table {table_config.table_name!r}: the "
                         "schema has no primary key columns")
    return TableUpsertMetadataManager(schema.primary_key_columns,
                                      uc.comparison_column or time_column)


def attach_valid_docs(segment, valid) -> None:
    """Make a segment upsert-managed: every path ANDs ``valid`` (a bool
    array, or a ``_LiveValidDocs``) into its filter."""
    segment.valid_doc_ids = valid


class _LiveValidDocs:
    """Array-like view of the manager's live bitmap of one segment: a
    slice reads the bitmap as it is now, docs past its end are valid (the
    bitmap may lag the doc count for a moment). JAX:
    ``pinot_tpu/server/data_manager.py:25``."""

    def __init__(self, pm: PartitionUpsertMetadataManager,
                 segment_name: str):
        self._pm = pm
        self._segment_name = segment_name

    @property
    def version(self) -> int:
        """The bitmap's change counter (the device snapshot's cache key)."""
        return self._pm.valid_docs_version(self._segment_name)

    def __getitem__(self, item):
        v = self._pm.valid_docs(self._segment_name)
        if isinstance(item, slice):
            stop = item.stop if item.stop is not None else \
                (0 if v is None else v.shape[0])
            if v is None:
                return np.ones(stop, dtype=bool)[item]
            if v.shape[0] < stop:
                grown = np.ones(stop, dtype=bool)
                grown[:v.shape[0]] = v
                v = grown
            return v[item]
        return True if v is None or item >= v.shape[0] else bool(v[item])


__all__ = ["PartitionUpsertMetadataManager", "RecordLocation",
           "TableUpsertMetadataManager", "attach_valid_docs",
           "table_upsert_manager",
           "_LiveValidDocs"]
