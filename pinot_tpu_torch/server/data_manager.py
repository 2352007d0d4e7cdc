"""Server-side segment lifecycle: table data managers with refcounts.

Counterpart of ``pinot_tpu/server/data_manager.py`` (``SegmentDataManager``
:71, ``TableDataManager`` :109, ``InstanceDataManager`` :303): a query
acquires its segments (refcount + 1) before it runs and releases them
after, so a segment replaced or removed mid-query goes only when its last
reader finishes. The table manager's listener hooks (``segment_added``,
``segment_removed``) are the server's prefetch and eviction on the card.
A segment comes from the deep store as an object (``spi/filesystem.py``)
and is added as it is; the JAX ``add_segment_from_dir`` and the realtime
table manager (consuming segments, the seal swap, upsert) are not part
of this module.
"""

from __future__ import annotations

import logging
import threading

from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)


class SegmentDataManager:
    """One segment and its refcount (1 for the registration
    reference)."""

    def __init__(self, segment: Any):
        self.segment = segment
        self._refcount = 1  # guarded-by: _lock
        self._lock = threading.Lock()

    @property
    def segment_name(self) -> str:
        return self.segment.segment_name

    def acquire(self) -> bool:
        with self._lock:
            if self._refcount <= 0:
                return False
            self._refcount += 1
            return True

    def release(self) -> int:
        """-> the refcount left; at 0 the manager lets go of the segment
        (an in-memory segment needs no close)."""
        with self._lock:
            self._refcount -= 1
            return self._refcount


class TableDataManager:
    """An offline table's hosted segments (BaseTableDataManager).

    ``listener`` (optional) observes the segment lifecycle:
    ``segment_added(table, segment)`` after registration (the HBM prefetch
    hook) and ``segment_removed(table, segment_name)`` after unregistration
    (the HBM eviction hook). Listener failures never break lifecycle."""

    def __init__(self, table_name_with_type: str, listener: Any = None):
        self.table_name = table_name_with_type
        self.listener = listener
        self._segments: Dict[str, SegmentDataManager] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def _notify(self, method: str, *args) -> None:
        fn = getattr(self.listener, method, None)
        if fn is None:
            return
        try:
            fn(self.table_name, *args)
        except Exception:
            log.exception("segment lifecycle listener %s failed", method)

    # -- lifecycle -----------------------------------------------------------
    def add_segment(self, segment: Any) -> None:
        """Add or replace (addOrReplaceSegment): the old manager's
        registration reference is released; in-flight queries holding an
        acquire keep the old segment alive until they release."""
        sdm = SegmentDataManager(segment)
        with self._lock:
            old = self._segments.get(segment.segment_name)
            self._segments[segment.segment_name] = sdm
        if old is not None:
            old.release()
        self._notify("segment_added", segment)

    def remove_segment(self, segment_name: str) -> None:
        with self._lock:
            sdm = self._segments.pop(segment_name, None)
        if sdm is not None:
            sdm.release()
            self._notify("segment_removed", segment_name)

    def segment_names(self) -> List[str]:
        with self._lock:
            return sorted(self._segments)

    def has_segment(self, segment_name: str) -> bool:
        with self._lock:
            return segment_name in self._segments

    # -- query-time acquire / release ----------------------------------------
    def acquire_segments(self, segment_names: Optional[List[str]] = None
                         ) -> List[SegmentDataManager]:
        """Acquire the named segments (all when None). Missing or
        concurrently-destroyed segments are skipped — the reference reports
        them in the response metadata as missing segments."""
        with self._lock:
            wanted = (list(self._segments.values()) if segment_names is None
                      else [self._segments[n] for n in segment_names
                            if n in self._segments])
        out = []
        for sdm in wanted:
            if sdm.acquire():
                out.append(sdm)
        return out

    def release_segments(self, sdms: List[SegmentDataManager]) -> None:
        for sdm in sdms:
            sdm.release()

    def shutdown(self) -> None:
        with self._lock:
            sdms = list(self._segments.values())
            self._segments.clear()
        for sdm in sdms:
            sdm.release()


class InstanceDataManager:
    """table -> TableDataManager registry (HelixInstanceDataManager)."""

    def __init__(self, listener: Any = None):
        self._tables: Dict[str, TableDataManager] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.listener = listener  # forwarded to created TableDataManagers

    def get_or_create(self, table: str) -> TableDataManager:
        with self._lock:
            tdm = self._tables.get(table)
            if tdm is None:
                tdm = TableDataManager(table, listener=self.listener)
                self._tables[table] = tdm
            return tdm

    def get(self, table: str) -> Optional[TableDataManager]:
        with self._lock:
            return self._tables.get(table)

    def table_names(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def shutdown(self) -> None:
        with self._lock:
            tdms = list(self._tables.values())
            self._tables.clear()
        for tdm in tdms:
            tdm.shutdown()
