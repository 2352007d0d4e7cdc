"""Server-side segment lifecycle: table data managers with refcounts.

Counterpart of ``pinot_tpu/server/data_manager.py`` (``SegmentDataManager``
:71, ``TableDataManager`` :109, ``InstanceDataManager`` :303): a query
acquires its segments (refcount + 1) before it runs and releases them
after, so a segment replaced or removed mid-query goes only when its last
reader finishes. The table manager's listener hooks (``segment_added``,
``segment_removed``, and ``segment_released`` when a segment's last
reference goes) are the server's prefetch and eviction on the card.
A segment comes from the deep store as a directory (``file://``), which
``add_segment_from_dir`` loads (JAX :145), or from a ``memory://`` store
as an object, added as it is (``spi/filesystem.py``).

``RealtimeTableDataManager`` (JAX :193) also owns a realtime table's
consuming-segment managers: each consuming segment serves queries until
its seal replaces it (``on_sealed``: add-or-replace under the registry
lock, so a query acquires either view, never both or neither), and with
upsert every hosted segment registers with the table's upsert manager and
carries a live valid-doc view. ``on_sealed`` takes the seal as a segment
directory (loaded here, JAX :250-300) or as an object. A sealed object
fetched from a ``memory://`` store is shared with the servers that hold
it already, so an upsert table's server takes a shallow copy (the column
arrays shared) and hangs its own valid-doc view on it; a directory is
loaded into an object of this server's own. ``on_sealed`` records JAX's ``seal:`` decision in the process
ledger (``common/tracing.py`` ``LEDGER``) and counts it in the table's
``seal_decisions``, logs each seal (``seals``), and flushes the consuming
segment's last rows into the table's ``freshness`` histogram
(``common/telemetry.py``, JAX :261-275).
"""

from __future__ import annotations

import copy
import logging
import threading
import time

from typing import Any, Dict, List, Optional, Union

from pinot_tpu_torch.common.tracing import decision_key, record_decision
from pinot_tpu_torch.controller.assignment import _partition_from_llc_name
from pinot_tpu_torch.engine.mutable_staging import observe_freshness
from pinot_tpu_torch.ingestion.realtime import RealtimeSegmentDataManager
from pinot_tpu_torch.segment.immutable import ImmutableSegment, load_segment
from pinot_tpu_torch.segment.upsert import (
    TableUpsertMetadataManager,
    _LiveValidDocs,
    attach_valid_docs,
)
from pinot_tpu_torch.spi.table import raw_table_name

log = logging.getLogger(__name__)


def _segment_partition(segment, segment_name: str) -> int:
    """The stream partition of a sealed realtime segment: its metadata's
    ``segment.realtime.partition`` first, its LLC name second."""
    p = segment.metadata.custom.get("segment.realtime.partition")
    return int(p) if p is not None else _partition_from_llc_name(
        segment_name)


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
    hook), ``segment_removed(table, segment_name)`` after unregistration
    (the HBM eviction hook) and ``segment_released(table, segment)`` once
    a replaced or removed segment's last reader has let go. Listener
    failures never break lifecycle."""

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
            self._release(old)
        self._notify("segment_added", segment)

    def add_segment_from_dir(self, segment_dir: str) -> ImmutableSegment:
        """Load a segment directory and add (or replace) it."""
        seg = load_segment(segment_dir)
        self.add_segment(seg)
        return seg

    def remove_segment(self, segment_name: str) -> None:
        with self._lock:
            sdm = self._segments.pop(segment_name, None)
        if sdm is not None:
            self._release(sdm)
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
            self._release(sdm)

    def _release(self, sdm: SegmentDataManager) -> None:
        if sdm.release() == 0:
            self._notify("segment_released", sdm.segment)

    def shutdown(self) -> None:
        with self._lock:
            sdms = list(self._segments.values())
            self._segments.clear()
        for sdm in sdms:
            self._release(sdm)


class RealtimeTableDataManager(TableDataManager):
    """A realtime table's hosted segments and its consuming-segment
    managers (RealtimeTableDataManager)."""

    def __init__(self, table_name_with_type: str,
                 upsert_manager: Optional[TableUpsertMetadataManager] = None,
                 listener: Any = None):
        super().__init__(table_name_with_type, listener=listener)
        self._consumers: Dict[str, RealtimeSegmentDataManager] = {}  # guarded-by: _lock
        self.upsert_manager = upsert_manager
        #: the ``seal:`` decision keys, counted
        self.seal_decisions: Dict[str, int] = {}  # guarded-by: _lock
        #: one entry a seal: segment, decision, rows and consume s of the
        #: replaced consumer, flush threshold to swap s, swap ms
        self.seals: List[Dict[str, Any]] = []  # guarded-by: _lock

    def add_consuming(self, mgr: RealtimeSegmentDataManager) -> None:
        """Host a consuming segment; its consumer must share this table's
        upsert manager (it wires its own hook and live view)."""
        if mgr.upsert_manager is not self.upsert_manager:
            raise ValueError(f"consumer {mgr.segment_name} does not use "
                             f"{self.table_name}'s upsert manager")
        with self._lock:
            self._consumers[mgr.segment_name] = mgr
        self.add_segment(mgr.segment)   # the mutable segment serves queries

    def consuming_manager(self, segment_name: str
                          ) -> Optional[RealtimeSegmentDataManager]:
        with self._lock:
            return self._consumers.get(segment_name)

    def consumers(self) -> List[RealtimeSegmentDataManager]:
        with self._lock:
            return list(self._consumers.values())

    def remove_segment(self, segment_name: str) -> None:
        """Unassignment stops a live consumer (else it would re-add itself
        from its terminal callback) and drops the segment's upsert keys
        (else a stale location would outrank later records of its key)."""
        with self._lock:
            mgr = self._consumers.pop(segment_name, None)
        if mgr is not None:
            mgr.stop(reason="unassigned")
        if self.upsert_manager is not None:
            for pm in self.upsert_manager.partition_managers():
                pm.remove_segment(segment_name)
        super().remove_segment(segment_name)

    def drop_consumer(self, segment_name: str) -> None:
        with self._lock:
            self._consumers.pop(segment_name, None)

    def on_sealed(self, segment_name: str,
                  segment: Union[str, ImmutableSegment],
                  partition: Optional[int] = None,
                  fetched: bool = False) -> None:
        """CONSUMING -> ONLINE: the sealed ``segment`` (a segment
        directory, which is loaded, or a segment) replaces the consuming
        one. ``fetched``: it came from the deep store (a DISCARD
        or a server that found the segment ONLINE), so for an upsert table
        this server's keys are rebuilt from its rows on a shallow copy of
        its own; else it is this server's own seal, whose bitmap its
        consumer carried over. A query that acquired the consuming segment
        before the swap finishes on it (its refcount keeps it), one that
        acquires after sees only the seal."""
        t0 = time.perf_counter()
        loaded = isinstance(segment, str)
        if loaded:
            segment = load_segment(segment)
        with self._lock:
            mgr = self._consumers.pop(segment_name, None)
        reason = "seal_swap" if mgr is not None else "seal_download"
        if fetched and self.upsert_manager is not None:
            if not loaded:
                segment = copy.copy(segment)
            if partition is None:
                partition = (mgr.partition if mgr is not None
                             else _segment_partition(segment, segment_name))
            pm = self.upsert_manager.partition(partition)
            pm.remove_segment(segment_name)     # the consuming rows' keys
            pm.add_segment(segment)
            attach_valid_docs(segment, _LiveValidDocs(pm, segment_name))
        self.add_segment(segment)
        now = time.monotonic()
        entry = {"segment": segment_name, "decision": reason,
                 "fetched": fetched,
                 "swap_ms": (time.perf_counter() - t0) * 1e3}
        if mgr is not None and mgr.threshold_at is not None:
            entry.update(rows=mgr.rows_indexed,
                         consume_s=mgr.threshold_at - mgr.started_at,
                         threshold_to_swap_s=now - mgr.threshold_at)
        # the process ledger; seal_decisions keeps this table's own count
        record_decision(None, "seal", "immutable_swap", "consuming_segment",
                        reason)
        if mgr is not None:
            # the last freshness flush: rows ingested after the last
            # serving snapshot count once, against the seal's watermark
            observe_freshness(mgr.segment, int(mgr.segment.num_docs),
                              raw_table_name(self.table_name))
        key = decision_key("seal", "immutable_swap", "consuming_segment",
                           reason)
        with self._lock:
            self.seal_decisions[key] = self.seal_decisions.get(key, 0) + 1
            self.seals.append(entry)

    def shutdown(self) -> None:
        with self._lock:
            consumers = list(self._consumers.values())
            self._consumers.clear()
        for c in consumers:
            c.stop()
        super().shutdown()


class InstanceDataManager:
    """table -> TableDataManager registry (HelixInstanceDataManager)."""

    def __init__(self, listener: Any = None):
        self._tables: Dict[str, TableDataManager] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.listener = listener  # forwarded to created TableDataManagers

    def get_or_create(self, table: str, realtime: bool = False,
                      upsert_manager: Optional[
                          TableUpsertMetadataManager] = None
                      ) -> TableDataManager:
        with self._lock:
            tdm = self._tables.get(table)
            if tdm is None:
                tdm = (RealtimeTableDataManager(table, upsert_manager,
                                                listener=self.listener)
                       if realtime
                       else TableDataManager(table, listener=self.listener))
                self._tables[table] = tdm
            return tdm

    def get(self, table: str) -> Optional[TableDataManager]:
        with self._lock:
            return self._tables.get(table)

    def remove(self, table: str) -> None:
        """Drop a deleted table: its consumers stop and its segments go
        (a table created again under the name starts afresh)."""
        with self._lock:
            tdm = self._tables.pop(table, None)
        if tdm is not None:
            for seg in tdm.segment_names():
                tdm.remove_segment(seg)

    def table_names(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def shutdown(self) -> None:
        with self._lock:
            tdms = list(self._tables.values())
            self._tables.clear()
        for tdm in tdms:
            tdm.shutdown()
