"""Device residency: a byte budget, pins, cost-aware eviction, a host tier.

Counterpart of ``pinot_tpu/engine/residency.py``. Every resident (a
per-segment ``StagedSegment``, or a staged segment batch registered by
``ShardedQueryExecutor``) reports ``nbytes()``; the manager sums them
against a budget:

- **Budget**: ``pinot.server.query.hbm.budget.bytes`` (<= 0: uncapped).
  Unset, it is the card's memory (``torch.cuda.mem_get_info``) times 0.75;
  on the CPU, uncapped. As in the JAX package, one budget covers an
  executor's whole combine mesh: a batch staged over a mesh is one
  resident whose bytes are summed over its cells
  (``MeshStagedBatch.nbytes``), and the budget is resolved on the mesh's
  root device.
- **Host tier**: an evicted resident is demoted to pinned host copies
  instead of dropped (``StagedSegment.demote``); the next ``stage`` of
  the same segment promotes them back with one host-to-device copy per
  array, skipping decode, dictionary and packing. Host entries have their
  own budget (``pinot.server.query.hostram.budget.bytes``, unset:
  ``MemAvailable`` of ``/proc/meminfo`` times 0.5) and are dropped least
  recently used first past it.
- **Eviction** ranks unpinned residents by ``bytes * staleness /
  rebuild_cost``: big, cold, cheap-to-restage residents go first, star-tree
  node arrays last. Equal costs give exact LRU.
- **Pins**: a query's ``QueryLease`` pins what it stages until
  ``end_query``, so no array it reads is evicted under it.
- **Admission** (``begin_query``): a working set that fits gets a device
  lease; one over the budget whose largest segment fits gets a sliced
  lease (the executors stage, run and release one slice at a time); one
  whose single segment cannot fit, or a shape that cannot slice, goes to
  the host engine. Estimates (``estimate_segment_bytes``, the port's own
  layout) are corrected by a clamped EWMA of measured over estimated
  bytes.
- **Prefetch**: ``prefetch`` stages a segment in the background, never
  evicting for itself; a segment evicted while its prefetch waited is not
  brought back (the retire generation).

- **Borrowing** (``column_borrower``, set by ``ShardedQueryExecutor``): a
  per-segment staging builds a column's general-rung arrays from a
  resident batch's device copy instead of uploading them again (JAX
  :313-316, :541-547); ``note_borrow`` counts it (``borrows``) and keeps
  the lending batch warm, and a segment a resident batch holds ranks as
  ``COST_BORROWED_BUILD`` in the eviction cost.

- **Metrics**: ``bind_metrics`` (JAX :1120-1171) adds the byte gauges
  of both tiers to a server's registry and marks the ``STAGING_*``
  meters at every hit, miss, eviction, spill, borrow, demotion,
  promotion and sliced query; the data-manager hooks that prefetch and
  evict are the server's (``server/server.py``). Every marked event also
  feeds the flight recorder's storm trigger, and both tiers' bytes are
  gauge rings of the process telemetry (JAX :1141-1164).
"""

from __future__ import annotations

import logging
import queue
import threading

from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

from pinot_tpu_torch.common.telemetry import TELEMETRY, note_storm_event
from pinot_tpu_torch.device import resolve_device
from pinot_tpu_torch.engine.staging import (
    TILE,
    StagedSegment,
    pack_bits,
    staged_int_dtype,
)
from pinot_tpu_torch.segment.mutable import is_mutable
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration
from pinot_tpu_torch.spi.metrics import ServerMeter

log = logging.getLogger(__name__)

# budget sentinel: resolve from the config, then the device / host memory
AUTO = object()

_STOP = object()

# rebuild-cost weights of the eviction ranking (only the ratios matter): a
# host-tier restage is one copy; a batch re-adopts its stacked host arrays;
# a column borrowed from a resident batch is a copy on the device; a cold
# column build decodes, packs and copies; star-tree node arrays pay the
# tree on top
COST_HOST_RESTAGE = 1.0
COST_BATCH_RESTAGE = 1.5
COST_BORROWED_BUILD = 2.0
COST_COLUMN_BUILD = 4.0
COST_STARTREE_BUILD = 8.0

# admission-estimate drift: EWMA of measured / estimated staged bytes,
# clamped so one odd segment cannot swing admission
_EST_ALPHA = 0.2
_EST_SCALE_MIN = 0.25
_EST_SCALE_MAX = 4.0

# a slice fills at most this share of the free budget: estimates are
# approximate, and a slice on the budget line would evict mid-query
_SLICE_FILL = 0.85


# --------------------------------------------------------------------------
# working-set estimation (admission)
# --------------------------------------------------------------------------

def estimate_segment_bytes(segment, columns: Iterable[str]) -> int:
    """Device bytes that staging ``columns`` of ``segment`` in the port's
    layout costs, from metadata alone (admission runs before any copy):
    planar packed words for a single-value dictionary column, a value
    column for a single-value numeric one, dense MV dictIds with counts,
    a bool null bitmap. A numeric dictionary column counts both its words
    and its values."""
    cap = int(getattr(segment, "padded_capacity", 0) or 0)
    scan_cap = -(-cap // TILE) * TILE
    md = getattr(segment, "metadata", None)
    cols = getattr(md, "columns", {}) if md is not None else {}
    total = 0
    for name in columns:
        cm = cols.get(name) if hasattr(cols, "get") else None
        if cm is None:
            continue
        if not cm.single_value:
            total += cap * 4 * max(cm.max_num_multi_values, 1) + cap * 4
        else:
            if cm.has_dictionary:
                bits = pack_bits(max(1, max(cm.cardinality - 1,
                                            1).bit_length()))
                total += scan_cap * bits // 8
            if cm.data_type.is_numeric:
                item = (staged_int_dtype(cm).itemsize
                        if cm.data_type.is_integral else 4)
                total += scan_cap * item
            elif not cm.has_dictionary:
                total += cap * 8
        if cm.has_nulls:
            total += cap
    return total


def resolve_budget_bytes(budget_bytes: Any = AUTO, config=None,
                         device: Optional[torch.device] = None
                         ) -> Optional[int]:
    """Explicit argument > config key > the card's memory times
    ``DEFAULT_HBM_BUDGET_FRACTION``. None: uncapped (<= 0 given, or a CPU
    device)."""
    if budget_bytes is not AUTO:
        if budget_bytes is None:
            return None
        b = int(budget_bytes)
        return b if b > 0 else None
    cfg = config if config is not None else PinotConfiguration()
    v = cfg.get(CommonConstants.HBM_BUDGET_BYTES_KEY)
    if v is not None:
        b = int(v)
        return b if b > 0 else None
    if device is None or device.type != "cuda":
        return None
    total = torch.cuda.mem_get_info(device)[1]
    return int(total * CommonConstants.DEFAULT_HBM_BUDGET_FRACTION)


def _mem_available() -> Optional[int]:
    """``MemAvailable`` of ``/proc/meminfo`` in bytes, or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def resolve_host_budget_bytes(budget_bytes: Any = AUTO,
                              config=None) -> Optional[int]:
    """Explicit argument > config key > ``MemAvailable`` times
    ``DEFAULT_HOSTRAM_BUDGET_FRACTION``. None: uncapped (<= 0 given, or
    nothing known)."""
    if budget_bytes is not AUTO:
        if budget_bytes is None:
            return None
        b = int(budget_bytes)
        return b if b > 0 else None
    cfg = config if config is not None else PinotConfiguration()
    v = cfg.get(CommonConstants.HOSTRAM_BUDGET_BYTES_KEY)
    if v is not None:
        b = int(v)
        return b if b > 0 else None
    avail = _mem_available()
    if avail is None:
        return None
    return int(avail * CommonConstants.DEFAULT_HOSTRAM_BUDGET_FRACTION)


# --------------------------------------------------------------------------
# leases
# --------------------------------------------------------------------------

class QueryLease:
    """One query's pin set and staging counters, from ``begin_query`` to
    ``end_query``. A sliced lease keeps the device path but releases its
    pins at slice boundaries (``release_slice``)."""

    __slots__ = ("device_allowed", "sliced", "spilled", "hits", "misses",
                 "evictions", "pin_blocked", "promotions", "demotions",
                 "slices", "admit_reason", "_pinned", "_est")

    def __init__(self, device_allowed: bool = True):
        self.device_allowed = device_allowed
        self.sliced = False
        self.spilled = not device_allowed
        # "fits" | "working_set_over_budget_sliceable" |
        # "single_segment_over_budget" |
        # "working_set_over_budget_not_sliceable"
        self.admit_reason = "fits"
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.pin_blocked = 0
        self.promotions = 0
        self.demotions = 0
        self.slices = 0
        self._pinned: set = set()
        # raw admission estimates of the segments not yet resident, for
        # the drift observation at end_query
        self._est: Dict[str, int] = {}

    def staging_dict(self, staged_bytes: int,
                     host_bytes: int = 0) -> Dict[str, int]:
        """The ``QueryStats.staging`` payload."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "pinBlockedEvictions": self.pin_blocked,
            "spills": 1 if self.spilled else 0,
            "promotions": self.promotions,
            "demotions": self.demotions,
            "slices": self.slices,
            "stagedBytes": int(staged_bytes),
            "hostBytes": int(host_bytes),
        }


class _Entry:
    __slots__ = ("resident", "pins", "nbytes", "touch")

    def __init__(self, resident):
        self.resident = resident
        self.pins = 0
        self.nbytes = 0
        self.touch = 0


class ResidencyManager:
    """(name -> resident) in two tiers, with byte budgets, pins, cost-aware
    eviction, sliced / host admission and background prefetch. A resident
    has ``nbytes()`` and ``release()``; one that also has ``demote()``
    (returning a host image with ``nbytes()``, ``release()``, ``matches()``)
    moves to the host tier when evicted. Lock order: the manager, then a
    resident's or an executor's own locks; a resident is released or
    demoted only after the manager's lock is dropped."""

    def __init__(self, budget_bytes: Any = AUTO, config=None,
                 host_budget_bytes: Any = AUTO,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self._budget_arg = budget_bytes
        self._host_budget_arg = host_budget_bytes
        self._config = config
        self._budget_resolved = False
        self._budget: Optional[int] = None
        self._host_budget_resolved = False  # guarded-by-writes: _lock
        self._host_budget: Optional[int] = None  # guarded-by-writes: _lock
        # re-entrant: releasing a batch resident calls back into discard()
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()  # guarded-by: _lock
        self._host_entries: "OrderedDict[str, _Entry]" = OrderedDict()  # guarded-by: _lock
        self._staged_bytes = 0  # guarded-by-writes: _lock
        self._peak_bytes = 0  # guarded-by-writes: _lock
        self._host_bytes = 0  # guarded-by-writes: _lock
        self._host_peak_bytes = 0  # guarded-by-writes: _lock
        self._touch_seq = 0  # guarded-by: _lock
        self._est_scale = 1.0  # guarded-by: _lock
        self.est_observations = 0  # guarded-by: _lock
        # per name, how often it was evicted: a queued prefetch carries the
        # count it saw and must not bring back a segment removed meanwhile
        self._retired: Dict[str, int] = {}  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.pin_blocked = 0  # guarded-by: _lock
        self.spills = 0  # guarded-by: _lock
        self.prefetched = 0  # guarded-by: _lock
        self.borrows = 0  # guarded-by: _lock
        self.demotions = 0  # guarded-by: _lock
        self.promotions = 0  # guarded-by: _lock
        self.host_drops = 0  # guarded-by: _lock
        self.sliced_queries = 0  # guarded-by: _lock
        self.demoted_bytes = 0  # guarded-by: _lock
        self.promoted_bytes = 0  # guarded-by: _lock
        self.host_dropped_bytes = 0  # guarded-by: _lock
        self._metrics = None  # race-ok: publish_once
        cfg = config if config is not None else PinotConfiguration()
        self._host_on = cfg.get_bool(CommonConstants.HOSTRAM_ENABLED_KEY,
                                     True)
        self._slicing_on = cfg.get_bool(
            CommonConstants.HBM_SLICING_ENABLED_KEY, True)
        # ``column_borrower(segment, name)`` -> a StagedColumn built from a
        # resident batch's device copy, or None (set by the sharded
        # executor)
        self.column_borrower = None
        self._prefetch_q: Optional["queue.Queue"] = None
        self._prefetch_thread: Optional[threading.Thread] = None
        self._closed = False

    # -- budgets ---------------------------------------------------------------
    @property
    def budget_bytes(self) -> Optional[int]:
        if not self._budget_resolved:
            with self._lock:
                if not self._budget_resolved:
                    self._budget = resolve_budget_bytes(
                        self._budget_arg, self._config, self.device)
                    self._budget_resolved = True
        return self._budget

    def set_budget_bytes(self, budget_bytes: Optional[int]) -> None:
        with self._lock:
            self._budget = (int(budget_bytes)
                            if budget_bytes and int(budget_bytes) > 0
                            else None)
            self._budget_resolved = True
            doomed = self._enforce_locked()
        self._demote_or_release_all(doomed)

    @property
    def host_budget_bytes(self) -> Optional[int]:
        if not self._host_budget_resolved:
            with self._lock:
                if not self._host_budget_resolved:
                    self._host_budget = resolve_host_budget_bytes(
                        self._host_budget_arg, self._config)
                    self._host_budget_resolved = True
        return self._host_budget

    def set_host_budget_bytes(self, budget_bytes: Optional[int]) -> None:
        with self._lock:
            self._host_budget = (int(budget_bytes)
                                 if budget_bytes and int(budget_bytes) > 0
                                 else None)
            self._host_budget_resolved = True
            dropped = self._enforce_host_locked()
        for img in dropped:
            img.release()

    def set_host_tier_enabled(self, enabled: bool) -> None:
        """Off: new evictions drop instead of demoting; host entries
        already held keep serving."""
        with self._lock:
            self._host_on = bool(enabled)

    def host_tier_enabled(self) -> bool:
        with self._lock:
            return self._host_on

    # -- staging ---------------------------------------------------------------
    def stage(self, segment, lease: Optional[QueryLease] = None
              ) -> StagedSegment:
        """The resident ``StagedSegment`` of ``segment``, made on a miss
        (promoted from a matching host image), pinned by ``lease``. One
        resident per segment however many threads stage it; a reloaded
        segment (same name, new object) replaces its stale resident."""
        with self._lock:
            resident, doomed = self._stage_locked(segment, lease)
        self._demote_or_release_all(doomed, lease)
        return resident

    def _stage_locked(self, segment, lease: Optional[QueryLease]):
        name = segment.segment_name
        doomed: List[Tuple[Optional[str], Any]] = []
        e = self._entries.get(name)
        if e is not None and isinstance(e.resident, StagedSegment) \
                and e.resident.segment is segment:
            self._entries.move_to_end(name)
            e.touch = self._next_touch_locked()
            self.hits += 1
            self._mark("STAGING_HITS")
            if lease is not None:
                lease.hits += 1
        else:
            if e is not None:   # identity change: the stale arrays go
                del self._entries[name]
                doomed.append((None, e.resident))
            image = self._take_host_locked(name, segment, lease)
            e = _Entry(StagedSegment(segment, device=self.device,
                                     host_image=image,
                                     borrower=self.column_borrower))
            e.touch = self._next_touch_locked()
            self._entries[name] = e
            self.misses += 1
            self._mark("STAGING_MISSES")
            if lease is not None:
                lease.misses += 1
        self._pin_locked(name, e, lease)
        doomed += self._enforce_locked(lease)
        return e.resident, doomed

    def register(self, name: str, make_resident, same=None,
                 lease: Optional[QueryLease] = None):
        """Get-or-create for a resident that is not a segment (a staged
        batch): ``make_resident()`` builds on a miss, ``same(r)`` says
        whether the held one is still current."""
        doomed: List[Tuple[Optional[str], Any]] = []
        with self._lock:
            e = self._entries.get(name)
            if e is not None and (same is None or same(e.resident)):
                self._entries.move_to_end(name)
                e.touch = self._next_touch_locked()
                self.hits += 1
                self._mark("STAGING_HITS")
                if lease is not None:
                    lease.hits += 1
            else:
                if e is not None:
                    del self._entries[name]
                    doomed.append((None, e.resident))
                e = _Entry(make_resident())
                e.touch = self._next_touch_locked()
                self._entries[name] = e
                self.misses += 1
                self._mark("STAGING_MISSES")
                if lease is not None:
                    lease.misses += 1
            self._pin_locked(name, e, lease)
            doomed += self._enforce_locked(lease)
            resident = e.resident
        self._demote_or_release_all(doomed, lease)
        return resident

    def _pin_locked(self, name: str, e: _Entry,
                    lease: Optional[QueryLease]) -> None:
        if lease is not None and name not in lease._pinned:
            e.pins += 1
            lease._pinned.add(name)

    def _next_touch_locked(self) -> int:
        self._touch_seq += 1
        return self._touch_seq

    def account(self, name: str,
                lease: Optional[QueryLease] = None) -> None:
        """Measure again (arrays were staged after admission) and enforce
        the budget."""
        with self._lock:
            doomed = self._enforce_locked(lease)
        self._demote_or_release_all(doomed, lease)

    def evict(self, name: str) -> None:
        """Drop ``name`` from both tiers (segment removed or reloaded),
        with every host batch image that holds it; queued prefetches of it
        become no-ops."""
        with self._lock:
            self._retired[name] = self._retired.get(name, 0) + 1
            e = self._entries.pop(name, None)
            if e is not None:
                self.evictions += 1
                self._mark("STAGING_EVICTIONS")
                self._refresh_locked()
            dropped = self._drop_host_locked(name)
        if e is not None:
            e.resident.release()
        for img in dropped:
            img.release()

    def _drop_host_locked(self, segment_name: str) -> List[Any]:
        dropped: List[Any] = []
        for name in list(self._host_entries):
            he = self._host_entries[name]
            names = getattr(he.resident, "segment_names", (name,))
            if name == segment_name or segment_name in names:
                del self._host_entries[name]
                self._release_host_locked(he)
                self.host_drops += 1
                self._mark("STAGING_HOST_DROPS")
                self.host_dropped_bytes += he.nbytes
                dropped.append(he.resident)
        return dropped

    def demote(self, name: str) -> bool:
        """Demote one unpinned resident to the host tier; False when it is
        absent or pinned."""
        with self._lock:
            e = self._entries.get(name)
            if e is None or e.pins > 0:
                return False
            del self._entries[name]
            self.evictions += 1
            self._mark("STAGING_EVICTIONS")
            self._refresh_locked()
        self._demote_or_release_all([(name, e.resident)])
        return True

    def note_borrow(self, batch_name: str) -> None:
        """A per-segment staging built a column from the resident batch
        ``batch_name``: count it and touch the batch, so a lender its
        borrowers read stays warm."""
        with self._lock:
            self.borrows += 1
            self._mark("STAGING_BORROWS")
            e = self._entries.get(batch_name)
            if e is not None:
                self._entries.move_to_end(batch_name)
                e.touch = self._next_touch_locked()

    def discard(self, name: str) -> None:
        """Forget a device entry whose owner already dropped its arrays
        (idempotent); host images stay valid for promotion."""
        with self._lock:
            self._entries.pop(name, None)
            self._refresh_locked()

    def clear(self) -> None:
        with self._lock:
            doomed = [e.resident for e in self._entries.values()]
            doomed += [e.resident for e in self._host_entries.values()]
            self._entries.clear()
            self._host_entries.clear()
            self._staged_bytes = 0
            self._host_bytes = 0
        for r in doomed:
            r.release()

    def _demote_or_release_all(self, doomed: List[Tuple[Optional[str], Any]],
                               lease: Optional[QueryLease] = None) -> None:
        """Evicted residents demote to the host tier where they can (a
        name, the tier on, a ``demote`` hook, an image within the host
        budget), else release. Runs with the manager's lock dropped: a
        demotion waits for its device-to-host copies."""
        for name, r in doomed:
            image = None
            demote_fn = getattr(r, "demote", None)
            if name is not None and demote_fn is not None \
                    and self.host_tier_enabled():
                hb = self.host_budget_bytes
                if hb is None or int(r.nbytes()) <= hb:
                    image = demote_fn()
            if image is None:
                r.release()
                continue
            with self._lock:
                self._admit_host_locked(name, image)
                if lease is not None:
                    lease.demotions += 1

    # -- host tier -------------------------------------------------------------
    def _admit_host_locked(self, name: str, image) -> None:
        prev = self._host_entries.pop(name, None)
        if prev is not None:
            self._release_host_locked(prev)
            prev.resident.release()
        e = _Entry(image)
        e.nbytes = int(image.nbytes())
        self._host_entries[name] = e
        self._host_bytes += e.nbytes
        self._host_peak_bytes = max(self._host_peak_bytes, self._host_bytes)
        self.demotions += 1
        self._mark("STAGING_DEMOTIONS")
        self.demoted_bytes += e.nbytes
        for img in self._enforce_host_locked():
            img.release()

    def _release_host_locked(self, e: _Entry) -> None:
        self._host_bytes = max(0, self._host_bytes - e.nbytes)

    def _enforce_host_locked(self) -> List[Any]:
        """Drop host entries, least recently demoted first, past the host
        budget; -> the dropped images."""
        budget = (self._host_budget if self._host_budget_resolved
                  else self.host_budget_bytes)
        dropped: List[Any] = []
        if budget is None:
            return dropped
        while self._host_bytes > budget and self._host_entries:
            _name, e = self._host_entries.popitem(last=False)
            self._release_host_locked(e)
            self.host_drops += 1
            self._mark("STAGING_HOST_DROPS")
            self.host_dropped_bytes += e.nbytes
            dropped.append(e.resident)
        return dropped

    def _take_host_locked(self, name: str, target,
                          lease: Optional[QueryLease] = None):
        """Pop the host entry of ``name`` if its image matches ``target``
        (a segment, or a batch's segment list) -> the image to promote, or
        None; a stale image is dropped."""
        he = self._host_entries.pop(name, None)
        if he is None:
            return None
        self._release_host_locked(he)
        image = he.resident
        if not image.matches(target):
            self.host_drops += 1
            self._mark("STAGING_HOST_DROPS")
            self.host_dropped_bytes += he.nbytes
            image.release()
            return None
        self.promotions += 1
        self._mark("STAGING_PROMOTIONS")
        self.promoted_bytes += he.nbytes
        if lease is not None:
            lease.promotions += 1
        return image

    def promote_host(self, name: str, target=None,
                     lease: Optional[QueryLease] = None):
        """The host image of a resident that is not a segment (a batch),
        popped and accounted when it matches ``target``."""
        with self._lock:
            return self._take_host_locked(name, target, lease)

    # -- the query protocol ----------------------------------------------------
    def begin_query(self, segments: List[Any], columns: Iterable[str],
                    sliceable: bool = False) -> QueryLease:
        """Admission: the query's estimated working set against what could
        be freed (the budget less what other queries pin). Fits: a device
        lease. Over, but each segment fits and the shape can slice: a
        sliced lease. Else: a lease that sends the query to the host
        engine."""
        budget = self.budget_bytes
        if budget is None:
            return QueryLease(device_allowed=True)
        with self._lock:
            ws, max_single, other_pinned, ests = self._working_set_locked(
                segments, list(columns))
            if ws + other_pinned <= budget:
                lease = QueryLease(device_allowed=True)
                lease._est = ests
                return lease
            if sliceable and self._slicing_on \
                    and max_single + other_pinned <= budget:
                self.sliced_queries += 1
                self._mark("STAGING_SLICED")
                lease = QueryLease(device_allowed=True)
                lease.sliced = True
                lease.admit_reason = "working_set_over_budget_sliceable"
                lease._est = ests
                return lease
            self.spills += 1
            self._mark("STAGING_SPILLS")
            lease = QueryLease(device_allowed=False)
            lease.admit_reason = (
                "single_segment_over_budget"
                if max_single + other_pinned > budget
                else "working_set_over_budget_not_sliceable")
            return lease

    def _working_set_locked(self, segments: List[Any], cols: List[str]):
        """-> (working set, largest segment, bytes other queries pin, raw
        estimates of the segments not resident) as admission sees them: a
        resident segment at its measured bytes, the others at their
        drift-corrected estimates."""
        self._refresh_locked()
        scale = min(max(self._est_scale, _EST_SCALE_MIN), _EST_SCALE_MAX)
        names = {s.segment_name for s in segments}
        ws = max_single = 0
        ests: Dict[str, int] = {}
        for s in segments:
            e = self._entries.get(s.segment_name)
            if e is not None and isinstance(e.resident, StagedSegment) \
                    and e.resident.segment is s:
                n = e.nbytes
            else:
                ests[s.segment_name] = estimate_segment_bytes(s, cols)
                n = int(ests[s.segment_name] * scale)
            ws += n
            max_single = max(max_single, n)
        other_pinned = sum(e.nbytes for n, e in self._entries.items()
                           if e.pins > 0 and n not in names)
        return ws, max_single, other_pinned, ests

    def working_set(self, segments: List[Any], columns: Iterable[str]
                    ) -> Tuple[int, int, int]:
        """(working set, largest segment, bytes other queries pin) that
        ``begin_query`` would admit ``segments`` on now."""
        with self._lock:
            return self._working_set_locked(segments, list(columns))[:3]

    def plan_slices(self, segments: List[Any], columns: Iterable[str],
                    lease: Optional[QueryLease] = None,
                    pad_to: int = 1) -> Optional[List[List[Any]]]:
        """``segments`` cut into slices that each fit the free budget
        (drift-corrected estimates; a k-segment batch stacks
        ``ceil(k / pad_to) * pad_to`` segments). None when one padded
        segment cannot fit: the per-segment sliced path serves."""
        budget = self.budget_bytes
        if budget is None or not segments:
            return [list(segments)]
        cols = list(columns)
        known = lease._est if lease is not None else {}
        with self._lock:
            self._refresh_locked()
            scale = min(max(self._est_scale, _EST_SCALE_MIN),
                        _EST_SCALE_MAX)
            names = {s.segment_name for s in segments}
            other_pinned = sum(e.nbytes for n, e in self._entries.items()
                               if e.pins > 0 and n not in names)
            ests = []
            for s in segments:
                raw = known.get(s.segment_name)
                if raw is None:
                    raw = estimate_segment_bytes(s, cols)
                ests.append(max(1, int(raw * scale)))
        avail = (budget - other_pinned) * _SLICE_FILL
        mean = sum(ests) / len(ests)
        if mean * pad_to > avail:
            return None
        slices: List[List[Any]] = []
        cur: List[Any] = []
        cur_cost = 0.0
        for s, est in zip(segments, ests):
            k = len(cur) + 1
            padded = -(-k // pad_to) * pad_to
            cost = cur_cost + est + (padded - k) * mean
            if cur and cost > avail:
                slices.append(cur)
                cur = [s]
                cur_cost = est
            else:
                cur.append(s)
                cur_cost += est
        if cur:
            slices.append(cur)
        return slices

    def release_slice(self, lease: Optional[QueryLease]) -> None:
        """A slice boundary of a sliced lease: unpin what the slice staged
        and enforce the budget now, so the next slice fits; the evicted
        residents demote, and the next pass promotes them."""
        if lease is None:
            return
        with self._lock:
            for name in lease._pinned:
                e = self._entries.get(name)
                if e is not None and e.pins > 0:
                    e.pins -= 1
            lease._pinned.clear()
            lease.slices += 1
            doomed = self._enforce_locked(lease)
        self._demote_or_release_all(doomed, lease)

    def end_query(self, lease: Optional[QueryLease], stats=None) -> None:
        """Unpin the lease, feed its measured-over-estimated bytes to the
        drift EWMA, enforce the budget, and set ``stats.staging``."""
        if lease is None:
            return
        with self._lock:
            self._refresh_locked()
            for name in lease._pinned:
                e = self._entries.get(name)
                if e is not None and e.pins > 0:
                    e.pins -= 1
                est = lease._est.get(name, 0)
                if est > 0 and e is not None \
                        and isinstance(e.resident, StagedSegment):
                    self._observe_estimate_locked(est, e.nbytes)
            lease._pinned.clear()
            doomed = self._enforce_locked(lease)
            staged = self._staged_bytes
        self._demote_or_release_all(doomed, lease)
        if stats is not None:
            with self._lock:
                host = self._host_bytes
            stats.staging = lease.staging_dict(staged, host)

    # -- estimate drift ----------------------------------------------------------
    def _observe_estimate_locked(self, est: int, measured: int) -> None:
        if est <= 0 or measured <= 0:
            return
        ratio = min(max(measured / est, _EST_SCALE_MIN), _EST_SCALE_MAX)
        self._est_scale = ((1.0 - _EST_ALPHA) * self._est_scale
                           + _EST_ALPHA * ratio)
        self.est_observations += 1

    def observe_estimate(self, est: int, measured: int) -> None:
        """One measured-over-estimated observation into the EWMA."""
        with self._lock:
            self._observe_estimate_locked(est, measured)

    def estimate_scale(self) -> float:
        with self._lock:
            return min(max(self._est_scale, _EST_SCALE_MIN),
                       _EST_SCALE_MAX)

    # -- eviction ---------------------------------------------------------------
    def _refresh_locked(self) -> None:
        total = 0
        for e in self._entries.values():
            e.nbytes = int(e.resident.nbytes())
            total += e.nbytes
        self._staged_bytes = total
        self._peak_bytes = max(self._peak_bytes, total)

    def _rebuild_cost_locked(self, name: str, e: _Entry) -> float:
        """What getting the resident back would cost: one copy from a host
        image; a batch's stacked host arrays; columns borrowed from a
        resident batch holding the segment; a cold column build; the
        star-tree's node arrays on top."""
        if name in self._host_entries:
            return COST_HOST_RESTAGE
        r = e.resident
        if not isinstance(r, StagedSegment):
            return COST_BATCH_RESTAGE
        img = r._host_image
        if img is not None and not img.empty():
            # a promoted resident's unpromoted copies: a demotion keeps
            # them, so its restage stays cheap
            return COST_HOST_RESTAGE
        if r._startree:
            return COST_STARTREE_BUILD
        for other in self._entries:
            if other != name and other.startswith("batch(") \
                    and name in other[6:-1].split(","):
                return COST_BORROWED_BUILD
        return COST_COLUMN_BUILD

    def _enforce_locked(self, lease: Optional[QueryLease] = None
                        ) -> List[Tuple[Optional[str], Any]]:
        """Evict unpinned residents by ``bytes * staleness / rebuild_cost``
        (descending) until the budget fits; -> (name, resident) pairs the
        caller demotes or releases after dropping the lock (their bytes
        are already out of the account)."""
        self._refresh_locked()
        budget = self.budget_bytes
        doomed: List[Tuple[Optional[str], Any]] = []
        total = self._staged_bytes
        if budget is None or total <= budget:
            return doomed
        seq = self._touch_seq + 1
        scores = {name: e.nbytes * (seq - e.touch)
                  / self._rebuild_cost_locked(name, e)
                  for name, e in self._entries.items()}
        for name in sorted(scores, key=scores.get, reverse=True):
            if total <= budget:
                break
            e = self._entries[name]
            if e.pins > 0:
                # an in-flight query reads these arrays
                self.pin_blocked += 1
                self._mark("STAGING_PIN_BLOCKED")
                if lease is not None:
                    lease.pin_blocked += 1
                continue
            del self._entries[name]
            total -= e.nbytes
            doomed.append((name, e.resident))
            self.evictions += 1
            self._mark("STAGING_EVICTIONS")
            if lease is not None:
                lease.evictions += 1
        self._staged_bytes = total
        return doomed

    def release_startree(self, segment_name: str, tree_index: int) -> bool:
        """Drop one star-tree's node arrays from a resident segment, its
        columns and sibling trees staying."""
        with self._lock:
            e = self._entries.get(segment_name)
            if e is None or not isinstance(e.resident, StagedSegment):
                return False
            freed = e.resident.release_startree(tree_index)
            if freed:
                self._refresh_locked()
        return freed > 0

    # -- prefetch ---------------------------------------------------------------
    def prefetch(self, segment, columns: Optional[List[str]] = None) -> None:
        """Stage ``segment`` in the background: its columns (all of them by
        default) and star-trees, stopping when the budget is full rather
        than evicting."""
        if self._closed or is_mutable(segment):
            return
        with self._lock:
            # read under the lock evict() bumps it under
            gen = self._retired.get(segment.segment_name, 0)
            if self._prefetch_thread is None:
                self._prefetch_q = queue.Queue()
                self._prefetch_thread = threading.Thread(
                    target=self._prefetch_loop, daemon=True,
                    name="hbm-prefetch")
                self._prefetch_thread.start()
        self._prefetch_q.put((segment, columns, gen))

    def _prefetch_loop(self) -> None:
        while True:
            item = self._prefetch_q.get()
            try:
                if item is _STOP:
                    return
                self._prefetch_one(*item)
            except Exception:
                log.exception("prefetch failed")
            finally:
                self._prefetch_q.task_done()

    def _full(self, budget: Optional[int]) -> bool:
        if budget is None:
            return False
        with self._lock:
            self._refresh_locked()
            return self._staged_bytes >= budget

    def _prefetch_one(self, segment, columns: Optional[List[str]],
                      gen: int) -> None:
        budget = self.budget_bytes
        name = segment.segment_name
        if columns is None:
            columns = list(segment.metadata.columns.keys())
        with self._lock:
            # a removal that landed while this item waited wins
            if self._retired.get(name, 0) != gen:
                return
            staged, doomed = self._stage_locked(segment, None)
        self._demote_or_release_all(doomed)
        for cname in columns:
            if self._full(budget):
                return
            staged.column(cname)
        md = getattr(segment, "metadata", None)
        for ti in range(int(getattr(md, "star_tree_count", 0) or 0)):
            if self._full(budget):
                return
            staged.startree_nodes(ti)
        orphaned = None
        with self._lock:
            if self._retired.get(name, 0) != gen:
                # evicted while its columns staged: the entry is gone, drop
                # these arrays now (a re-added segment has its own resident)
                e = self._entries.get(name)
                if e is None or e.resident is not staged:
                    orphaned = staged
            else:
                self.prefetched += 1
                self._refresh_locked()
        if orphaned is not None:
            orphaned.release()

    def drain_prefetch(self) -> None:
        """Block until the queued prefetches are done."""
        q = self._prefetch_q
        if q is not None:
            q.join()

    def close(self) -> None:
        self._closed = True
        if self._prefetch_q is not None:
            self._prefetch_q.put(_STOP)

    # -- observability ------------------------------------------------------------
    def bind_metrics(self, registry) -> None:
        """Attach a MetricsRegistry: both tiers' byte gauges, and the
        meters (``ServerMeter.STAGING_*``) every later event marks."""
        self._metrics = registry
        # gauges run on the scraping thread: only locked accessors here
        registry.gauge("staging_staged_bytes",
                       lambda: float(self.staged_bytes()))
        registry.gauge("staging_peak_bytes",
                       lambda: float(self._peak_bytes))
        registry.gauge("staging_budget_bytes",
                       lambda: float(self.budget_bytes or 0))
        registry.gauge("staging_resident_segments",
                       lambda: float(len(self.resident_names())))
        registry.gauge("staging_host_bytes",
                       lambda: float(self.host_bytes()))
        registry.gauge("staging_host_peak_bytes",
                       lambda: float(self._host_peak_bytes))
        registry.gauge("staging_host_budget_bytes",
                       lambda: float(self.host_budget_bytes or 0))
        registry.gauge("staging_host_entries",
                       lambda: float(self.host_entry_count()))
        # both tiers' bytes as gauge rings (JAX :1141-1150). The sampler
        # reads the last measured totals without the manager's lock, which
        # the query path holds while it notes storm events
        TELEMETRY.track_gauge("staging.staged_bytes",
                              lambda: float(self._staged_bytes))
        TELEMETRY.track_gauge("staging.host_bytes",
                              lambda: float(self._host_bytes))

    def _mark(self, name: str) -> None:
        # the flight recorder's storm feed, bound or not (JAX :1152-1164):
        # note_storm_event only records a pending trigger, so it is safe
        # under the manager's lock
        note_storm_event(name)
        if self._metrics is not None:
            self._metrics.meter(getattr(ServerMeter, name)).mark()

    def staged_bytes(self) -> int:
        with self._lock:
            self._refresh_locked()
            return self._staged_bytes

    def host_bytes(self) -> int:
        with self._lock:
            return self._host_bytes

    def resident_nbytes(self, name: str) -> int:
        """Measured device bytes of one resident (0 when absent)."""
        with self._lock:
            self._refresh_locked()
            e = self._entries.get(name)
            return 0 if e is None else e.nbytes

    def resident_names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def residents(self) -> List[Tuple[str, Any]]:
        """(name, resident) of the device tier, least recently used
        first."""
        with self._lock:
            return [(n, e.resident) for n, e in self._entries.items()]

    def host_entry_count(self) -> int:
        with self._lock:
            return len(self._host_entries)

    def host_entry_names(self) -> List[str]:
        with self._lock:
            return list(self._host_entries)

    def stats_snapshot(self) -> Dict[str, Any]:
        """Cumulative counters (a run diffs two of these)."""
        with self._lock:
            self._refresh_locked()
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "pinBlockedEvictions": self.pin_blocked,
                "spills": self.spills,
                "prefetched": self.prefetched,
                "borrows": self.borrows,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "hostDrops": self.host_drops,
                "slicedQueries": self.sliced_queries,
                "stagedBytes": self._staged_bytes,
                "peakBytes": self._peak_bytes,
                "hostBytes": self._host_bytes,
                "hostPeakBytes": self._host_peak_bytes,
                "demotedBytes": self.demoted_bytes,
                "promotedBytes": self.promoted_bytes,
                "hostDroppedBytes": self.host_dropped_bytes,
                "estimateScale": round(self._est_scale, 4),
                "estimateObservations": self.est_observations,
            }

    def snapshot(self) -> Dict[str, Any]:
        """Both tiers, byte for byte."""
        with self._lock:
            self._refresh_locked()
            residents = {}
            for name, e in self._entries.items():
                d: Dict[str, Any] = {"bytes": e.nbytes, "pins": e.pins}
                r = e.resident
                if isinstance(r, StagedSegment):
                    d.update(columns=len(r._columns), packed=len(r._packed),
                             values=len(r._values),
                             startrees=len(r._startree),
                             startreeBytes={str(ti): b for ti, b in
                                            r.startree_nbytes().items()})
                else:
                    d["kind"] = type(r).__name__
                residents[name] = d
            host = {name: {"bytes": e.nbytes,
                           "kind": type(e.resident).__name__}
                    for name, e in self._host_entries.items()}
            return {
                "budgetBytes": self.budget_bytes,
                "stagedBytes": self._staged_bytes,
                "peakBytes": self._peak_bytes,
                "counters": {
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "pinBlockedEvictions": self.pin_blocked,
                    "spills": self.spills, "prefetched": self.prefetched,
                    "borrows": self.borrows,
                    "demotions": self.demotions,
                    "promotions": self.promotions,
                    "hostDrops": self.host_drops,
                    "slicedQueries": self.sliced_queries,
                },
                "stagedSegments": residents,
                "hostTier": {
                    "enabled": self._host_on,
                    "budgetBytes": self.host_budget_bytes,
                    "hostBytes": self._host_bytes,
                    "peakBytes": self._host_peak_bytes,
                    "demotedBytes": self.demoted_bytes,
                    "promotedBytes": self.promoted_bytes,
                    "droppedBytes": self.host_dropped_bytes,
                    "entries": host,
                },
                "estimateScale": round(self._est_scale, 4),
            }


__all__ = ["AUTO", "COST_BORROWED_BUILD", "QueryLease", "ResidencyManager",
           "estimate_segment_bytes", "resolve_budget_bytes",
           "resolve_host_budget_bytes"]
