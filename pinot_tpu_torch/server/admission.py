"""Admission gate: bounded concurrency and a bounded queue above execution.

Counterpart of ``pinot_tpu/server/admission.py`` (``AdmissionGate`` :55):
load above the bound degrades to bounded-latency rejection, never to a
convoy where every query waits for everyone else's. One gate fronts one
executor. ``admit`` either passes at once (a slot is free), waits for a
slot (bounded by the queue depth and by the wait time), or raises a typed,
retriable ``QueryRejectedError`` with the queue depth it saw and its
``reason`` (``queue_full`` or ``wait_expired``). The residency lease opens
only after admission and closes in the caller's ``finally``, so a rejected
query holds no pins.

An optional ``QueryQuotaManager`` (``broker/quota.py``, ``quota=``) folds
the per-table QPS quota into the same gate at the broker's front door: a
table over its quota is the same typed rejection with ``reason="quota"``.
``bind_metrics`` marks the admitted and rejected meters
(``ServerMeter.ADMISSION_*``) and adds the in-flight and queue-depth
gauges to a registry. Each admission's wait goes to the table's windowed
``admission_wait`` histogram and each rejection to the flight recorder's
burst trigger (``common/telemetry.py``, JAX :137-145, :202-207); the
queue depth and the rejections are gauge rings (JAX :225-237).
"""

from __future__ import annotations

import os
import threading
import time

from typing import Any, Dict, Optional

from pinot_tpu_torch.common.telemetry import TELEMETRY
from pinot_tpu_torch.engine.errors import QueryRejectedError
from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration
from pinot_tpu_torch.spi.metrics import ServerMeter


def _auto_concurrent() -> int:
    return max(8, 2 * (os.cpu_count() or 1))


class _Ticket:
    """One admission; ``release`` through the gate is idempotent.
    ``wait_ms`` is the queue wait this admission paid."""

    __slots__ = ("released", "gated", "wait_ms")

    def __init__(self, gated: bool, wait_ms: float = 0.0):
        self.released = False
        self.gated = gated
        self.wait_ms = wait_ms


class AdmissionGate:
    """Bounded slots and a bounded queue, with typed rejection.

    ``max_concurrent``: executing-query slots (0 = auto from the cpu count,
    < 0 = gate disabled, every admit passes). ``max_queue``: waiters
    allowed behind the slots (0 = auto, 8x the slots; < 0 = no queue, a
    full gate rejects at once). ``max_wait_ms``: a waiter past this bound
    is rejected."""

    def __init__(self, max_concurrent: int = 0, max_queue: int = 0,
                 max_wait_ms: float = 10_000.0, quota=None,
                 name: str = "query-admission"):
        self._name = name
        self._quota = quota
        self._cond = threading.Condition()
        self._slots = 0  # guarded-by-writes: _cond
        self._max_queue = 0  # guarded-by-writes: _cond
        self._max_wait_s = 0.0  # guarded-by-writes: _cond
        self._inflight = 0  # guarded-by-writes: _cond
        self._waiting = 0  # guarded-by-writes: _cond
        # cumulative counters (a run diffs two stats_snapshot() calls)
        self.admitted = 0  # guarded-by-writes: _cond
        self.rejected_queue_full = 0  # guarded-by-writes: _cond
        self.rejected_wait_expired = 0  # guarded-by-writes: _cond
        self.rejected_quota = 0  # guarded-by-writes: _cond
        self.max_queue_depth_seen = 0  # guarded-by-writes: _cond
        self.queue_wait_ms_total = 0.0  # guarded-by-writes: _cond
        self.queue_wait_ms_max = 0.0  # guarded-by-writes: _cond
        self._metrics = None
        self.configure(max_concurrent=max_concurrent, max_queue=max_queue,
                       max_wait_ms=max_wait_ms)

    @classmethod
    def from_config(cls, config=None, quota=None,
                    name: str = "query-admission") -> "AdmissionGate":
        cfg = config if config is not None else PinotConfiguration()
        return cls(
            max_concurrent=cfg.get_int(
                CommonConstants.ADMISSION_MAX_CONCURRENT_KEY,
                CommonConstants.DEFAULT_ADMISSION_MAX_CONCURRENT),
            max_queue=cfg.get_int(
                CommonConstants.ADMISSION_MAX_QUEUE_KEY,
                CommonConstants.DEFAULT_ADMISSION_MAX_QUEUE),
            max_wait_ms=cfg.get_float(
                CommonConstants.ADMISSION_MAX_WAIT_MS_KEY,
                CommonConstants.DEFAULT_ADMISSION_MAX_WAIT_MS),
            quota=quota, name=name)

    def configure(self, max_concurrent: Optional[int] = None,
                  max_queue: Optional[int] = None,
                  max_wait_ms: Optional[float] = None) -> None:
        """Re-bound the gate at runtime; waiters re-evaluate against the
        new bounds."""
        with self._cond:
            if max_concurrent is not None:
                mc = int(max_concurrent)
                self._slots = mc if mc != 0 else _auto_concurrent()
            if max_queue is not None:
                mq = int(max_queue)
                self._max_queue = (8 * max(self._slots, 1) if mq == 0
                                   else max(mq, 0))
            if max_wait_ms is not None:
                self._max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
            self._cond.notify_all()

    @property
    def enabled(self) -> bool:
        return self._slots > 0

    def admit(self, table: str = "") -> _Ticket:
        """Admit one query (blocking, bounded) or raise
        ``QueryRejectedError``. The ticket must be released in a
        ``finally``."""
        if self._quota is not None and table \
                and not self._quota.acquire(table):
            with self._cond:
                self.rejected_quota += 1
                depth = self._waiting
            self._mark("ADMISSION_REJECTED")
            TELEMETRY.note_rejection(table)
            raise QueryRejectedError(
                f"query quota exceeded for table {table}",
                queue_depth=depth, reason="quota")
        if self._slots <= 0:    # disabled: count, never queue
            with self._cond:
                self.admitted += 1
            self._mark("ADMISSION_ADMITTED")
            return _Ticket(gated=False)
        t0 = time.monotonic()
        reject = None
        wait_ms = 0.0
        with self._cond:
            if self._inflight >= self._slots \
                    and self._waiting >= self._max_queue:
                self.rejected_queue_full += 1
                reject = ("queue_full",
                          f"admission queue full ({self._waiting} waiting, "
                          f"{self._slots} slots) for {self._name}",
                          self._waiting)
            else:
                deadline = t0 + self._max_wait_s
                self._waiting += 1
                self.max_queue_depth_seen = max(self.max_queue_depth_seen,
                                                self._waiting)
                try:
                    while self._inflight >= self._slots:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            self.rejected_wait_expired += 1
                            reject = (
                                "wait_expired",
                                f"admission wait bound "
                                f"{self._max_wait_s * 1e3:.0f} ms expired "
                                f"({self._waiting} waiting) for "
                                f"{self._name}", self._waiting)
                            # a release's notify may have woken this dying
                            # waiter: pass it on, or another waiter sleeps
                            # out its bound on a free slot
                            self._cond.notify()
                            break
                        self._cond.wait(remaining)
                finally:
                    self._waiting -= 1
                if reject is None:
                    self._inflight += 1
                    self.admitted += 1
                    wait_ms = (time.monotonic() - t0) * 1e3
                    self.queue_wait_ms_total += wait_ms
                    self.queue_wait_ms_max = max(self.queue_wait_ms_max,
                                                 wait_ms)
        if reject is not None:
            reason, msg, depth = reject
            self._mark("ADMISSION_REJECTED")
            # a burst of rejections trips the flight recorder (one is load
            # shedding working)
            TELEMETRY.note_rejection(table)
            raise QueryRejectedError(msg, queue_depth=depth, reason=reason)
        self._mark("ADMISSION_ADMITTED")
        TELEMETRY.observe(table or "", "admission_wait", wait_ms)
        return _Ticket(gated=True, wait_ms=wait_ms)

    def release(self, ticket: Optional[_Ticket]) -> None:
        """Free the ticket's slot (idempotent; None is a no-op)."""
        if ticket is None or ticket.released:
            return
        ticket.released = True
        if not ticket.gated:
            return
        with self._cond:
            if self._inflight > 0:
                self._inflight -= 1
            self._cond.notify()

    # -- observability ----------------------------------------------------------
    def bind_metrics(self, registry) -> None:
        """The in-flight and queue-depth gauges, and the meters every later
        admission and rejection marks."""
        self._metrics = registry
        # gauges run on the scraping thread: single ints, read unlocked
        registry.gauge("admission_inflight", lambda: float(self._inflight))
        registry.gauge("admission_queue_depth",
                       lambda: float(self._waiting))
        # gauge rings: the queue depth and the rejections so far (their
        # rate is the ring's slope)
        TELEMETRY.track_gauge(f"{self._name}.queue_depth",
                              lambda: float(self._waiting))
        TELEMETRY.track_gauge(
            f"{self._name}.rejected",
            lambda: float(self.rejected_queue_full
                          + self.rejected_wait_expired
                          + self.rejected_quota))

    def _mark(self, name: str) -> None:
        if self._metrics is None:
            return
        metric = getattr(ServerMeter, name, None)
        if metric is not None:
            self._metrics.meter(metric).mark()

    def stats_snapshot(self) -> Dict[str, float]:
        """Cumulative counters."""
        with self._cond:
            return {
                "admitted": self.admitted,
                "rejectedQueueFull": self.rejected_queue_full,
                "rejectedWaitExpired": self.rejected_wait_expired,
                "rejectedQuota": self.rejected_quota,
                "rejected": (self.rejected_queue_full
                             + self.rejected_wait_expired
                             + self.rejected_quota),
                "maxQueueDepth": self.max_queue_depth_seen,
                "queueWaitMsTotal": round(self.queue_wait_ms_total, 3),
                "queueWaitMsMax": round(self.queue_wait_ms_max, 3),
            }

    def snapshot(self) -> Dict[str, Any]:
        """Bounds, live depth and counters."""
        out: Dict[str, Any] = self.stats_snapshot()
        with self._cond:
            out.update(enabled=self._slots > 0, maxConcurrent=self._slots,
                       maxQueue=self._max_queue,
                       maxWaitMs=round(self._max_wait_s * 1e3, 3),
                       inflight=self._inflight, queued=self._waiting)
        return out


__all__ = ["AdmissionGate"]
