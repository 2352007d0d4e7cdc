"""The server's worker pool and its query schedulers.

Counterpart of ``pinot_tpu/server/scheduler.py``:

- ``WorkerPool`` (:23-95): one pool per executor, shared by every query in
  flight, so a query's segment fan-out pays no thread spawn and the thread
  count is a server-level bound;
- the query schedulers (:97-512) a ``ServerInstance`` answers through:
  ``FcfsScheduler`` (plain pool order), ``TokenBucketScheduler`` (per-table
  token buckets), ``PriorityScheduler`` (per-table queues, the lowest
  weighted cost first) and ``SewfScheduler`` (shortest expected work
  first: per-shape latency EWMAs order the queue, an age boost bounds how
  long an expensive shape waits), built by ``make_scheduler`` from
  ``pinot.server.query.runner.threads`` (default 8) and
  ``pinot.server.query.scheduler.policy`` (default ``sewf``).

The JAX schedulers also feed the process telemetry (the windowed
scheduler-wait histogram); that waits for the telemetry slice.
"""

from __future__ import annotations

import functools
import queue
import threading
import time

from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

from pinot_tpu_torch.spi.config import CommonConstants


class _DaemonPool:
    """Fixed pool of daemon threads: a query stuck in a long kernel build
    never blocks process exit."""

    def __init__(self, num_workers: int, name: str):
        self._q: "queue.Queue" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"{name}-{i}")
            for i in range(num_workers)]
        for t in self._threads:
            t.start()

    def _work(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, on_skip = item
            if not fut.set_running_or_notify_cancel():
                # cancelled while queued: its bookkeeping (in-flight
                # counts) still runs, or a shutdown waits on it forever
                if on_skip is not None:
                    on_skip()
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - the future holds it
                fut.set_exception(e)

    def submit(self, fn: Callable[[], Any],
               on_skip: Optional[Callable[[], None]] = None) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn, on_skip))
        return fut

    def qsize(self) -> int:
        return self._q.qsize()

    def stop(self) -> None:
        for _ in self._threads:
            self._q.put(None)


class WorkerPool:
    """Persistent segment fan-out pool (``pinot.server.query.worker
    .threads``)."""

    def __init__(self, num_workers: int, name: str = "pqw"):
        self.num_workers = max(1, int(num_workers))
        self._pool = _DaemonPool(self.num_workers, name)

    def map(self, fn, *iterables) -> list:
        """Results in order; the first task's exception propagates."""
        futs = [self._pool.submit(functools.partial(fn, *args))
                for args in zip(*iterables)]
        return [f.result() for f in futs]

    def stop(self) -> None:
        self._pool.stop()


class QueryScheduler:
    """Base: a bounded worker pool, drained on shutdown. ``shape`` on
    ``submit`` is an optional query-shape key (table + normalized SQL);
    FCFS/token-bucket policies ignore it, the SEWF policy orders by it."""

    def __init__(self, num_workers: int = 8, name: str = "query"):
        self.num_workers = max(1, int(num_workers))
        self._pool = _DaemonPool(self.num_workers, name)
        self._accepting = True  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)

    def submit(self, fn: Callable[[], Any], table: str = "",
               shape: Any = None) -> Future:
        with self._lock:
            if not self._accepting:
                raise RuntimeError("scheduler is shut down")
            self._inflight += 1

        def done():
            with self._lock:
                self._inflight -= 1
                self._drained.notify_all()

        t_submit = time.perf_counter()

        def run():
            self._note_wait((time.perf_counter() - t_submit) * 1e3,
                            table=table)
            try:
                return fn()
            finally:
                done()

        return self._pool.submit(run, on_skip=done)

    def _note_wait(self, wait_ms: float, table: str = "") -> None:
        """Scheduler-queue wait totals (``scheduler_debug``), initialized
        lazily so the schedulers that own their queues (priority, SEWF)
        share them without the base ``__init__``."""
        with self._lock:
            self.queue_waits = getattr(self, "queue_waits", 0) + 1
            self.queue_wait_ms_total = \
                getattr(self, "queue_wait_ms_total", 0.0) + wait_ms
            if wait_ms > getattr(self, "queue_wait_ms_max", 0.0):
                self.queue_wait_ms_max = wait_ms

    def queue_depth(self) -> int:
        return self._pool.qsize()

    def stats_snapshot(self) -> Dict[str, Any]:
        """``/debug/scheduler`` body: live policy/queue/in-flight state."""
        with self._lock:
            inflight = self._inflight
            waits = getattr(self, "queue_waits", 0)
            wait_total = getattr(self, "queue_wait_ms_total", 0.0)
            wait_max = getattr(self, "queue_wait_ms_max", 0.0)
        return {"policy": type(self).__name__,
                "workers": self.num_workers,
                "inflight": inflight,
                "queued": self.queue_depth(),
                "queueWaits": waits,
                "queueWaitMsTotal": round(wait_total, 3),
                "queueWaitMsMax": round(wait_max, 3)}

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Refuse new queries and drain the ones in flight (a server's
        shutdown: disable queries, drain, unregister)."""
        with self._lock:
            self._accepting = False
            deadline = time.monotonic() + timeout_s
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._drained.wait(remaining)
        self._pool.stop()


class FcfsScheduler(QueryScheduler):
    """Plain pool order (the reference's FCFSQueryScheduler)."""


class TokenBucketScheduler(QueryScheduler):
    """Per-table token buckets: a table spends a token a query, and an
    exhausted table's queries wait for the refill, so one hot table cannot
    starve the rest."""

    def __init__(self, num_workers: int = 8, tokens_per_second: float = 100.0,
                 burst: float = 200.0):
        super().__init__(num_workers, name="tb-query")
        self._rate = tokens_per_second
        self._burst = burst
        # table -> (tokens, last_ts)
        self._buckets: Dict[str, tuple] = {}  # guarded-by: _bucket_lock
        self._bucket_lock = threading.Lock()

    def _take_token(self, table: str) -> float:
        """Returns seconds to wait (0 = admitted now)."""
        now = time.monotonic()
        with self._bucket_lock:
            tokens, last = self._buckets.get(table, (self._burst, now))
            tokens = min(self._burst, tokens + (now - last) * self._rate)
            if tokens >= 1.0:
                self._buckets[table] = (tokens - 1.0, now)
                return 0.0
            wait = (1.0 - tokens) / self._rate
            self._buckets[table] = (0.0, now + wait)
            return wait

    def submit(self, fn: Callable[[], Any], table: str = "",
               shape: Any = None) -> Future:
        wait = self._take_token(table) if table else 0.0
        if wait <= 0:
            return super().submit(fn, table, shape=shape)

        def delayed():
            time.sleep(wait)
            return fn()

        return super().submit(delayed, table, shape=shape)


class PriorityScheduler(QueryScheduler):
    """Multi-level priority queue with per-table fairness (the reference's
    MultiLevelPriorityQueue): a fixed worker pool pops from per-table
    queues; the next queue is the
    one with the LOWEST in-progress+pending cost share, scaled by the
    table's priority weight, so a flood from one table cannot starve
    others and high-priority tables drain first under contention."""

    def __init__(self, num_workers: int = 8,
                 table_priorities: Optional[Dict[str, float]] = None):
        # intentionally does NOT call super().__init__: this scheduler owns
        # its queues instead of a shared _DaemonPool queue
        self.num_workers = max(1, int(num_workers))
        self._accepting = True  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._priorities = dict(table_priorities or {})
        self._queues: Dict[str, "queue.Queue"] = {}  # guarded-by: _lock
        self._costs: Dict[str, float] = {}  # guarded-by: _lock
        self._available = threading.Semaphore(0)
        self._stop = False  # guarded-by: _lock
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"prio-query-{i}")
            for i in range(num_workers)]
        for t in self._threads:
            t.start()

    def _pick_table_locked(self) -> Optional[str]:
        """Lowest weighted cost wins (the multi-level 'wakeup' choice).
        Caller holds ``_lock`` (the ``_locked`` suffix is the lint
        convention for that contract)."""
        best, best_score = None, None
        for table, q in self._queues.items():
            if q.empty():
                continue
            weight = max(self._priorities.get(table, 1.0), 1e-6)
            score = self._costs.get(table, 0.0) / weight
            if best_score is None or score < best_score:
                best, best_score = table, score
        return best

    def _work(self) -> None:
        while True:
            self._available.acquire()
            with self._lock:
                if self._stop and all(q.empty()
                                      for q in self._queues.values()):
                    return
                table = self._pick_table_locked()
                if table is None:
                    continue
                fut, fn = self._queues[table].get_nowait()
            done = self._finish(table)
            if not fut.set_running_or_notify_cancel():
                done()  # cancelled while queued: release its cost+inflight
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — future carries it
                fut.set_exception(e)
            finally:
                done()

    def _finish(self, table: str) -> Callable[[], None]:
        """One-shot completion: releases the table's cost share (cost =
        pending + in-progress, so it DECAYS — a long-lived table must not
        be starved by newly-seen tables) and the drain counter."""
        fired = [False]

        def done():
            if fired[0]:
                return
            fired[0] = True
            with self._lock:
                self._costs[table] = max(
                    self._costs.get(table, 1.0) - 1.0, 0.0)
                self._inflight -= 1
                self._drained.notify_all()

        return done

    def submit(self, fn: Callable[[], Any], table: str = "",
               shape: Any = None) -> Future:
        fut: Future = Future()
        with self._lock:
            if not self._accepting:
                raise RuntimeError("scheduler is shut down")
            self._inflight += 1
            self._costs[table] = self._costs.get(table, 0.0) + 1.0
            self._queues.setdefault(table, queue.Queue()).put((fut, fn))
        self._available.release()
        return fut

    def queue_depth(self) -> int:
        with self._lock:
            return sum(q.qsize() for q in self._queues.values())

    def shutdown(self, timeout_s: float = 30.0) -> None:
        with self._lock:
            self._accepting = False
            deadline = time.monotonic() + timeout_s
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._drained.wait(remaining)
            self._stop = True
        for _ in self._threads:
            self._available.release()


class SewfScheduler(QueryScheduler):
    """Shortest-expected-work-first with an age-based anti-starvation
    boost — the two-level dispatch policy for mixed dashboard traffic.

    Each query shape (table + normalized SQL passed as ``submit(...,
    shape=)``) keeps a latency EWMA from its own completions. Workers pop
    the pending entry with the lowest ``expected_ms - age_ms *
    aging_boost``: cheap shapes overtake expensive scans (a 10 ms Q2.1
    stops waiting behind a 400 ms Q4.x convoy), while the age term
    guarantees an expensive query deferred ``expected_diff / aging_boost``
    milliseconds runs next regardless of what keeps arriving. Unknown
    shapes score as zero expected work — run soon, then their own EWMA
    places them."""

    EWMA_ALPHA = 0.25

    def __init__(self, num_workers: int = 8, aging_boost: float = 2.0):
        # owns its own ordered queue instead of the base _DaemonPool FIFO
        self.num_workers = max(1, int(num_workers))
        self.aging_boost = float(aging_boost)
        self._accepting = True  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        # pending entries: (enqueue_ts, shape, fut, fn)
        self._pending: list = []  # guarded-by: _lock
        self._ewma_ms: Dict[Any, float] = {}  # guarded-by: _lock
        self.starvation_boosts = 0  # guarded-by: _lock
        self._available = threading.Semaphore(0)
        self._stop = False  # guarded-by: _lock
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"sewf-query-{i}")
            for i in range(self.num_workers)]
        for t in self._threads:
            t.start()

    def _score_locked(self, entry, now: float) -> float:
        t_enq, shape, _fut, _fn = entry
        expected = self._ewma_ms.get(shape, 0.0)
        return expected - (now - t_enq) * 1e3 * self.aging_boost

    def _pick_locked(self):
        """Pop the lowest-scoring pending entry (caller holds ``_lock``).
        O(pending) scan — queue depths here are bounded by the admission
        gate, so a heap's reordering complexity buys nothing."""
        if not self._pending:
            return None
        now = time.monotonic()
        best_i = 0
        best_s = None
        for i, entry in enumerate(self._pending):
            s = self._score_locked(entry, now)
            if best_s is None or s < best_s:
                best_i, best_s = i, s
        entry = self._pending.pop(best_i)
        # an entry that won on age rather than expected work is a
        # starvation-boost event (the anti-starvation half working)
        if best_i != 0 and self._ewma_ms.get(entry[1], 0.0) \
                >= max(self._ewma_ms.get(e[1], 0.0)
                       for e in self._pending + [entry]):
            self.starvation_boosts += 1
        return entry

    def _work(self) -> None:
        while True:
            self._available.acquire()
            with self._lock:
                if self._stop and not self._pending:
                    return
                entry = self._pick_locked()
            if entry is None:
                continue
            _t_enq, shape, fut, fn = entry
            table = shape[0] if isinstance(shape, tuple) and shape \
                and isinstance(shape[0], str) else \
                (shape if isinstance(shape, str) else "")
            self._note_wait((time.monotonic() - _t_enq) * 1e3, table=table)
            if not fut.set_running_or_notify_cancel():
                self._done(shape, None)  # cancelled while queued
                continue
            t0 = time.perf_counter()
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — future carries it
                fut.set_exception(e)
            finally:
                self._done(shape, (time.perf_counter() - t0) * 1e3)

    def _done(self, shape: Any, ms: Optional[float]) -> None:
        with self._lock:
            if ms is not None and shape is not None:
                e = self._ewma_ms.get(shape)
                self._ewma_ms[shape] = ms if e is None else \
                    self.EWMA_ALPHA * ms + (1 - self.EWMA_ALPHA) * e
                if len(self._ewma_ms) > 4096:
                    # shape churn bound: drop ~half, newest keep their EWMA
                    for k in list(self._ewma_ms)[:2048]:
                        del self._ewma_ms[k]
            self._inflight -= 1
            self._drained.notify_all()

    def submit(self, fn: Callable[[], Any], table: str = "",
               shape: Any = None) -> Future:
        fut: Future = Future()
        with self._lock:
            if not self._accepting:
                raise RuntimeError("scheduler is shut down")
            self._inflight += 1
            self._pending.append((time.monotonic(),
                                  shape if shape is not None else table,
                                  fut, fn))
        self._available.release()
        return fut

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def expected_ms(self, shape: Any) -> Optional[float]:
        with self._lock:
            return self._ewma_ms.get(shape)

    def stats_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"policy": type(self).__name__,
                    "workers": self.num_workers,
                    "inflight": self._inflight,
                    "queued": len(self._pending),
                    "shapesTracked": len(self._ewma_ms),
                    "starvationBoosts": self.starvation_boosts,
                    "agingBoost": self.aging_boost,
                    "queueWaits": getattr(self, "queue_waits", 0),
                    "queueWaitMsTotal": round(
                        getattr(self, "queue_wait_ms_total", 0.0), 3),
                    "queueWaitMsMax": round(
                        getattr(self, "queue_wait_ms_max", 0.0), 3)}

    def shutdown(self, timeout_s: float = 30.0) -> None:
        with self._lock:
            self._accepting = False
            deadline = time.monotonic() + timeout_s
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._drained.wait(remaining)
            self._stop = True
        for _ in self._threads:
            self._available.release()


def make_scheduler(policy: str = "fcfs", config=None, **kw) -> QueryScheduler:
    """The scheduler of ``policy``. ``config`` sizes the runner pool from
    ``pinot.server.query.runner.threads`` unless the caller passed
    ``num_workers``."""
    if config is not None and "num_workers" not in kw:
        kw["num_workers"] = max(1, config.get_int(
            CommonConstants.RUNNER_THREADS_KEY,
            CommonConstants.DEFAULT_RUNNER_THREADS))
    policy = policy.lower()
    if policy == "fcfs":
        return FcfsScheduler(**kw)
    if policy in ("tokenbucket", "token_bucket"):
        return TokenBucketScheduler(**kw)
    if policy == "priority":
        return PriorityScheduler(**kw)
    if policy in ("sewf", "shortest", "sjf"):
        return SewfScheduler(**kw)
    raise ValueError(f"unknown scheduler policy {policy!r}")


__all__ = ["WorkerPool", "QueryScheduler", "FcfsScheduler",
           "TokenBucketScheduler", "PriorityScheduler", "SewfScheduler",
           "make_scheduler"]
