"""Launch coalescing: concurrent queries' batch launches share one launch.

Counterpart of ``pinot_tpu/parallel/launcher.py`` (``LaunchKernel``,
``_LaunchRequest``, ``LaunchScheduler`` :140-473, ``launcher_for_mesh``).
A query never launches its batch scan itself: it submits a request
(``LaunchKernel``, its bound parameters, ``num_docs``) to the device's
``LaunchScheduler`` and waits on a future. One dispatcher thread per
device drains the queue, so the device's launches are totally ordered,
and while one group runs the next requests pile up. The dispatcher groups
them by ``LaunchKernel.key`` (the literal-normalized identity: same
kernel, same staged batch, same layout):

- requests whose parameters are the same object (exact repeats, served
  one bound query by the executor's param cache) share one launch and one
  result (dedup);
- distinct parameter sets of a kernel with a ``many`` form run as one
  launch of it, up to ``max_batch`` a launch: the fused scan's query axis
  (``combine.sharded_fused_scan_many``), where JAX vmaps the sharded
  Pallas call. Q is not padded to a power of two: a CUDA launch has no
  compile variants to bound;
- a kernel without a ``many`` form (the jnp combine) runs its distinct
  parameter sets one after another on the dispatcher.

A launch that fails raises in every request that rode it: there is no
fallback to serial launches (JAX :337-352), which would hide a failed
kernel. A failure outside the launches completes every waiter's future
with it, and the next submit starts a new dispatcher. While arrivals are
hot (their EWMA gap under ``window_hot_ms``) and overlap (requests arrive
while others are pending), the dispatcher holds up to ``window_max_ms``
for stragglers before it groups; idle traffic, and one client whose
next query waits for its last, wait nothing (the JAX dispatcher holds
for any hot stream, a lone fast client included). Kernel calls return
host results, and the dispatcher waits for the device's stream before it
completes the futures (JAX's ``block_until_ready`` at :364).
``bind_metrics`` (JAX :416-436) adds a server's registry: every bound
registry gets the ``ServerMeter.LAUNCH*`` marks (several in-process
servers may share one device's scheduler) and the queue gauges.
"""

from __future__ import annotations

import logging
import threading
import time

from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from pinot_tpu_torch.spi.metrics import ServerMeter

log = logging.getLogger(__name__)

# share of recent arrivals that found another request pending, under which
# the window never holds
_OVERLAP_MIN = 0.1


class LaunchKernel:
    """One coalescable launch. ``call(params, num_docs)`` is the solo
    form; ``many(params_list, num_docs)``, where given, runs several
    parameter sets in one launch and returns one result each. ``key`` is
    what two requests must share to ride one launch."""

    __slots__ = ("key", "call", "many", "max_batch")

    def __init__(self, key: Tuple, call: Callable,
                 many: Optional[Callable] = None, max_batch: int = 8):
        self.key = key
        self.call = call
        self.many = many
        self.max_batch = max(1, int(max_batch))

    @property
    def batchable(self) -> bool:
        return self.many is not None and self.max_batch > 1

    def run_one(self, params, num_docs):
        return self.call(params, num_docs)

    def run_many(self, params_list: List[Any], num_docs) -> List[Any]:
        out = self.many(params_list, num_docs)
        if len(out) != len(params_list):
            raise RuntimeError(f"{self.key[:1]}: {len(out)} results for "
                               f"{len(params_list)} parameter sets")
        return out


class _LaunchRequest:
    """One query's pending launch and its coalescing outcome (what the
    executor copies into ``QueryStats.launch``)."""

    __slots__ = ("kernel", "params", "num_docs", "future", "t_submit",
                 "batch_size", "queue_wait_ms", "launches_saved", "deduped")

    def __init__(self, kernel: LaunchKernel, params, num_docs):
        self.kernel = kernel
        self.params = params
        self.num_docs = num_docs
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.batch_size = 1
        self.queue_wait_ms = 0.0
        self.launches_saved = 0
        self.deduped = False

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)


class LaunchScheduler:
    """One dispatcher thread owning every batch launch of one device."""

    def __init__(self, name: str = "combine-launch",
                 device: Union[str, torch.device, None] = None):
        self._name = name
        self.device = torch.device(device) if device is not None else None
        self._queue: "deque[_LaunchRequest]" = deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.window_max_ms = 1.0
        self.window_hot_ms = 2.0
        self._arrival_ewma_ms: Optional[float] = None
        self._last_arrival: Optional[float] = None
        # requests submitted and not yet completed, and the EWMA of
        # arrivals that found one pending: a straggler can only come from
        # another client
        self._pending = 0
        self._overlap_ewma = 0.0
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.launches = 0
        self.coalesced_launches = 0
        self.launches_saved = 0
        self.deduped_requests = 0
        self.batched_requests = 0
        self.failures = 0
        self.max_batch_size = 0
        self.queue_wait_ms_total = 0.0
        self.queue_wait_ms_max = 0.0
        self.window_waits = 0
        self.window_gathered = 0
        self.window_last_ms = 0.0
        self._registries: list = []  # guarded-by: _stats_lock

    # -- submission ---------------------------------------------------------------
    def submit(self, kernel: LaunchKernel, params, num_docs) -> _LaunchRequest:
        req = _LaunchRequest(kernel, params, num_docs)
        with self._cond:
            if self._closed:
                raise RuntimeError(f"launch scheduler {self._name} is closed")
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name=self._name)
                self._thread.start()
            self._note_arrival_locked(req.t_submit)
            self._overlap_ewma = (0.2 * (self._pending > 0)
                                  + 0.8 * self._overlap_ewma)
            self._pending += 1
            self._queue.append(req)
            self._cond.notify()
        return req

    def _note_arrival_locked(self, now: float) -> None:
        """Arrival-gap EWMA for the window; a gap far past the hot
        threshold resets it, so a burst long gone leaves no hot window."""
        if self._last_arrival is not None:
            dt_ms = (now - self._last_arrival) * 1e3
            e = self._arrival_ewma_ms
            if e is None or dt_ms > 8 * max(self.window_hot_ms, 0.001):
                self._arrival_ewma_ms = dt_ms
            else:
                self._arrival_ewma_ms = 0.2 * dt_ms + 0.8 * e
        self._last_arrival = now

    def set_window(self, max_ms: Optional[float] = None,
                   hot_ms: Optional[float] = None) -> None:
        """``max_ms``: the most a drain holds for stragglers (<= 0: never);
        ``hot_ms``: the arrival-gap EWMA under which traffic is hot."""
        with self._cond:
            if max_ms is not None:
                self.window_max_ms = float(max_ms)
            if hot_ms is not None:
                self.window_hot_ms = float(hot_ms)

    def close(self) -> None:
        """Accept nothing more; the dispatcher drains the queue and ends."""
        with self._cond:
            self._closed = True
            self._cond.notify()

    # -- dispatcher ---------------------------------------------------------------
    def _window_hold_s(self, n_drained: int) -> float:
        w = self.window_max_ms
        if w <= 0 or n_drained >= 8:
            return 0.0
        ewma = self._arrival_ewma_ms
        if ewma is None or ewma > self.window_hot_ms \
                or self._overlap_ewma < _OVERLAP_MIN:
            return 0.0
        return w / 1e3

    def _loop(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                drained = list(self._queue)
                self._queue.clear()
            hold_s = self._window_hold_s(len(drained))
            if hold_s > 0:
                deadline = time.perf_counter() + hold_s
                gathered = 0
                with self._cond:
                    while not self._closed:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                    if self._queue:
                        gathered = len(self._queue)
                        drained += list(self._queue)
                        self._queue.clear()
                with self._stats_lock:
                    self.window_waits += 1
                    self.window_gathered += gathered
                    self.window_last_ms = hold_s * 1e3
                self._mark("LAUNCH_WINDOW_WAITS", 1)
                self._mark("LAUNCH_WINDOW_GATHERED", gathered)
            # group by kernel, in the order of each group's first request
            groups: "OrderedDict[Tuple, List[_LaunchRequest]]" = OrderedDict()
            for req in drained:
                groups.setdefault(req.kernel.key, []).append(req)
            for reqs in groups.values():
                # whatever escapes the group still completes its waiters;
                # an interrupt ends the dispatcher, the next submit starts
                # another
                try:
                    self._launch_group(reqs)
                except BaseException as e:  # noqa: BLE001 - to the futures
                    log.exception("launch group failed outside its launches")
                    stop = not isinstance(e, Exception)
                    for r in drained if stop else reqs:
                        if not r.future.done():
                            self._complete(r, error=e)
                    if stop:
                        raise

    def _launch_group(self, reqs: List[_LaunchRequest]) -> None:
        kernel = reqs[0].kernel
        num_docs = reqs[0].num_docs
        now = time.perf_counter()
        for r in reqs:
            r.queue_wait_ms = (now - r.t_submit) * 1e3
        # exact repeats carry the same parameter object (the param cache)
        uniq: List[Any] = []
        req_slot: List[int] = []
        seen: Dict[int, int] = {}
        for r in reqs:
            slot = seen.get(id(r.params))
            if slot is None:
                slot = len(uniq)
                seen[id(r.params)] = slot
                uniq.append(r.params)
            req_slot.append(slot)

        outs: List[Any] = [None] * len(uniq)
        errs: List[Optional[BaseException]] = [None] * len(uniq)
        launches = 0
        step = kernel.max_batch if kernel.batchable else 1
        for start in range(0, len(uniq), step):
            chunk = uniq[start:start + step]
            try:
                if len(chunk) > 1:
                    outs[start:start + len(chunk)] = kernel.run_many(
                        chunk, num_docs)
                else:
                    outs[start] = kernel.run_one(chunk[0], num_docs)
            except Exception as e:  # noqa: BLE001 - to every rider
                errs[start:start + len(chunk)] = [e] * len(chunk)
            launches += 1
        # the group's device work is done before any rider reads it
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

        n = len(reqs)
        # counted before any rider wakes, so a rider reads stats with its
        # own launch in them
        self._note(reqs, uniq, launches,
                   n_failed=sum(e is not None for e in errs))
        for r, slot in zip(reqs, req_slot):
            r.batch_size = n
            r.launches_saved = n - launches
            r.deduped = req_slot.count(slot) > 1
            self._complete(r, outs[slot], errs[slot])

    def _complete(self, r: _LaunchRequest, out=None,
                  error: Optional[BaseException] = None) -> None:
        """Resolve one request, no longer pending before its rider wakes
        (its next submit must not count itself as an overlap)."""
        with self._cond:
            self._pending -= 1
        if error is not None:
            r.future.set_exception(error)
        else:
            r.future.set_result(out)

    # -- stats --------------------------------------------------------------------
    def _note(self, reqs, uniq, launches: int, n_failed: int) -> None:
        n = len(reqs)
        wait = [r.queue_wait_ms for r in reqs]
        with self._stats_lock:
            self.requests += n
            self.launches += launches
            self.failures += n_failed
            if n > launches:
                self.coalesced_launches += 1
                self.launches_saved += n - launches
            self.deduped_requests += n - len(uniq)
            if len(uniq) > 1 and launches < len(uniq):
                self.batched_requests += len(uniq)
            self.max_batch_size = max(self.max_batch_size, n)
            self.queue_wait_ms_total += sum(wait)
            self.queue_wait_ms_max = max(self.queue_wait_ms_max, *wait)
        self._mark("LAUNCH_REQUESTS", n)
        self._mark("LAUNCHES", launches)
        if n > launches:
            self._mark("LAUNCHES_COALESCED", 1)
            self._mark("LAUNCHES_SAVED", n - launches)

    def bind_metrics(self, registry) -> None:
        """Attach a MetricsRegistry: the queue gauges, and the meters every
        later launch marks."""
        with self._stats_lock:
            if registry not in self._registries:
                self._registries.append(registry)
        registry.gauge("launch_queue_depth", lambda: float(len(self._queue)))
        registry.gauge("launch_max_batch_size",
                       lambda: float(self.max_batch_size))

    def _mark(self, name: str, n: int) -> None:
        if n <= 0:
            return
        with self._stats_lock:
            registries = list(self._registries)
        for reg in registries:
            reg.meter(getattr(ServerMeter, name)).mark(n)

    def stats_snapshot(self) -> Dict[str, float]:
        """Cumulative counters (a run diffs two of these)."""
        with self._stats_lock:
            return {
                "requests": self.requests,
                "launches": self.launches,
                "coalescedLaunches": self.coalesced_launches,
                "launchesSaved": self.launches_saved,
                "dedupedRequests": self.deduped_requests,
                "batchedRequests": self.batched_requests,
                "failures": self.failures,
                "maxBatchSize": self.max_batch_size,
                "queueWaitMsTotal": round(self.queue_wait_ms_total, 3),
                "queueWaitMsMax": round(self.queue_wait_ms_max, 3),
                "windowWaits": self.window_waits,
                "windowGathered": self.window_gathered,
                "windowLastMs": round(self.window_last_ms, 3),
            }


# one dispatcher per device: every executor on a device shares it, so
# their launches are ordered on one thread
_LAUNCHERS: Dict[str, LaunchScheduler] = {}
_REGISTRY_LOCK = threading.Lock()


def launcher_for_device(device: Union[str, torch.device]) -> LaunchScheduler:
    """The device's scheduler (JAX ``launcher_for_mesh``: one per mesh)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    with _REGISTRY_LOCK:
        sched = _LAUNCHERS.get(key)
        if sched is None:
            sched = LaunchScheduler(name=f"combine-launch-{key}", device=dev)
            _LAUNCHERS[key] = sched
        return sched


__all__ = ["LaunchKernel", "LaunchScheduler", "launcher_for_device"]
