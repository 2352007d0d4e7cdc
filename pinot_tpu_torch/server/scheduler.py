"""The server's persistent worker pool.

Counterpart of ``pinot_tpu/server/scheduler.py:23-95`` (``_DaemonPool``,
``WorkerPool``): one pool per executor, shared by every query in flight,
so a query's segment fan-out pays no thread spawn and the thread count is
a server-level bound. Cut to what the fan-out uses (``map`` and
``stop``); the JAX module's query schedulers (FCFS, token bucket,
priority, shortest-expected-work-first) are not part of this module.
"""

from __future__ import annotations

import functools
import queue
import threading

from concurrent.futures import Future
from typing import Any, Callable


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
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue    # cancelled while queued
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - the future holds it
                fut.set_exception(e)

    def submit(self, fn: Callable[[], Any]) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn))
        return fut

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


__all__ = ["WorkerPool"]
