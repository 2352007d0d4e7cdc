"""Single-flight execution: concurrent identical work shares one run.

Counterpart of ``pinot_tpu/common/singleflight.py``. The first caller for
a key is the leader and runs the function; a caller that arrives while
the leader is in flight follows, blocks on the leader's future and gets
the same result object (or the same exception). Only in-flight work is
held: nothing is cached past the leader's run. The per-segment executors
key identical kernel launches with it (same cached plan, same staged
resident), so concurrent identical queries share one launch and one copy
to the host.
"""

from __future__ import annotations

import threading

from concurrent.futures import Future
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

__all__ = ["SingleFlight"]


class SingleFlight:
    """``do(key, fn)`` -> ``(result, coalesced)``: ``coalesced`` is True
    for a caller that rode another caller's run. A ``key`` of None runs
    ``fn`` alone (the caller decided the work is not shareable)."""

    __slots__ = ("_lock", "_flights", "leaders", "hits")

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: Dict[Hashable, Future] = {}
        self.leaders = 0
        self.hits = 0

    def do(self, key: Optional[Hashable],
           fn: Callable[[], Any]) -> Tuple[Any, bool]:
        if key is None:
            return fn(), False
        with self._lock:
            fut = self._flights.get(key)
            leader = fut is None
            if leader:
                fut = Future()
                self._flights[key] = fut
                self.leaders += 1
            else:
                self.hits += 1
        if not leader:
            return fut.result(), True
        try:
            result = fn()
        except BaseException as e:
            # drop the flight before resolving it: a caller arriving after
            # the failure starts afresh rather than join a dead flight
            with self._lock:
                self._flights.pop(key, None)
            fut.set_exception(e)
            raise
        with self._lock:
            self._flights.pop(key, None)
        fut.set_result(result)
        return result, False

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"leaders": self.leaders, "hits": self.hits,
                    "inflight": len(self._flights)}
