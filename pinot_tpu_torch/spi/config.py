"""Layered key/value configuration, cut down to the keys the port reads.

Counterpart of ``pinot_tpu/spi/config.py`` (``PinotConfiguration``, the
residency, launch, worker-pool, runner, scheduler, admission and
broker-reduce keys of ``CommonConstants`` at :144-153 and :158-232): explicit
overrides win over ``PINOT_``-prefixed environment variables
(``PINOT_SERVER_PORT`` -> ``pinot.server.port``), and keys match relaxed
(case-insensitive, ``-`` / ``_`` / ``.`` -insensitive).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional

_SEP = re.compile(r"[-_.]")


def _relax(key: str) -> str:
    """``timeoutMs`` == ``timeout.ms`` == ``TIMEOUT_MS`` == ``timeout-ms``."""
    parts: List[str] = [s for s in _SEP.split(key.lower()) if s]
    return "".join(parts)


class CommonConstants:
    # HBM residency (engine/residency.py): the device-staging byte budget.
    # Unset -> the card's memory times the fraction below (uncapped on the
    # CPU); <= 0 -> explicitly uncapped.
    HBM_BUDGET_BYTES_KEY = "pinot.server.query.hbm.budget.bytes"
    DEFAULT_HBM_BUDGET_FRACTION = 0.75
    # host-RAM spill tier: eviction demotes device tensors to pinned host
    # copies. Budget unset -> MemAvailable times the fraction below; <= 0
    # -> uncapped. The enabled key turns the tier off (eviction drops).
    HOSTRAM_BUDGET_BYTES_KEY = "pinot.server.query.hostram.budget.bytes"
    HOSTRAM_ENABLED_KEY = "pinot.server.query.hostram.enabled"
    DEFAULT_HOSTRAM_BUDGET_FRACTION = 0.5
    # budget-sliced execution of a working set over the budget whose
    # largest segment fits; off restores the spill to the host engine
    HBM_SLICING_ENABLED_KEY = "pinot.server.query.hbm.slicing.enabled"
    # launch coalescing (parallel/launcher.py): most requests one launch
    # may carry (1 disables batching; dedup still applies)
    LAUNCH_MAX_BATCH_KEY = "pinot.server.query.launch.max.batch"
    DEFAULT_LAUNCH_MAX_BATCH = 8
    # adaptive window: while the launch queue is hot (arrival EWMA under
    # the hot threshold) the dispatcher holds up to this long for
    # stragglers; <= 0 disables the hold
    LAUNCH_WINDOW_MS_KEY = "pinot.server.query.launch.window.ms"
    DEFAULT_LAUNCH_WINDOW_MS = 1.0
    LAUNCH_WINDOW_HOT_MS_KEY = "pinot.server.query.launch.window.hot.ms"
    DEFAULT_LAUNCH_WINDOW_HOT_MS = 2.0
    # segment fan-out width inside one query (engine/executor.py
    # _map_segments, the reference's pqw pool). The JAX package's default
    # is min(cpu count, 8); the port's is 1, since its per-segment work is
    # host Python under the GIL and 8 threads ran the flights 1.2-4.2x slower
    # than 1 on an H100 (chip_smoke.py phase 15e, PERF.md)
    WORKER_THREADS_KEY = "pinot.server.query.worker.threads"
    DEFAULT_WORKER_THREADS = 1
    # the server's query runners (server/scheduler.py make_scheduler):
    # threads that run whole queries off the scheduler queue, and the
    # queue's policy: fcfs | tokenbucket | priority | sewf (shortest
    # expected work first with an age boost, the default)
    RUNNER_THREADS_KEY = "pinot.server.query.runner.threads"
    DEFAULT_RUNNER_THREADS = 8
    SCHEDULER_POLICY_KEY = "pinot.server.query.scheduler.policy"
    DEFAULT_SCHEDULER_POLICY = "sewf"
    # admission gate (server/admission.py): executing-query slots, waiters
    # behind them and the wait bound. 0 = auto (slots from the cpu count,
    # queue 8x the slots); max.concurrent < 0 disables the gate; a waiter
    # past the wait bound, or an arrival at a full queue, is rejected with
    # a typed retriable QueryRejectedError
    ADMISSION_MAX_CONCURRENT_KEY = \
        "pinot.server.query.admission.max.concurrent"
    DEFAULT_ADMISSION_MAX_CONCURRENT = 0
    ADMISSION_MAX_QUEUE_KEY = "pinot.server.query.admission.max.queue"
    DEFAULT_ADMISSION_MAX_QUEUE = 0
    ADMISSION_MAX_WAIT_MS_KEY = "pinot.server.query.admission.max.wait.ms"
    DEFAULT_ADMISSION_MAX_WAIT_MS = 10_000.0
    # the broker's group-by merge on the card (parallel/reduce_device.py):
    # off by default, on per service (device_reduce=True) or per query
    # (OPTION(deviceReduce=true))
    BROKER_DEVICE_REDUCE_KEY = "pinot.broker.reduce.device.enabled"
    DEFAULT_BROKER_DEVICE_REDUCE = False
    # composite key spaces up to this many slots merge by a direct scatter
    # (the dense rung); larger ones take the sort rung
    DEFAULT_DEVICE_REDUCE_DENSE_SLOTS = 1 << 21
    # rows of the concatenated merge input past which the device merge
    # declines rather than commit unbounded device memory
    DEFAULT_DEVICE_REDUCE_MAX_ROWS = 1 << 22


class PinotConfiguration:
    """Overrides over ``PINOT_`` environment variables."""

    def __init__(self, overrides: Optional[Mapping[str, Any]] = None,
                 use_env: bool = True):
        self._store: Dict[str, Any] = {}
        if use_env:
            for k, v in os.environ.items():
                if k.startswith("PINOT_"):
                    self._store[_relax(k.lower().replace("_", "."))] = v
        for k, v in (overrides or {}).items():
            self._store[_relax(k)] = v

    def get(self, key: str, default: Any = None) -> Any:
        return self._store.get(_relax(key), default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        return default if v is None else int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        return default if v is None else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("true", "1", "yes", "on")


__all__ = ["CommonConstants", "PinotConfiguration"]
