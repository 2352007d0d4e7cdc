"""Per-table query quota: QPS admission at the broker's front door.

Counterpart of ``pinot_tpu/broker/quota.py`` (``HitCounter``,
``QueryQuotaManager``): a sliding one-second window of 100 ms buckets a
table; a query is admitted only while the window's count stays under the
table's ``QuotaConfig.max_queries_per_second``, divided by the number of
live brokers (one in the embedded cluster).
"""

from __future__ import annotations

import threading
import time

from typing import Dict, Optional

_BUCKETS = 10
_BUCKET_MS = 100


class HitCounter:
    """A ring of 100 ms hit buckets."""

    def __init__(self):
        self._counts = [0] * _BUCKETS  # guarded-by: _lock
        self._stamps = [0] * _BUCKETS  # guarded-by: _lock
        self._lock = threading.Lock()

    def hit(self, now_ms: Optional[int] = None) -> None:
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        idx = (now_ms // _BUCKET_MS) % _BUCKETS
        stamp = now_ms // _BUCKET_MS
        with self._lock:
            if self._stamps[idx] != stamp:
                self._stamps[idx] = stamp
                self._counts[idx] = 0
            self._counts[idx] += 1

    def count(self, now_ms: Optional[int] = None) -> int:
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        stamp = now_ms // _BUCKET_MS
        with self._lock:
            return sum(c for c, s in zip(self._counts, self._stamps)
                       if stamp - s < _BUCKETS)


class QueryQuotaManager:
    """One per broker, consulted before routing. Each table's quota is
    cached and dropped by a table-config watch, so the common no-quota case
    reads no config on the front door."""

    def __init__(self, store, num_brokers_fn=None):
        self.store = store
        # lock-free reads are safe (atomic dict ops; a racy miss just
        # re-creates/re-parses); mutation must serialize
        self._counters: Dict[str, HitCounter] = {}  # guarded-by-writes: _lock
        self._quotas: Dict[str, Optional[float]] = {}  # guarded-by-writes: _lock
        self._lock = threading.Lock()
        self._num_brokers_fn = num_brokers_fn or (lambda: 1)
        store.watch("tables/", self._on_table_change)

    def _on_table_change(self, path: str, _value) -> None:
        table = path.split("/", 1)[-1]
        with self._lock:
            self._quotas.pop(table, None)

    def _qps(self, table: str) -> Optional[float]:
        if table in self._quotas:
            return self._quotas[table]
        cfg = self.store.get_table_config(table)
        qps = (cfg.quota_config.max_queries_per_second
               if cfg is not None else None)
        with self._lock:
            self._quotas[table] = qps
        return qps

    def _counter(self, table: str) -> HitCounter:
        c = self._counters.get(table)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(table, HitCounter())
        return c

    def acquire(self, table_with_type: str,
                now_ms: Optional[int] = None) -> bool:
        """True: admitted (and counted). False: over the quota."""
        qps = self._qps(table_with_type)
        if not qps:
            return True
        per_broker = qps / max(self._num_brokers_fn(), 1)
        counter = self._counter(table_with_type)
        if counter.count(now_ms) >= per_broker:
            return False
        counter.hit(now_ms)
        return True
