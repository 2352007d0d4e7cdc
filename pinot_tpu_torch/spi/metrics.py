"""Metrics: meters, timers and gauges with a Prometheus text export.

Counterpart of ``pinot_tpu/spi/metrics.py``: each role (controller,
broker, server) owns a ``MetricsRegistry``; meters and timers take a small
lock per update (``+=`` is not atomic across threads). The canonical
names (``ServerMeter``, ``ServerQueryPhase``, ``BrokerMeter``,
``BrokerQueryPhase``) are the JAX package's. The JAX registry's
telemetry binding (``bind_telemetry`` and the histogram families it adds
to the export) is not part of this module.
"""

from __future__ import annotations

import re
import threading

from typing import Any, Callable, Dict, Union

# prometheus metric names admit only [a-zA-Z0-9_:]; every exported name
# is sanitized through this
_NAME_UNSAFE = re.compile(r"[^a-zA-Z0-9_:]+")


def sanitize_metric_name(name: str) -> str:
    return _NAME_UNSAFE.sub("_", name)


class Meter:
    """Monotonic counter (PinotMeter). Locked: ``+=`` is not atomic across
    threads."""

    __slots__ = ("count", "_lock")

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self.count += n


class Timer:
    """Duration accumulator: count / total / max ms (PinotTimer)."""

    __slots__ = ("count", "total_ms", "max_ms", "_lock")

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self._lock = threading.Lock()

    def update_ms(self, ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += ms
            if ms > self.max_ms:
                self.max_ms = ms

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


GaugeFn = Union[Callable[[], float], float, int]


class MetricsRegistry:
    """One per role (PinotMetricsRegistry)."""

    def __init__(self, role: str = ""):
        self.role = role
        self._meters: Dict[str, Meter] = {}  # guarded-by-writes: _lock
        self._timers: Dict[str, Timer] = {}  # guarded-by-writes: _lock
        self._gauges: Dict[str, GaugeFn] = {}
        self._lock = threading.Lock()

    def meter(self, name: str) -> Meter:
        m = self._meters.get(name)
        if m is None:
            with self._lock:
                m = self._meters.setdefault(name, Meter())
        return m

    def timer(self, name: str) -> Timer:
        t = self._timers.get(name)
        if t is None:
            with self._lock:
                t = self._timers.setdefault(name, Timer())
        return t

    def gauge(self, name: str, fn: GaugeFn) -> None:
        """Register a gauge. ``fn`` runs on the scraping thread: it must
        never read a value back from the card (a ``.item()`` there would
        wait for the device)."""
        self._gauges[name] = fn

    # -- export --------------------------------------------------------------
    def _prefix(self, name: str) -> str:
        p = f"pinot_{self.role}_" if self.role else "pinot_"
        return sanitize_metric_name(p + name)

    @staticmethod
    def _header(lines, full: str, mtype: str, text: str) -> None:
        lines.append(f"# HELP {full} {text}")
        lines.append(f"# TYPE {full} {mtype}")

    def export_prometheus(self) -> str:
        """Prometheus text exposition (the /metrics endpoint body):
        HELP/TYPE headers on every family, sanitized names."""
        lines = []
        for name, m in sorted(self._meters.items()):
            full = self._prefix(name)
            self._header(lines, full, "counter",
                         f"Cumulative count of {name}.")
            lines.append(f"{full} {m.count}")
        for name, g in sorted(self._gauges.items()):
            full = self._prefix(name)
            v = g() if callable(g) else g
            self._header(lines, full, "gauge",
                         f"Instantaneous value of {name}.")
            lines.append(f"{full} {float(v)}")
        for name, t in sorted(self._timers.items()):
            full = self._prefix(name)
            self._header(lines, f"{full}_ms", "summary",
                         f"Duration of {name} in milliseconds.")
            lines.append(f"{full}_ms_count {t.count}")
            lines.append(f"{full}_ms_sum {round(t.total_ms, 3)}")
            self._header(lines, f"{full}_ms_max", "gauge",
                         f"Maximum observed {name} duration (ms).")
            lines.append(f"{full}_ms_max {round(t.max_ms, 3)}")
        return "\n".join(lines) + "\n"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "meters": {n: m.count for n, m in self._meters.items()},
            "gauges": {n: (g() if callable(g) else g)
                       for n, g in self._gauges.items()},
            "timers": {n: {"count": t.count,
                           "totalMs": round(t.total_ms, 3),
                           "maxMs": round(t.max_ms, 3)}
                       for n, t in self._timers.items()},
        }


# canonical metric names (subset of the reference's per-role enums)
class BrokerMeter:
    QUERIES = "queries_total"
    EXCEPTIONS = "query_exceptions_total"
    NO_SERVING_HOST = "no_serving_host_total"
    # single-flight coalescing (broker/broker.py): followers that shared a
    # leader's in-flight execution instead of running their own
    QUERIES_COALESCED = "queries_coalesced_total"
    # admission gate rejections surfaced as 429s (broker/quota.py +
    # server/admission.py at the broker front door)
    QUERIES_REJECTED = "queries_rejected_total"


class BrokerQueryPhase:
    COMPILATION = "COMPILATION"
    ROUTING = "ROUTING"
    SCATTER_GATHER = "SCATTER_GATHER"
    REDUCE = "REDUCE"


class ServerMeter:
    QUERIES = "queries_total"
    DOCS_SCANNED = "docs_scanned_total"
    SEGMENTS_PRUNED = "segments_pruned_total"
    QUERY_EXCEPTIONS = "query_exceptions_total"
    # HBM residency (engine/residency.py; gauges staging_staged_bytes /
    # staging_peak_bytes / staging_budget_bytes ride the same registry)
    STAGING_HITS = "staging_hits_total"
    STAGING_MISSES = "staging_misses_total"
    STAGING_EVICTIONS = "staging_evictions_total"
    STAGING_PIN_BLOCKED = "staging_pin_blocked_evictions_total"
    STAGING_SPILLS = "staging_spills_total"
    STAGING_BORROWS = "staging_borrows_total"
    # host-RAM spill tier (engine/residency.py; gauges staging_host_bytes /
    # staging_host_peak_bytes / staging_host_budget_bytes ride the same
    # registry): demotions move device arrays to host numpy, promotions
    # re-stage them with a plain H2D, host drops are the tier's own LRU
    # evictions, sliced = over-budget queries served via the budget-sliced
    # sharded combine instead of a host-engine spill
    STAGING_DEMOTIONS = "staging_demotions_total"
    STAGING_PROMOTIONS = "staging_promotions_total"
    STAGING_HOST_DROPS = "staging_host_drops_total"
    STAGING_SLICED = "staging_sliced_queries_total"
    # launch coalescing (parallel/launcher.py; gauges launch_queue_depth /
    # launch_max_batch_size ride the same registry)
    LAUNCH_REQUESTS = "combine_launch_requests_total"
    LAUNCHES = "combine_launches_total"
    LAUNCHES_COALESCED = "combine_launches_coalesced_total"
    LAUNCHES_SAVED = "combine_launches_saved_total"
    # adaptive micro-batch window (parallel/launcher.py): dispatch-loop
    # holds taken and straggler requests gathered during a held window
    LAUNCH_WINDOW_WAITS = "launch_window_waits_total"
    LAUNCH_WINDOW_GATHERED = "launch_window_gathered_total"
    # admission gate (server/admission.py)
    ADMISSION_ADMITTED = "admission_admitted_total"
    ADMISSION_REJECTED = "admission_rejected_total"


class ServerQueryPhase:
    SCHEDULER_WAIT = "SCHEDULER_WAIT"
    SEGMENT_PRUNING = "SEGMENT_PRUNING"
    QUERY_EXECUTION = "QUERY_EXECUTION"

