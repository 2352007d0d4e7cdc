"""Continuous telemetry: windowed histograms, SLO burn, flight recorder.

Counterpart of ``pinot_tpu/common/telemetry.py``: the per-phase latency
histograms every broker and server records (the reference's
``BrokerQueryPhase`` / ``ServerQueryPhase`` timers as log-bucketed
histograms with sliding windows), plus two layers the reference leaves to
outside systems:

- **SLO burn**: per-table latency, error and freshness objectives
  (``pinot.broker.slo.<table>.p99.ms`` / ``.error.pct`` /
  ``.freshness.ms``) with short- and long-window burn rates;
- **the collector's pauses** (:class:`GcPauses`, :data:`GC_PAUSES`): one
  ``gc.callbacks`` hook a process, the cumulative pause and collections
  by generation and a histogram of pauses (``gc_pause_ms`` on
  ``/metrics``, the counterpart of the JVM GC metrics a Pinot server
  exports); a traced ``ServerQuery`` reads it at open and close;
- **a flight recorder**: a process-wide bounded ring of recent span trees,
  decision-ledger marks and registered state snapshots (residency,
  scheduler, admission), frozen into a timestamped JSON bundle when an
  anomaly trips it (a windowed p99 far above its EWMA, a burst of
  rejections, evictions, demotions or fused-scan declines).

The record path takes one bisect and a few increments under a small lock
and never waits for the card: a gauge reads host counters only.
Quantiles, window merges, the Prometheus text and the anomaly checks run
on the scrape or sampler side. Every clock is injectable (``clock=``), so
windows and burn rates are testable on a fake clock.

One process-wide center, :data:`TELEMETRY`, is shared by every broker and
server of the process (as the JAX package's is); tests may build their
own :class:`Telemetry`. ``stop_sampler`` joins the sampler thread, and
``untrack_gauge`` drops a gauge whose owner shut down.
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time

from bisect import bisect_left
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# --------------------------------------------------------------------------
# log-bucketed histogram
# --------------------------------------------------------------------------

# Log-spaced bucket upper bounds (ms): 0.01 ms .. ~70 s at ratio 2^(1/4)
# (~19% per step, so quantile estimates carry <= ~19% relative error), plus
# an overflow bucket. Shared across every histogram: snapshot/merge are
# O(len(BUCKET_BOUNDS_MS)) and exposition emits one `le` per bound.
_GROWTH = 2.0 ** 0.25
_N_BOUNDS = 92
BUCKET_BOUNDS_MS: Tuple[float, ...] = tuple(
    round(0.01 * _GROWTH ** i, 6) for i in range(_N_BOUNDS))


class Histogram:
    """Thread-safe log-bucketed histogram (values in ms).

    ``record`` is the hot path: bisect + four increments under a tiny
    lock. Everything analytical (quantiles, merge, exposition rows) walks
    the fixed bucket array — O(buckets), scrape-side only."""

    __slots__ = ("counts", "count", "sum", "max", "_lock")

    def __init__(self):
        self.counts = [0] * (_N_BOUNDS + 1)  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock
        self.sum = 0.0  # guarded-by: _lock
        self.max = 0.0  # guarded-by: _lock
        self._lock = threading.Lock()

    def record(self, ms: float) -> None:
        i = bisect_left(BUCKET_BOUNDS_MS, ms)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += ms
            if ms > self.max:
                self.max = ms

    def clear(self) -> None:
        with self._lock:
            for i in range(len(self.counts)):
                self.counts[i] = 0
            self.count = 0
            self.sum = 0.0
            self.max = 0.0

    def merge(self, other: "Histogram") -> None:
        """Add ``other``'s state into this histogram (window merges)."""
        with other._lock:
            counts = list(other.counts)
            count, total, mx = other.count, other.sum, other.max
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.count += count
            self.sum += total
            if mx > self.max:
                self.max = mx

    # -- analytics (scrape-side) --------------------------------------------
    def _copy(self) -> Tuple[List[int], int, float, float]:
        with self._lock:
            return list(self.counts), self.count, self.sum, self.max

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1) with linear interpolation inside
        the containing log bucket; relative error bounded by the bucket
        growth ratio. 0.0 when empty."""
        counts, count, _s, mx = self._copy()
        return _bucket_quantile(counts, count, mx, q)

    def quantiles(self, qs: Tuple[float, ...]) -> List[float]:
        counts, count, _s, mx = self._copy()
        return [_bucket_quantile(counts, count, mx, q) for q in qs]

    def count_over(self, threshold_ms: float) -> int:
        """Estimated number of recorded values above ``threshold_ms``
        (interpolated inside the bucket containing the threshold) — the
        numerator of the latency-SLO burn fraction."""
        counts, count, _s, _m = self._copy()
        if count == 0:
            return 0
        i = bisect_left(BUCKET_BOUNDS_MS, threshold_ms)
        over = sum(counts[i + 1:])
        inbucket = counts[i] if i < len(counts) else 0
        if inbucket:
            lo = BUCKET_BOUNDS_MS[i - 1] if i > 0 else 0.0
            hi = BUCKET_BOUNDS_MS[i] if i < _N_BOUNDS else threshold_ms
            frac_over = 0.0 if hi <= lo else \
                max(0.0, min(1.0, (hi - threshold_ms) / (hi - lo)))
            over += int(round(inbucket * frac_over))
        return min(over, count)

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, Any]:
        counts, count, total, mx = self._copy()
        out: Dict[str, Any] = {
            "count": count,
            "sumMs": round(total, 3),
            "maxMs": round(mx, 3),
            "meanMs": round(total / count, 3) if count else 0.0,
        }
        for label, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            out[label] = round(_bucket_quantile(counts, count, mx, q), 3)
        return out

    def bucket_rows(self) -> List[Tuple[str, int]]:
        """Prometheus ``_bucket`` rows: (le, CUMULATIVE count), +Inf last."""
        counts, _c, _s, _m = self._copy()
        rows: List[Tuple[str, int]] = []
        cum = 0
        for i, bound in enumerate(BUCKET_BOUNDS_MS):
            cum += counts[i]
            rows.append((repr(bound), cum))
        rows.append(("+Inf", cum + counts[-1]))
        return rows


def _bucket_quantile(counts: List[int], count: int, observed_max: float,
                     q: float) -> float:
    if count == 0:
        return 0.0
    rank = q * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            if i >= _N_BOUNDS:  # overflow bucket: best estimate is the max
                return observed_max
            lo = BUCKET_BOUNDS_MS[i - 1] if i > 0 else 0.0
            hi = BUCKET_BOUNDS_MS[i]
            frac = (rank - cum) / c
            return lo + frac * (hi - lo)
        cum += c
    return observed_max


class WindowedHistogram:
    """A lifetime :class:`Histogram` plus a ring of rotating sub-windows
    giving sliding quantiles over the last ``window_s * num_windows``
    seconds (default 30 s x 10 = 5 min). Rotation happens lazily on
    record/read — no timer thread; an idle histogram costs nothing."""

    def __init__(self, window_s: float = 30.0, num_windows: int = 10,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.num_windows = max(1, int(num_windows))
        self._clock = clock
        self.lifetime = Histogram()
        self._ring: List[Histogram] = [Histogram()
                                       for _ in range(self.num_windows)]
        self._cur = 0  # guarded-by: _rot_lock
        self._cur_start = clock()  # guarded-by: _rot_lock
        self._rot_lock = threading.Lock()

    def _rotate_locked(self, now: float) -> None:
        elapsed = now - self._cur_start
        if elapsed < self.window_s:
            return
        steps = int(elapsed // self.window_s)
        if steps >= self.num_windows:  # whole horizon expired
            for h in self._ring:
                h.clear()
            self._cur_start = now
            return
        for _ in range(steps):
            self._cur = (self._cur + 1) % self.num_windows
            self._ring[self._cur].clear()
        self._cur_start += steps * self.window_s

    def _current(self) -> Histogram:
        now = self._clock()
        with self._rot_lock:
            self._rotate_locked(now)
            return self._ring[self._cur]

    def record(self, ms: float) -> None:
        self._current().record(ms)
        self.lifetime.record(ms)

    def sliding(self) -> Histogram:
        """Merged view of the live sub-windows (the last ~window_s *
        num_windows seconds) — a fresh Histogram the caller owns."""
        now = self._clock()
        with self._rot_lock:
            self._rotate_locked(now)
            ring = list(self._ring)
        merged = Histogram()
        for h in ring:
            merged.merge(h)
        return merged

    def snapshot(self) -> Dict[str, Any]:
        out = {"lifetime": self.lifetime.snapshot(),
               "sliding": self.sliding().snapshot(),
               "windowS": self.window_s,
               "numWindows": self.num_windows}
        return out


class WindowCounter:
    """Rotating per-window event counter (same ring discipline as
    :class:`WindowedHistogram`) — the error half of the SLO burn math."""

    def __init__(self, window_s: float = 30.0, num_windows: int = 10,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.num_windows = max(1, int(num_windows))
        self._clock = clock
        self.total = 0  # guarded-by: _lock
        self._ring = [0] * self.num_windows  # guarded-by: _lock
        self._cur = 0  # guarded-by: _lock
        self._cur_start = clock()  # guarded-by: _lock
        self._lock = threading.Lock()

    def _rotate_locked(self, now: float) -> None:
        elapsed = now - self._cur_start
        if elapsed < self.window_s:
            return
        steps = int(elapsed // self.window_s)
        if steps >= self.num_windows:
            for i in range(self.num_windows):
                self._ring[i] = 0
            self._cur_start = now
            return
        for _ in range(steps):
            self._cur = (self._cur + 1) % self.num_windows
            self._ring[self._cur] = 0
        self._cur_start += steps * self.window_s

    def add(self, n: int = 1) -> None:
        now = self._clock()
        with self._lock:
            self._rotate_locked(now)
            self._ring[self._cur] += n
            self.total += n

    def in_window(self, last_n_windows: Optional[int] = None) -> int:
        """Events inside the most recent ``last_n_windows`` sub-windows
        (None = the whole ring horizon)."""
        n = self.num_windows if last_n_windows is None \
            else min(int(last_n_windows), self.num_windows)
        now = self._clock()
        with self._lock:
            self._rotate_locked(now)
            return sum(self._ring[(self._cur - i) % self.num_windows]
                       for i in range(n))


class TimeRing:
    """Bounded (timestamp, value) ring at few-second resolution — the
    history behind gauges that used to be instants (staged bytes, queue
    depths, arrival EWMA, rejection counters)."""

    def __init__(self, slots: int = 150):
        self._ring: "deque" = deque(maxlen=max(2, int(slots)))  # guarded-by: _lock
        self._lock = threading.Lock()

    def append(self, value: float, ts: Optional[float] = None) -> None:
        with self._lock:
            self._ring.append((time.time() if ts is None else ts,
                               float(value)))

    def values(self) -> List[List[float]]:
        with self._lock:
            return [[round(t, 3), v] for t, v in self._ring]

    def last(self) -> Optional[float]:
        with self._lock:
            return self._ring[-1][1] if self._ring else None


# --------------------------------------------------------------------------
# SLO burn tracking
# --------------------------------------------------------------------------

# q-objective -> allowed over-threshold fraction: a p99 objective budgets
# 1% of requests over the threshold
_P99_ALLOWED = 0.01
# multi-window burn evaluation: "short" = the last 2 sub-windows (~1 min
# at the default 30 s window), "long" = the full ring horizon (~5 min)
SHORT_WINDOWS = 2


class SloTracker:
    """Per-table latency/error objectives + multi-window burn rates.

    burn_rate = (observed bad fraction) / (allowed bad fraction): 1.0
    burns exactly the error budget, >1 is over-burn (the multi-window
    alerting form from the SRE workbook). Latency badness comes from the
    broker front-door histograms (``count_over`` the p99 objective);
    error badness from per-table windowed error/total counters."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 window_s: float = 30.0, num_windows: int = 10):
        self._clock = clock
        self._window_s = window_s
        self._num_windows = num_windows
        self._lock = threading.Lock()
        # table -> {"p99_ms": float|None, "error_pct": float|None}
        self._objectives: Dict[str, Dict[str, Optional[float]]] = {}  # guarded-by: _lock
        # table -> (total WindowCounter, error WindowCounter)
        self._counters: Dict[str, Tuple[WindowCounter, WindowCounter]] = {}  # guarded-by: _lock

    def set_objective(self, table: str, p99_ms: Optional[float] = None,
                      error_pct: Optional[float] = None,
                      freshness_ms: Optional[float] = None) -> None:
        with self._lock:
            obj = self._objectives.setdefault(
                table, {"p99_ms": None, "error_pct": None})
            if p99_ms is not None:
                obj["p99_ms"] = float(p99_ms)
            if error_pct is not None:
                obj["error_pct"] = float(error_pct)
            if freshness_ms is not None:
                obj["freshness_ms"] = float(freshness_ms)

    def objectives(self) -> Dict[str, Dict[str, Optional[float]]]:
        with self._lock:
            return {t: dict(o) for t, o in self._objectives.items()}

    def _counters_for(self, table: str) -> Tuple[WindowCounter, WindowCounter]:
        with self._lock:
            pair = self._counters.get(table)
            if pair is None:
                pair = (WindowCounter(self._window_s, self._num_windows,
                                      self._clock),
                        WindowCounter(self._window_s, self._num_windows,
                                      self._clock))
                self._counters[table] = pair
            return pair

    def note_request(self, table: str, error: bool) -> None:
        total, errors = self._counters_for(table)
        total.add(1)
        if error:
            errors.add(1)

    @staticmethod
    def _burn(bad: float, total: float, allowed: float) -> Optional[float]:
        if total <= 0 or allowed <= 0:
            return None
        return round((bad / total) / allowed, 4)

    def burn_rates(self, table: str,
                   latency_histo: Optional[WindowedHistogram],
                   freshness_histo: Optional[WindowedHistogram] = None
                   ) -> Dict[str, Any]:
        """Every objective x both windows for one table."""
        with self._lock:
            obj = dict(self._objectives.get(table) or {})
        out: Dict[str, Any] = {"objectives": obj}
        p99_ms = obj.get("p99_ms")
        if p99_ms and latency_histo is not None:
            lat: Dict[str, Any] = {}
            for name, windows in (("short", SHORT_WINDOWS), ("long", None)):
                # merge the relevant sub-windows; "short" approximates the
                # last ~minute by scaling the full sliding view only when
                # per-window merge is unavailable — here we merge exactly
                h = self._sliding_subset(latency_histo, windows)
                over = h.count_over(p99_ms)
                lat[name] = {
                    "requests": h.count,
                    "overThreshold": over,
                    "badFraction": round(over / h.count, 4) if h.count else 0.0,
                    "burnRate": self._burn(over, h.count, _P99_ALLOWED),
                }
            out["latency"] = lat
        err_pct = obj.get("error_pct")
        if err_pct:
            total, errors = self._counters_for(table)
            err: Dict[str, Any] = {}
            for name, windows in (("short", SHORT_WINDOWS), ("long", None)):
                t = total.in_window(windows)
                e = errors.in_window(windows)
                err[name] = {
                    "requests": t,
                    "errors": e,
                    "badFraction": round(e / t, 4) if t else 0.0,
                    "burnRate": self._burn(e, t, err_pct / 100.0),
                }
            out["errors"] = err
        fresh_ms = obj.get("freshness_ms")
        if fresh_ms and freshness_histo is not None:
            # ingest-to-queryable: each histogram sample is one row's
            # append->first-covering-watermark latency; "bad" rows took
            # longer than the objective to become queryable
            fr: Dict[str, Any] = {}
            for name, windows in (("short", SHORT_WINDOWS), ("long", None)):
                h = self._sliding_subset(freshness_histo, windows)
                over = h.count_over(fresh_ms)
                fr[name] = {
                    "rows": h.count,
                    "overThreshold": over,
                    "badFraction": round(over / h.count, 4) if h.count
                    else 0.0,
                    "burnRate": self._burn(over, h.count, _P99_ALLOWED),
                }
            out["freshness"] = fr
        return out

    @staticmethod
    def _sliding_subset(wh: WindowedHistogram,
                        last_n: Optional[int]) -> Histogram:
        if last_n is None:
            return wh.sliding()
        now = wh._clock()
        with wh._rot_lock:
            wh._rotate_locked(now)
            picks = [wh._ring[(wh._cur - i) % wh.num_windows]
                     for i in range(min(last_n, wh.num_windows))]
        merged = Histogram()
        for h in picks:
            merged.merge(h)
        return merged


# --------------------------------------------------------------------------
# flight recorder
# --------------------------------------------------------------------------

# anomaly-event kinds -> (burst threshold, burst window seconds): a burst
# freezes the recorder into a post-mortem bundle. Conservative defaults —
# a handful of rejections is load shedding working; a burst is an incident.
DEFAULT_BURSTS: Dict[str, Tuple[int, float]] = {
    "rejection": (8, 5.0),
    "eviction": (64, 5.0),
    "demotion": (64, 5.0),
    "pallas_decline": (32, 5.0),
}
# windowed-p99 anomaly: sliding p99 > factor x its own EWMA baseline
P99_SPIKE_FACTOR = 3.0
P99_SPIKE_MIN_COUNT = 32
P99_EWMA_ALPHA = 0.2


class FlightRecorder:
    """Process-wide black box: a bounded ring of recent span roots (the
    slow-log retention machinery feeds it), rolling decision-ledger
    marks, and registered state providers (residency / scheduler /
    admission snapshots) — frozen into a timestamped JSON bundle when an
    anomaly trigger fires.

    Trigger paths NEVER freeze synchronously: callers may hold engine
    locks (an eviction storm is noted under the residency lock), so a
    trip only records a pending trigger; the telemetry sampler — or an
    explicit ``process_pending()`` — performs the freeze outside every
    caller lock."""

    def __init__(self, span_ring: int = 64, ledger_ring: int = 150,
                 bundle_ring: int = 8, min_freeze_interval_s: float = 10.0,
                 out_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: "deque" = deque(maxlen=span_ring)  # guarded-by: _lock
        self._ledger_marks: "deque" = deque(maxlen=ledger_ring)  # guarded-by: _lock
        self._providers: Dict[str, Callable[[], Any]] = {}  # guarded-by: _lock
        self._events: Dict[str, "deque"] = {}  # guarded-by: _lock
        self._event_totals: Dict[str, int] = {}  # guarded-by: _lock
        self._pending: List[Tuple[str, float]] = []  # guarded-by: _lock
        self._last_freeze = 0.0  # guarded-by: _lock
        self.bursts = dict(DEFAULT_BURSTS)
        self.bundles: "deque" = deque(maxlen=bundle_ring)  # guarded-by: _lock
        self.frozen = 0  # guarded-by: _lock
        self.min_freeze_interval_s = float(min_freeze_interval_s)
        self.out_dir = out_dir

    # -- feeds ---------------------------------------------------------------
    def note_query(self, entry: Dict[str, Any]) -> None:
        """A completed query with a retained span tree (QueryRegistry.end
        forwards entries that carry spans)."""
        with self._lock:
            self._spans.append(entry)

    def note_ledger_mark(self, snapshot: Dict[str, int],
                         ts: Optional[float] = None) -> None:
        with self._lock:
            self._ledger_marks.append(
                (time.time() if ts is None else ts, snapshot))

    def register_provider(self, name: str, fn: Callable[[], Any]) -> None:
        """State snapshots to include in every bundle (residency /
        scheduler / admission). Called only at freeze time — they may be
        arbitrarily heavy."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str, fn: Callable[[], Any]) -> None:
        """Drop provider ``name`` if it is still ``fn`` (its owner shut
        down; a later owner's provider of the same name stays)."""
        with self._lock:
            if self._providers.get(name) == fn:
                del self._providers[name]

    def note_event(self, kind: str, n: int = 1) -> None:
        """One anomaly-relevant event (rejection / eviction / demotion /
        pallas_decline). Cheap: timestamp appends + a burst check; a trip
        records a PENDING trigger only (see class docstring)."""
        spec = self.bursts.get(kind)
        now = self._clock()
        with self._lock:
            self._event_totals[kind] = self._event_totals.get(kind, 0) + n
            if spec is None:
                return
            threshold, window_s = spec
            dq = self._events.get(kind)
            if dq is None:
                dq = self._events[kind] = deque(maxlen=4 * threshold)
            for _ in range(n):
                dq.append(now)
            recent = sum(1 for t in dq if now - t <= window_s)
            if recent >= threshold:
                self._trip_locked(f"{kind}_burst", now)

    def note_p99_spike(self, key: str) -> None:
        """p99-anomaly trip from the sampler's baseline check."""
        with self._lock:
            self._trip_locked(f"p99_spike:{key}", self._clock())

    def _trip_locked(self, trigger: str, now: float) -> None:
        if now - self._last_freeze < self.min_freeze_interval_s:
            return
        if any(t == trigger for t, _ts in self._pending):
            return
        self._pending.append((trigger, now))

    # -- freeze --------------------------------------------------------------
    def process_pending(self, extra: Optional[Dict[str, Any]] = None
                        ) -> List[Dict[str, Any]]:
        """Freeze every pending trigger into a bundle (sampler thread /
        tests). Runs outside all caller locks by construction."""
        with self._lock:
            pending, self._pending = self._pending, []
        return [self.freeze(trigger, extra=extra)
                for trigger, _ts in pending]

    def freeze(self, trigger: str,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Assemble + persist one post-mortem bundle NOW."""
        with self._lock:
            spans = list(self._spans)
            marks = list(self._ledger_marks)
            providers = dict(self._providers)
            totals = dict(self._event_totals)
            self._last_freeze = self._clock()
        decisions: Dict[str, Any] = {}
        if marks:
            newest_ts, newest = marks[-1]
            oldest_ts, oldest = marks[0]
            decisions = {
                "sinceS": round(newest_ts - oldest_ts, 3),
                "delta": {k: v - oldest.get(k, 0)
                          for k, v in newest.items()
                          if v - oldest.get(k, 0)},
                "total": newest,
            }
        snapshots: Dict[str, Any] = {}
        for name, fn in providers.items():
            try:
                snapshots[name] = fn()
            except Exception as e:  # a broken provider must not kill the box
                snapshots[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
        bundle: Dict[str, Any] = {
            "trigger": trigger,
            "ts": time.time(),
            "iso": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
            "spanRoots": spans,
            "decisions": decisions,
            "snapshots": snapshots,
            "eventTotals": totals,
        }
        if extra:
            bundle.update(extra)
        path = self._persist(bundle)
        if path:
            bundle["path"] = path
        with self._lock:
            self.bundles.append(bundle)
            self.frozen += 1
        return bundle

    def _persist(self, bundle: Dict[str, Any]) -> Optional[str]:
        out_dir = self.out_dir
        if out_dir is None:
            import tempfile

            out_dir = os.path.join(tempfile.gettempdir(),
                                   "pinot_tpu_flightrecorder")
        try:
            os.makedirs(out_dir, exist_ok=True)
            trigger = "".join(c if c.isalnum() else "_"
                              for c in bundle["trigger"])[:48]
            path = os.path.join(
                out_dir, f"flight_{int(bundle['ts'] * 1e3)}_{trigger}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=str)
            return path
        except OSError:
            return None

    def snapshot(self) -> Dict[str, Any]:
        """``/debug/flightrecorder`` body: bundle index + the last bundle
        in full + live ring occupancy."""
        with self._lock:
            bundles = list(self.bundles)
            pending = [t for t, _ts in self._pending]
            return {
                "frozen": self.frozen,
                "pendingTriggers": pending,
                "spanRingSize": len(self._spans),
                "eventTotals": dict(self._event_totals),
                "bundles": [{"trigger": b["trigger"], "ts": b["ts"],
                             "iso": b["iso"], "path": b.get("path"),
                             "spanRoots": len(b["spanRoots"])}
                            for b in bundles],
                "last": bundles[-1] if bundles else None,
            }


# --------------------------------------------------------------------------
# the collector's pauses
# --------------------------------------------------------------------------

GC_GENERATIONS = 3


class _ReentrantHistogram(Histogram):
    """A :class:`Histogram` the collector's hook records into. A collection
    can start inside any allocation, one this thread makes while it holds
    the histogram's lock (a scrape's copy) included, so the lock is
    re-entrant; another thread's hook waits for it as any writer does."""

    __slots__ = ()

    def __init__(self):
        super().__init__()
        self._lock = threading.RLock()


class GcPauses:
    """The interpreter's garbage-collector pauses in this process: the
    cumulative ns and collections by generation, and a :class:`Histogram`
    of pause ms by generation. A collection stops every thread of the
    process, so a traced query reads the cumulative pause at its open and
    its close (:meth:`mark`) and records the difference.

    ``install`` adds one ``gc.callbacks`` hook (a second call adds none).
    The collector runs one collection at a time, so the hook is the only
    writer of the counts at any moment."""

    def __init__(self):
        self.pause_ns = [0] * GC_GENERATIONS
        self.collections = [0] * GC_GENERATIONS
        self.histos = [_ReentrantHistogram() for _ in range(GC_GENERATIONS)]
        self._start_ns = 0

    def install(self) -> "GcPauses":
        if self._hook not in gc.callbacks:
            gc.callbacks.append(self._hook)
        return self

    def _hook(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            self._start_ns = time.perf_counter_ns()
            return
        ns = time.perf_counter_ns() - self._start_ns
        gen = info["generation"]
        self.pause_ns[gen] += ns
        self.collections[gen] += 1
        self.histos[gen].record(ns / 1e6)

    def mark(self) -> Tuple[int, int, int]:
        """(pause ns, collections, gen-2 collections) so far."""
        return sum(self.pause_ns), sum(self.collections), self.collections[2]

    def clear(self) -> None:
        for gen in range(GC_GENERATIONS):
            self.pause_ns[gen] = 0
            self.collections[gen] = 0
            self.histos[gen].clear()

    def prometheus_lines(self, prefix: str) -> List[str]:
        """The ``<prefix>gc_pause_ms`` histogram family, one series a
        generation."""
        fam = f"{prefix}gc_pause_ms"
        lines = [f"# HELP {fam} Garbage-collector pauses by generation, "
                 f"log-bucketed (lifetime).",
                 f"# TYPE {fam} histogram"]
        for gen, h in enumerate(self.histos):
            labels = f'generation="{gen}"'
            for le, cum in h.bucket_rows():
                lines.append(f'{fam}_bucket{{{labels},le="{le}"}} {cum}')
            with h._lock:
                total, count = h.sum, h.count
            lines.append(f"{fam}_sum{{{labels}}} {round(total, 3)}")
            lines.append(f"{fam}_count{{{labels}}} {count}")
        return lines


# --------------------------------------------------------------------------
# the telemetry center
# --------------------------------------------------------------------------

class Telemetry:
    """One per process (:data:`TELEMETRY`): the (table, phase) histogram
    registry, the gauge-history rings + their sampler thread, the SLO
    tracker, and the flight recorder; the process's one also exports the
    collector's pauses (``gc_pauses``)."""

    def __init__(self, window_s: float = 30.0, num_windows: int = 10,
                 resolution_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 gc_pauses: Optional[GcPauses] = None):
        self.gc_pauses = gc_pauses
        self.window_s = window_s
        self.num_windows = num_windows
        self.resolution_s = resolution_s  # guarded-by-writes: _lock
        self._clock = clock
        self._lock = threading.Lock()
        # writes-only guard: the record path reads with a GIL-atomic
        # dict.get and only takes the lock to insert a new key
        self._histos: Dict[Tuple[str, str], WindowedHistogram] = {}  # guarded-by-writes: _lock
        self._rings: Dict[str, TimeRing] = {}  # guarded-by: _lock
        self._tracked: Dict[str, Callable[[], float]] = {}  # guarded-by: _lock
        self._p99_baseline: Dict[Tuple[str, str], float] = {}  # guarded-by: _lock
        self.slo = SloTracker(clock=clock, window_s=window_s,
                              num_windows=num_windows)
        self.recorder = FlightRecorder(clock=clock)  # guarded-by-writes: _lock
        self.p99_spike_factor = P99_SPIKE_FACTOR  # guarded-by-writes: _lock
        self._sampler: Optional[threading.Thread] = None  # guarded-by: _lock
        self._sampler_stop = threading.Event()

    # -- configuration -------------------------------------------------------
    def configure(self, config=None) -> None:
        """Apply config keys (window/resolution/recorder bounds) and parse
        per-table SLO objectives from the RAW key strings —
        ``pinot.broker.slo.<table>.p99.ms`` / ``.error.pct`` — so table
        names survive the relaxed-key normalization verbatim."""
        import re

        from pinot_tpu_torch.spi.config import CommonConstants, PinotConfiguration

        cfg = config if config is not None else PinotConfiguration()
        # the sampler loop reads these each tick; serialize the writes so
        # a live reconfigure publishes whole values (reads stay lock-free)
        with self._lock:
            self.resolution_s = max(0.25, cfg.get_float(
                CommonConstants.TELEMETRY_RESOLUTION_S_KEY,
                self.resolution_s))
            self.recorder.min_freeze_interval_s = cfg.get_float(
                CommonConstants.FLIGHT_MIN_INTERVAL_S_KEY,
                self.recorder.min_freeze_interval_s)
            out_dir = cfg.get_str(CommonConstants.FLIGHT_DIR_KEY, "")
            if out_dir:
                self.recorder.out_dir = out_dir
            self.p99_spike_factor = cfg.get_float(
                CommonConstants.FLIGHT_P99_FACTOR_KEY, self.p99_spike_factor)
        # built from the declared SLO_KEY_PREFIX constant, so the doc'd
        # key namespace and the parse can never drift
        pat = re.compile(
            re.escape(CommonConstants.SLO_KEY_PREFIX) + r"(?P<table>.+)"
            r"\.(?P<kind>p99\.ms|error\.pct|freshness\.ms)$",
            re.IGNORECASE)
        for raw in cfg.keys():
            m = pat.match(raw)
            if m is None:
                continue
            table, kind = m.group("table"), m.group("kind").lower()
            try:
                value = float(cfg.get(raw))
            except (TypeError, ValueError):
                continue
            if kind == "p99.ms":
                self.slo.set_objective(table, p99_ms=value)
            elif kind == "freshness.ms":
                self.slo.set_objective(table, freshness_ms=value)
            else:
                self.slo.set_objective(table, error_pct=value)

    # -- histograms ----------------------------------------------------------
    def histo(self, table: str, phase: str) -> WindowedHistogram:
        key = (table or "", phase)
        h = self._histos.get(key)  # lock-free hit: THE record hot path
        if h is None:
            with self._lock:
                h = self._histos.get(key)
                if h is None:
                    h = WindowedHistogram(self.window_s, self.num_windows,
                                          clock=self._clock)
                    self._histos[key] = h
        return h

    def observe(self, table: str, phase: str, ms: float) -> None:
        """THE record path: one dict probe + one histogram record."""
        self.histo(table, phase).record(ms)

    def note_broker_query(self, table: str, ms: float, error: bool) -> None:
        """Broker front-door completion: latency histogram + SLO counters."""
        self.observe(table, "broker", ms)
        self.slo.note_request(table or "", error)

    def note_rejection(self, table: str) -> None:
        self.recorder.note_event("rejection")

    def note_event(self, kind: str, n: int = 1) -> None:
        self.recorder.note_event(kind, n)

    # -- gauge-history rings -------------------------------------------------
    def track_gauge(self, name: str, fn: Callable[[], float],
                    start_sampler: bool = True) -> None:
        """Sample ``fn`` into a TimeRing every ``resolution_s`` seconds.
        A callback reads host counters only: it never waits for the card,
        and takes no lock the query path holds while it calls in here."""
        with self._lock:
            self._tracked[name] = fn
            if name not in self._rings:
                self._rings[name] = TimeRing()
        if start_sampler:
            self._ensure_sampler()

    def ring(self, name: str) -> Optional[TimeRing]:
        with self._lock:
            return self._rings.get(name)

    def _ensure_sampler(self) -> None:
        with self._lock:
            t = self._sampler
            if t is not None and t.is_alive():
                return
            self._sampler_stop = threading.Event()
            t = threading.Thread(target=self._sample_loop, daemon=True,
                                 name="telemetry-sampler")
            self._sampler = t
        t.start()

    def _sample_loop(self) -> None:
        stop = self._sampler_stop
        while not stop.wait(self.resolution_s):
            try:
                self.sample_now()
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "telemetry sample tick failed")

    @property
    def sampling(self) -> bool:
        """Is the sampler thread running?"""
        with self._lock:
            t = self._sampler
        return t is not None and t.is_alive()

    def untrack_gauge(self, name: str) -> None:
        """Stop sampling ``name`` (its owner shut down); its ring stays."""
        with self._lock:
            self._tracked.pop(name, None)

    def stop_sampler(self) -> None:
        """Stop the sampler thread and wait for it (it is started again by
        the next ``track_gauge``)."""
        self._sampler_stop.set()
        with self._lock:
            t, self._sampler = self._sampler, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def sample_now(self) -> None:
        """One sampler tick, callable synchronously (tests / scrapes):
        sample tracked gauges into their rings, append a decision-ledger
        mark, evaluate the p99-anomaly baselines, and process pending
        flight-recorder triggers into bundles."""
        ts = time.time()
        with self._lock:
            tracked = list(self._tracked.items())
            rings = dict(self._rings)
        for name, fn in tracked:
            try:
                rings[name].append(float(fn()), ts)
            except Exception:
                pass  # a broken gauge must not kill the sampler
        from pinot_tpu_torch.common.tracing import LEDGER

        self.recorder.note_ledger_mark(LEDGER.snapshot(), ts)
        self._check_p99_anomalies()
        self.recorder.process_pending()

    def _check_p99_anomalies(self) -> None:
        """Sliding p99 vs its own EWMA baseline, per (table, phase): a
        spike past ``p99_spike_factor`` x baseline trips the recorder."""
        with self._lock:
            histos = dict(self._histos)
        for key, wh in histos.items():
            sl = wh.sliding()
            if sl.count < P99_SPIKE_MIN_COUNT:
                continue
            p99 = sl.quantile(0.99)
            with self._lock:
                base = self._p99_baseline.get(key)
                if base is None:
                    self._p99_baseline[key] = p99
                    continue
                spiked = base > 0 and p99 > self.p99_spike_factor * base
                self._p99_baseline[key] = (P99_EWMA_ALPHA * p99
                                           + (1 - P99_EWMA_ALPHA) * base)
            if spiked:
                self.recorder.note_p99_spike(f"{key[0]}:{key[1]}")

    # -- views ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """``/debug/telemetry`` body: every (table, phase) histogram with
        lifetime AND sliding quantiles, the gauge-history rings, and the
        anomaly-event totals."""
        with self._lock:
            histos = dict(self._histos)
            rings = dict(self._rings)
        return {
            "resolutionS": self.resolution_s,
            "windowS": self.window_s,
            "numWindows": self.num_windows,
            "histograms": {f"{t or '_'}:{p}": h.snapshot()
                           for (t, p), h in sorted(histos.items())},
            "rings": {name: r.values() for name, r in sorted(rings.items())},
            "events": self.recorder.snapshot()["eventTotals"],
        }

    def slo_snapshot(self) -> Dict[str, Any]:
        """``/debug/slo`` body: per configured table, objectives + the
        short/long-window burn rates."""
        tables = self.slo.objectives()
        with self._lock:
            histos = dict(self._histos)
        return {
            "tables": {t: self.slo.burn_rates(
                t, histos.get((t, "broker")),
                freshness_histo=histos.get((t, "freshness")))
                for t in sorted(tables)},
        }

    def freshness_snapshot(self) -> Dict[str, Any]:
        """``/debug/freshness`` body: per table with a ``freshness``
        histogram, the ingest-to-queryable quantiles (sliding + lifetime)
        plus the freshness objective/burn when one is configured."""
        with self._lock:
            histos = {t: h for (t, p), h in self._histos.items()
                      if p == "freshness"}
        objectives = self.slo.objectives()
        out: Dict[str, Any] = {"tables": {}}
        for t in sorted(histos):
            h = histos[t]
            body: Dict[str, Any] = {"histogram": h.snapshot()}
            obj = (objectives.get(t) or {}).get("freshness_ms")
            if obj:
                body["objectiveMs"] = obj
                body["burn"] = self.slo.burn_rates(
                    t, None, freshness_histo=h).get("freshness")
            out["tables"][t] = body
        return out

    def burn_gauges(self) -> Dict[Tuple[str, str, str], float]:
        """(table, objective, window) -> burn rate, for the
        ``slo_burn_rate`` exposition family (None burns are omitted)."""
        out: Dict[Tuple[str, str, str], float] = {}
        snap = self.slo_snapshot()["tables"]
        for table, body in snap.items():
            for objective, key in (("p99", "latency"), ("error", "errors"),
                                   ("freshness", "freshness")):
                for window, cell in (body.get(key) or {}).items():
                    burn = cell.get("burnRate")
                    if burn is not None:
                        out[(table, objective, window)] = burn
        return out

    # -- exposition ----------------------------------------------------------
    def export_prometheus(self, prefix: str) -> str:
        """Real exposition-format families for the continuous layer:
        ``<prefix>query_phase_latency_ms`` histograms labeled
        (table, phase) with ``_bucket``/``_sum``/``_count``,
        ``<prefix>slo_burn_rate`` gauges, and, with ``gc_pauses``, the
        ``<prefix>gc_pause_ms`` histograms labeled by generation."""
        with self._lock:
            histos = sorted(self._histos.items())
        lines: List[str] = []
        fam = f"{prefix}query_phase_latency_ms"
        if histos:
            lines.append(f"# HELP {fam} Query latency by (table, phase), "
                         f"log-bucketed (lifetime).")
            lines.append(f"# TYPE {fam} histogram")
            for (table, phase), wh in histos:
                labels = f'table="{table}",phase="{phase}"'
                h = wh.lifetime
                for le, cum in h.bucket_rows():
                    lines.append(f'{fam}_bucket{{{labels},le="{le}"}} {cum}')
                with h._lock:
                    total, count = h.sum, h.count
                lines.append(f"{fam}_sum{{{labels}}} {round(total, 3)}")
                lines.append(f"{fam}_count{{{labels}}} {count}")
        burns = self.burn_gauges()
        if burns:
            bfam = f"{prefix}slo_burn_rate"
            lines.append(f"# HELP {bfam} SLO burn rate (1.0 = burning the "
                         f"budget exactly) per table/objective/window.")
            lines.append(f"# TYPE {bfam} gauge")
            for (table, objective, window), burn in sorted(burns.items()):
                lines.append(
                    f'{bfam}{{table="{table}",objective="{objective}",'
                    f'window="{window}"}} {burn}')
        if self.gc_pauses is not None:
            lines += self.gc_pauses.prometheus_lines(prefix)
        return "\n".join(lines) + ("\n" if lines else "")

    # -- test hygiene --------------------------------------------------------
    def reset(self) -> None:
        """Clear recorded state (histograms, rings, SLO counters, flight
        recorder rings/bundles, the collector's pause counts). Objectives
        and the collector's hook survive; tests isolating the process-wide
        instance call this."""
        self.stop_sampler()
        if self.gc_pauses is not None:
            self.gc_pauses.clear()
        with self._lock:
            self._histos.clear()
            self._rings.clear()
            self._tracked.clear()
            self._p99_baseline.clear()
            self.slo = SloTracker(clock=self._clock, window_s=self.window_s,
                                  num_windows=self.num_windows)
            out_dir = self.recorder.out_dir
            self.recorder = FlightRecorder(out_dir=out_dir,
                                           clock=self._clock)


# the process's collector pauses: one hook, installed with the center
GC_PAUSES = GcPauses()
TELEMETRY = Telemetry(gc_pauses=GC_PAUSES.install())


# mapping from the residency manager's meter mnemonics to anomaly-event
# kinds (the storm triggers); called from the engine's accounting paths,
# possibly under locks — note_event never freezes synchronously
_STORM_EVENTS = {
    "STAGING_EVICTIONS": "eviction",
    "STAGING_DEMOTIONS": "demotion",
    "STAGING_HOST_DROPS": "eviction",
}


def note_storm_event(meter_name: Optional[str], n: int = 1) -> None:
    if not meter_name or n <= 0:
        return
    kind = _STORM_EVENTS.get(meter_name)
    if kind is not None:
        TELEMETRY.note_event(kind, n)


def observe_ms(table: Optional[str], phase: str, ms: float) -> None:
    """Module-level record helper so instrumentation sites stay one line."""
    TELEMETRY.observe(table or "", phase, ms)
