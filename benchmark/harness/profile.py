"""The device trace of a steady sub-window, and what is read from it.

``Profiler`` runs ``torch.profiler`` (CPU and CUDA activities) over a
sub-window of the measured window, from the main thread. The main thread
marks the sub-window's ends with ``bench.mark`` ranges, which place the
host clock on the trace's timeline; the clients' own host intervals (their
``bench.compile`` and ``bench.execute`` ranges, timed on the host clock)
are laid onto it that way, so the trace's idle gaps can be labelled by what
the clients were doing.

``busy_us`` is a copy of ``pinot_tpu_torch/tools/scan_profile.py``'s
``_busy_us``: the length of the union of the events' time ranges.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

MARK = "bench.mark"


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float


def busy_us(events: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of the (start, end) ranges."""
    spans = sorted(events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


class Profiler:
    """The profiler over one sub-window; ``window_us`` and ``events`` once
    it has stopped, and ``host_us(ns)`` to place a host time on the trace."""

    def __init__(self):
        self._prof = None
        self._marks_ns: List[int] = []
        self.window: Optional[Tuple[float, float]] = None
        self.events: List[DeviceEvent] = []
        self._offset_us = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        with record_function(MARK):
            self._marks_ns.append(time.perf_counter_ns())

    def stop(self) -> None:
        import torch
        from torch.profiler import record_function

        with record_function(MARK):
            self._marks_ns.append(time.perf_counter_ns())
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._read()

    def _read(self) -> None:
        from torch.autograd import DeviceType

        marks, device = [], []
        for e in self._prof.events():
            if e.device_type == DeviceType.CUDA:
                device.append(e)
            elif e.name == MARK:
                marks.append(e.time_range.start)
        marks.sort()
        if len(marks) >= 2:
            offsets = [m_ns / 1e3 - t for m_ns, t in
                       zip(self._marks_ns, (marks[0], marks[-1]))]
            self._offset_us = sum(offsets) / len(offsets)
            w0, w1 = marks[0], marks[-1]
        else:   # no mark in the trace: the window is the host's
            self._offset_us = 0.0
            w0, w1 = (self._marks_ns[0] / 1e3, self._marks_ns[-1] / 1e3)
        self.window = (w0, w1)
        for e in device:
            s = max(e.time_range.start, w0)
            t = min(e.time_range.end, w1)
            if t > s:
                self.events.append(DeviceEvent(e.name, s, t))
        self._prof = None

    def host_us(self, t_ns: int) -> float:
        """A host ``perf_counter_ns`` reading on the trace's timeline."""
        return t_ns / 1e3 - self._offset_us

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    def busy_us(self) -> float:
        return busy_us([(e.start_us, e.end_us) for e in self.events])


def device_ops(events: Sequence[DeviceEvent], top: int = 10
               ) -> List[List]:
    """[name, seconds] of the device operations that took most time."""
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e.name] += (e.end_us - e.start_us) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


def idle_gaps(events: Sequence[DeviceEvent], window: Tuple[float, float],
              host: Sequence[Tuple[str, float, float]], top: int = 10
              ) -> List[List]:
    """[label, seconds] of the longest stretches with nothing on the
    device, each labelled by the host interval (label, start_us, end_us)
    that overlaps it most, or ``bench.idle`` where none does."""
    spans = sorted((e.start_us, e.end_us) for e in events)
    gaps, end = [], window[0]
    for s, e in spans:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if window[1] > end:
        gaps.append((end, window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:top]:
        best, label = 0.0, "bench.idle"
        for name, h0, h1 in host:
            ov = min(g1, h1) - max(g0, h0)
            if ov > best:
                best, label = ov, name
        out.append([label, (g1 - g0) / 1e6])
    return out
