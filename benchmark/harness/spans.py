"""The program's span trees, as the per-layer metrics read them.

A traced query's spans (``QueryRecord.spans``) are the port's
``ServerQuery`` tree. Each span carries its start as ``t0Ns``, a
``time.perf_counter_ns`` reading, beside its ``ms``: the clock the
profiler's ``bench.mark`` ranges pin to the device trace, so
``on_trace`` lays a span on the trace's timeline with
``Profiler.host_us``. ``label_gaps`` names each idle gap of the device
by the deepest span that overlaps it most: the host intervals it hands
``profile.idle_gaps`` are each span's self time (its interval less its
children's), and, outside the program's root, the client's
``bench.compile`` and ``bench.execute``. ``unnamed_idle_us`` measures,
inside the roots alone, the time that no step of the program and no
device work covers. A program whose spans carry no ``t0Ns`` gives
nothing to read: the readers then return None.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from benchmark.harness.profile import busy_us, idle_gaps

ROOT = "ServerQuery"

Interval = Tuple[float, float]


def roots(obs) -> Iterator[Tuple[object, Dict]]:
    """(query record, its ServerQuery root) of every query of the window
    that finished and whose root is on the clock."""
    for q in obs.queries:
        if q.error is not None:
            continue
        for s in q.spans:
            if s.get("name") == ROOT and "t0Ns" in s:
                yield q, s


def end_ns(span: Dict) -> float:
    return span["t0Ns"] + span["ms"] * 1e6


def named(span: Dict, name: str) -> List[Dict]:
    """Every span named ``name`` below ``span``, in pre-order."""
    out = []
    for c in span.get("children", ()):
        if c.get("name") == name:
            out.append(c)
        out.extend(named(c, name))
    return out


def _walk(span: Dict, depth: int = 0) -> Iterator[Tuple[Dict, int]]:
    yield span, depth
    for c in span.get("children", ()):
        yield from _walk(c, depth + 1)


def on_trace(root: Dict, profile) -> List[Tuple[str, int, float, float]]:
    """(name, depth, start_us, end_us) on the trace's timeline of every
    span of ``root``'s tree on the clock (the root at depth 0)."""
    return [(s["name"], d, profile.host_us(s["t0Ns"]),
             profile.host_us(end_ns(s)))
            for s, d in _walk(root) if "t0Ns" in s]


def _less(span: Interval, parts: Sequence[Interval]) -> List[Interval]:
    """``span`` less the union of ``parts``, as disjoint intervals."""
    out, at = [], span[0]
    for s, e in sorted(parts):
        if s > at:
            out.append((at, min(s, span[1])))
        at = max(at, e)
        if at >= span[1]:
            break
    if span[1] > at:
        out.append((at, span[1]))
    return [(s, e) for s, e in out if e > s]


def _self_time(span: Dict, profile) -> Iterator[Tuple[str, float, float]]:
    """(name, start_us, end_us) of the pieces of the tree where each span
    is the deepest one open."""
    me = (profile.host_us(span["t0Ns"]), profile.host_us(end_ns(span)))
    kids = [c for c in span.get("children", ()) if "t0Ns" in c]
    for s, e in _less(me, [(profile.host_us(c["t0Ns"]),
                            profile.host_us(end_ns(c))) for c in kids]):
        yield span["name"], s, e
    for c in kids:
        yield from _self_time(c, profile)


def host_pieces(obs) -> List[Tuple[str, float, float]]:
    """Disjoint (label, start_us, end_us) of what each client was doing on
    the trace's timeline: the program's spans by self time, and the
    client's compile and its execute outside the program's root."""
    p = obs.profile
    out: List[Tuple[str, float, float]] = []
    for q in obs.queries:
        tc = q.tc_ns or q.t1_ns
        out.append((f"bench.compile {q.template}", p.host_us(q.t0_ns),
                    p.host_us(tc)))
        execute = (p.host_us(tc), p.host_us(q.t1_ns))
        rs = [s for s in q.spans if s.get("name") == ROOT and "t0Ns" in s]
        for s, e in _less(execute, [(p.host_us(r["t0Ns"]),
                                     p.host_us(end_ns(r))) for r in rs]):
            out.append((f"bench.execute {q.template}", s, e))
        for r in rs:
            out.extend(_self_time(r, p))
    return out


def label_gaps(obs, top: int = 10) -> List[List]:
    """[label, seconds] of the device's longest idle gaps in the traced
    sub-window, each named by the host piece (``host_pieces``) that
    overlaps it most, or ``bench.idle`` where none does."""
    p = obs.profile
    return idle_gaps(p.events, p.window, host_pieces(obs), top)


def unnamed_idle_us(obs) -> Optional[Tuple[float, float]]:
    """(unnamed, root) us: of the traced sub-window's time inside the
    ServerQuery roots (root), the part that neither a span below its root
    nor the device covers (unnamed); None where the run holds no trace or
    no root on the clock."""
    p = obs.profile
    if p is None or p.window_us <= 0 or not p.events:
        return None
    w0, w1 = p.window
    device = _union([(e.start_us, e.end_us) for e in p.events])
    starts = [s for s, _e in device]
    unnamed = root_us = 0.0
    for _q, r in roots(obs):
        laid = on_trace(r, p)
        r0, r1 = max(laid[0][2], w0), min(laid[0][3], w1)
        if r1 <= r0:
            continue
        cover = [(max(s, r0), min(e, r1)) for _n, d, s, e in laid[1:]]
        lo = max(bisect_right(starts, r0) - 1, 0)
        cover += [(max(s, r0), min(e, r1))
                  for s, e in device[lo:bisect_left(starts, r1)]]
        root_us += r1 - r0
        unnamed += (r1 - r0) - busy_us([(s, e) for s, e in cover if e > s])
    if root_us <= 0:
        return None
    return unnamed, root_us


def _union(parts: Sequence[Interval]) -> List[Interval]:
    """The union of ``parts`` as disjoint intervals, in order."""
    out: List[Interval] = []
    for s, e in sorted(parts):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
