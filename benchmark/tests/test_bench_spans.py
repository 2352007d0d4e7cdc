"""The readers of the program's spans (``harness/spans.py`` and the five
metrics that read it) on hand-made span trees, with a profile whose device
events and clock are known: every number worked out by hand below."""

import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the repository on the path)

from benchmark.harness import spec
from benchmark.harness.observe import Observation, QueryRecord
from benchmark.harness.profile import DeviceEvent, Profiler
from benchmark.harness.spans import label_gaps, on_trace

US = 1000   # ns


def span(name, t0_us, t1_us, *children, **attrs):
    d = {"name": name, "ms": (t1_us - t0_us) / 1e3, "t0Ns": t0_us * US,
         **attrs}
    if children:
        d["children"] = list(children)
    return d


def batch_root(t0, prune, bind, combine, launch, decode, reduce, release,
               end, **attrs):
    """A batch-path ServerQuery tree from its steps' boundaries (us)."""
    return span("ServerQuery", t0, end,
                span("Admission", t0, t0),
                span("Prune", t0, prune),
                span("Lease", prune, bind[0]),
                span("Bind", bind[0], bind[1]),
                span("ShardedCombine", bind[1], combine,
                     span("Launch", launch[0], launch[1], batchSize=1,
                          riders=[1])),
                span("Decode", combine, decode),
                span("Reduce", decode, reduce),
                span("Release", reduce, release), **attrs)


def record(template, t0, tc, t1, root):
    return QueryRecord(client=0, template=template, variant=0,
                       t0_ns=t0 * US, t1_ns=t1 * US, tc_ns=tc * US,
                       spans=[root])


def profile(events, window=(0.0, 1000.0)):
    """A stopped profiler whose trace clock is the host's, in us."""
    p = Profiler()
    p.window = window
    p.events = [DeviceEvent("fused_scan_kernel", s, e) for s, e in events]
    return p


# query A compiles 0-50 us, its root runs 100-600 and the client has the
# rows at 620; query B compiles 620-660, its root runs 680-950, rows at
# 1000. A's kernel runs 300-340, B's 850-870, on a 1000 us window.
A = record("Q1.1", 0, 50, 620,
           batch_root(100, 150, (160, 200), 400, (220, 380), 520, 560, 590,
                      600, gcMs=0.1, gcCount=1))
B = record("Q1.1", 620, 660, 1000,
           batch_root(680, 790, (790, 820), 900, (830, 890), 930, 940, 945,
                      950))
DEVICE = [(300.0, 340.0), (850.0, 870.0)]


def obs(*queries, events=DEVICE):
    return Observation(list(queries), {}, profile(events) if events else None)


def readers():
    names = ("prelaunch_ms", "launch_ms", "result_host_ms", "gc_share",
             "idle_unnamed_share")
    return spec.metric_readers(ROOT, [{"name": n} for n in names])


def test_readers_on_two_batch_queries():
    got = {n: rd.read(obs(A, B)) for n, rd in readers().items()}
    assert got["prelaunch_ms"] == pytest.approx((0.1 + 0.14) / 2)
    assert got["launch_ms"] == pytest.approx((0.16 + 0.06) / 2)
    assert got["result_host_ms"] == pytest.approx((0.2 + 0.05) / 2)
    assert got["gc_share"] == pytest.approx(100 * 0.1 / (0.5 + 0.27))
    # inside the roots (500 + 270 us), under no step: 590-600, 945-950
    assert got["idle_unnamed_share"] == pytest.approx(100 * 15 / 770)


def test_gaps_labelled_by_the_deepest_span():
    """The gap 340-850 spans A's Decode (120 us) and B's Prune (110 us),
    with smaller pieces of ten other steps between: Decode overlaps it
    most. The gap 0-300 is most A's Launch (80 us), 870-1000 most the
    client's rows after B's root (50 us)."""
    got = label_gaps(obs(A, B))
    assert [g[0] for g in got] == ["Decode", "Launch", "bench.execute Q1.1"]
    assert [g[1] for g in got] == pytest.approx([510e-6, 300e-6, 130e-6])


def test_spans_on_the_trace_clock():
    p = profile(DEVICE)
    p._offset_us = 40.0
    laid = on_trace(A.spans[0], p)
    assert laid[0] == ("ServerQuery", 0, 60.0, 560.0)
    assert ("Launch", 2, 180.0, 340.0) in laid
    assert len(laid) == 10


def test_a_query_without_a_combine():
    """A per-segment query has a root and no ShardedCombine: it counts in
    gc_share and the idle cover, not in the combine's before and after."""
    C = record("Q2.1", 0, 50, 620,
               span("ServerQuery", 100, 600, span("Prune", 100, 150),
                    span("SegmentGroupBy", 150, 580), gcMs=0.25))
    got = {n: rd.read(obs(C)) for n, rd in readers().items()}
    assert got["prelaunch_ms"] is None and got["result_host_ms"] is None
    assert got["launch_ms"] is None
    assert got["gc_share"] == pytest.approx(50.0)
    # inside its root, under no step: 580-600
    assert got["idle_unnamed_share"] == pytest.approx(4.0)
    mixed = {n: rd.read(obs(C, B)) for n, rd in readers().items()}
    assert mixed["prelaunch_ms"] == pytest.approx(0.14)
    assert mixed["result_host_ms"] == pytest.approx(0.05)


def test_idle_unnamed_inside_the_roots_alone():
    """Device work covers a root's time as a step does; a root is cut at
    the sub-window's end; the client's compile and its wait after the root
    do not count, so a slower client leaves the share as it was."""
    D = record("Q2.1", 0, 50, 1300,
               span("ServerQuery", 800, 1200, span("Prune", 800, 850)))
    share = readers()["idle_unnamed_share"]
    # 800-1000 in the window: 50 us Prune, 50 us the kernel at 900-950
    assert share.read(obs(D, events=[(900.0, 950.0)])) == \
        pytest.approx(50.0)
    slow = record("Q2.1", 0, 700, 1300, D.spans[0])
    assert share.read(obs(slow, events=[(900.0, 950.0)])) == \
        pytest.approx(50.0)


def test_a_program_without_the_clock_gives_nothing():
    """Trees without t0Ns (a program that records no start), a failed
    query, and a run without a trace: every reader returns None."""
    def strip(d):
        out = {k: v for k, v in d.items() if k not in ("t0Ns", "children")}
        if "children" in d:
            out["children"] = [strip(c) for c in d["children"]]
        return out

    old = record("Q1.1", 0, 50, 620, strip(A.spans[0]))
    failed = record("Q1.1", 0, 50, 620, A.spans[0])
    failed.error = "RuntimeError: boom"
    for o in (obs(old), obs(failed), obs(old, events=[])):
        assert {n: rd.read(o) for n, rd in readers().items()} == \
            dict.fromkeys(readers(), None)
    assert readers()["idle_unnamed_share"].read(obs(A, events=[])) is None
