"""Device time of the fused-scan kernel and of the general rung on the SSB
flights, from ``torch.profiler`` traces on one CUDA card.

    PYTHONPATH=. python3 pinot_tpu_torch/tools/scan_profile.py [--sf 10]
        [--segments 8] [--seed 42] [--iters 20] [--out FILE]

For each flight and path (per segment on segment 0, and the whole batch in
one launch) it traces ``--iters`` scans through the path's own wrapper
(``scan_inputs(...).scan()``, and the probe where the flight probes) and
reports the kernel's mean device time per launch, whatever the wrapper's
host work costs (a trace that holds fewer kernel events than launches is
taken again, up to ``TRIES`` times). Then it traces one pass of the 13 flights through each
executor and reports the device's busy share of that pass (the union of
all device activity over the host-clock time) and the device time by
kernel name. The tree timed is the one first on ``PYTHONPATH``. The script
uses only entry points every tree of the port has since the batch path,
so an older tree is timed the same way: put its root on ``PYTHONPATH`` and
run this file from the newer one.

Where the tree has the general rung (``engine/kernels.py``), it then
traces one segment call of each rung (``RUNG_QUERIES``, on the segment
where the query takes that rung with the most matched docs) ``--iters``
times: device time per call (the sum of its CUDA events), the CUDA
kernels it launches per call, and a byte bound (filter columns' int32
dictIds on every doc, the other columns' on matched docs, dictionary
values and params once, the packed output once, at 3.35 TB/s); and one
pass of the 13 flights with the fused scan off.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

KERNEL = "fused_scan_kernel"
# H100 SXM HBM3 rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
# row -> (query id or SQL, fused scan on, the group-by rung it takes or
# None for a scalar query): one query per rung of the general rung's
# ladder; ids name tools/ssb.py's flights and declined queries
RUNG_QUERIES = {
    "dense": ("Q3.1", False, "dense"),
    "compact": ("SELECT c_city, p_category, SUM(lo_revenue) "
                "FROM ssb_lineorder WHERE s_region = 'ASIA' "
                "GROUP BY c_city, p_category LIMIT 100000", False, "compact"),
    "hash": ("Q3.2", False, "hash"),
    "sort": ("G2", True, "sort"),
    "scalar distinct": ("G4", True, None),
    "HLL (grouped, dense)": ("G5", True, "dense"),
}
# traces of one flight's launches before its device time is reported as
# not measured
TRIES = 3


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(events) -> float:
    """Length of the union of the events' time ranges."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _traced(fn, n: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _device_events(prof), wall_us


def _kernel_ms(fn, n: int):
    """(mean device ms of the ``n`` launches' kernel events, traces taken):
    None when no trace of ``TRIES`` held an event for every launch."""
    for tries in range(1, TRIES + 1):
        events, _ = _traced(fn, n)
        ks = [e.time_range.elapsed_us() for e in events if e.name == KERNEL]
        if len(ks) == n:
            return sum(ks) / n / 1e3, tries
    return None, TRIES


def _scan_times(staged, iters: int, path: str) -> list:
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    rows = []
    for qid, q in ssb.QUERIES.items():
        plan = plan_segment(compile_query(q + " LIMIT 100000"),
                            staged.provider)
        inp = fs.scan_inputs(plan, staged)
        launches = {"scan": inp.scan}
        if inp.probe is not None:
            prog, words = inp.probe
            launches["probe"] = (lambda p=prog, w=words:
                                 inp.kernels.probe(p, w, inp.num_docs))
        for kind, fn in launches.items():
            ms, tries = _kernel_ms(fn, iters)
            rows.append({"path": path, "flight": qid, "kind": kind,
                         "kernel_ms": ms, "traces": tries})
            print(f"  {path} {qid} {kind}: "
                  f"{'not measured' if ms is None else f'{ms:.4f} ms'}"
                  f" ({tries} trace{'s' if tries > 1 else ''} of {iters} "
                  f"launches)", flush=True)
    return rows


def _pass_profile(ex, ctxs, segs, path: str) -> dict:
    """One pass of the flights through ``ex``: busy share and device time
    by name."""
    def one_pass():
        for ctx in ctxs.values():
            ex.execute(ctx, segs)

    events, wall_us = _traced(one_pass, 1)
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = _busy_us(events)
    out = {"path": path, "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "busy_share": busy / wall_us if wall_us else None,
           "device_ms_by_name": {k: v / 1e3 for k, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])}}
    print(f"  {path} pass of {len(ctxs)} flights: wall "
          f"{out['wall_ms']:.3f} ms, device busy {out['busy_ms']:.3f} ms "
          f"({100 * (out['busy_share'] or 0):.1f}%)", flush=True)
    for name, ms in list(out["device_ms_by_name"].items())[:6]:
        print(f"    {ms:.3f} ms  {name[:90]}", flush=True)
    return out


def _filter_columns(node, out: set) -> set:
    if node[0] in ("and", "or", "not"):
        for c in node[1]:
            _filter_columns(c, out)
    elif node[0] not in ("true", "false"):
        out.add(node[1])
    return out


def _rung_bytes(plan, staged, matched: int, packed_len: int, params) -> int:
    """Bytes one rung call must move: each filter column's int32 dictIds
    for every doc, the other columns' for matched docs, the dictionary
    values and params once, the packed f64 output once."""
    filt = _filter_columns(plan.spec[0], set())
    total = 8 * packed_len + sum(p.numel() * p.element_size()
                                 for p in params)
    for name in plan.columns:
        col = staged.column(name)
        total += 4 * (staged.num_docs if name in filt else matched)
        if col.dictvals is not None:
            total += col.dictvals.numel() * col.dictvals.element_size()
    return total


def _rung_rows(segs, iters: int) -> list:
    """One segment call of each rung, traced ``iters`` times."""
    import torch

    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    rows = []
    for rung, (q, fused, takes) in RUNG_QUERIES.items():
        sql = ssb.QUERIES.get(q, ssb.DECLINED_QUERIES.get(q, q))
        if q in ssb.QUERIES:
            sql += " LIMIT 100000"
        ctx = compile_query(sql)
        ex = ServerQueryExecutor(device="cuda", use_fused_scan=fused)
        best, calls = None, 0
        for seg in segs:
            _, st = ex.execute(ctx, [seg])
            if (st.general_launches
                    and next(iter(st.rung_segments), None) == takes):
                calls += 1
                if best is None or st.num_docs_scanned > best[1]:
                    best = (seg, st.num_docs_scanned)
        if best is None:
            print(f"  rung {rung}: no segment took it", flush=True)
            rows.append({"rung": rung, "query": q, "device_ms": None})
            continue
        seg, matched = best
        staged = ex.stage(seg)
        plan = ex._plan_for(ctx, seg)
        cols = {n: staged.column(n).tree() for n in plan.columns}
        params = kernels.device_params(plan, ex.device)
        kernel = ex.kernels.get(plan.spec)
        packed_len = kernel(cols, params, seg.num_docs).numel()
        events, wall_us = _traced(
            lambda: kernel(cols, params, seg.num_docs), iters)
        launched = [e for e in events
                    if not e.name.startswith(("Memcpy", "Memset"))]
        device_ms = (sum(e.time_range.elapsed_us() for e in events)
                     / iters / 1e3)
        nbytes = _rung_bytes(plan, staged, matched, packed_len, params)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"rung": rung, "query": q, "segment": seg.segment_name,
               "docs": seg.num_docs, "matched": matched,
               "groups": plan.spec[3], "device_ms": device_ms,
               "wall_ms": wall_us / iters / 1e3,
               "kernels_per_call": len(launched) / iters,
               "events_per_call": len(events) / iters,
               "segments_per_pass": calls, "bytes": nbytes,
               "bound_ms": bound,
               "kernels_by_name": _count_names(launched, iters)}
        rows.append(row)
        torch.cuda.synchronize()
        print(f"  rung {rung} ({q[:24]}, {seg.segment_name}, {matched} of "
              f"{seg.num_docs} docs): device {device_ms:.4f} ms/call "
              f"({device_ms / bound:.1f}x bound {bound:.4f} ms), wall "
              f"{row['wall_ms']:.4f} ms, {row['kernels_per_call']:.1f} CUDA "
              f"kernels/call, {calls} of {len(segs)} segments per pass",
              flush=True)
    return rows


def _count_names(events, iters: int) -> dict:
    counts = defaultdict(int)
    for e in events:
        counts[e.name[:80]] += 1
    return {k: v / iters for k, v in sorted(counts.items(),
                                             key=lambda kv: -kv[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_profile: needs a CUDA card", file=sys.stderr)
        return 2
    import pinot_tpu_torch
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(f"scan_profile: package {pinot_tpu_torch.__file__}, {card}",
          flush=True)
    segs, _frames = ssb.build_segments(args.sf, num_segments=args.segments,
                                       seed=args.seed)
    del _frames
    ctxs = {qid: compile_query(q + " LIMIT 100000")
            for qid, q in ssb.QUERIES.items()}
    seg_ex = ServerQueryExecutor(device="cuda")
    batch_ex = ShardedQueryExecutor(device="cuda")
    for ctx in ctxs.values():   # stage, bind and build before tracing
        seg_ex.execute(ctx, segs)
        batch_ex.execute(ctx, segs)
    torch.cuda.synchronize()
    _batch, staged_batch = batch_ex.batch_for(segs)

    report = {"card": card, "args": vars(args),
              "package": pinot_tpu_torch.__file__}
    report["kernel"] = (
        _scan_times(seg_ex.stage(segs[0]), args.iters, "segment")
        + _scan_times(staged_batch, args.iters, "batch"))
    report["passes"] = [_pass_profile(seg_ex, ctxs, segs, "segment"),
                        _pass_profile(batch_ex, ctxs, segs, "batch")]
    try:
        from pinot_tpu_torch.engine import kernels  # noqa: F401
    except ImportError:   # a tree from before the general rung
        kernels = None
    if kernels is not None:
        general_ex = ServerQueryExecutor(device="cuda", use_fused_scan=False)
        for ctx in ctxs.values():
            general_ex.execute(ctx, segs)
        torch.cuda.synchronize()
        report["passes"].append(_pass_profile(general_ex, ctxs, segs,
                                              "general (fused scan off)"))
        del general_ex
        report["rungs"] = _rung_rows(segs, args.iters)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
