"""One run of one cell: set-up, the measured window, the check, the line.

``run`` makes the cell's table from the seed on the device, hands it to
the port (which builds its segments), warms every SQL variant of the
traffic once, then lets the traffic's clients query in a closed loop for
``seconds``. Once the window has closed it reads the card's peak memory,
frees the port, works out every distinct SQL's answer with the reference
from the same table, holds every query of the window to it, and prints the
result's line. With ``trace`` the run profiles a steady sub-window and
prints the cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import spec, traffic as traffic_mod
from benchmark.harness.bytecount import query_bytes, segment_widths
from benchmark.harness.check import compare, fractional, verdict
from benchmark.harness.observe import Observation, QueryRecord, percentile
from benchmark.harness.peaks import HBM_BYTES_PER_S
from benchmark.harness.port import Port
from benchmark.harness.profile import (
    Profiler,
    device_ops,
    idle_gaps,
)
from benchmark.reference.evaluate import answer, segment_ranges

# modules no process of the benchmark may hold, by top-level name
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pinot_tpu"})
# where in the window the traced run's profiler starts, and its length
TRACE_AT = 0.3
TRACE_MAX_S = 4.0
JOIN_TIMEOUT_S = 120.0
# shorter windows read from the start of a longer one, for choosing the
# window's length (standard error only)
PREFIX_S = (10, 20, 30, 40)


def window_metrics(records: List[QueryRecord], t_start: float,
                   seconds: float) -> List[Optional[float]]:
    """(qps, p50_ms, p95_ms) of a window of ``seconds`` from ``t_start``:
    the queries submitted in it, those answered correctly by its end."""
    end_ns = int((t_start + seconds) * 1e9)
    mine = [r for r in records if r.t0_ns < end_ns]
    lat = [r.ms for r in mine]
    ok = sum(r.correct and r.t1_ns <= end_ns for r in mine)
    return [ok / seconds, percentile(lat, 50), percentile(lat, 95)]


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (to the kernel's
    10 ms tick), or now where ``/proc`` does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _client(port: Port, stream, variants, trace: bool, stop: threading.Event,
            out: List[QueryRecord], client: int) -> None:
    from torch.profiler import record_function

    suffix = " OPTION(trace=true)" if trace else ""
    while not stop.is_set():
        tid, vi = stream.next()
        sql = variants[tid][vi].sql + suffix
        t0 = time.perf_counter_ns()
        rec = QueryRecord(client, tid, vi, t0, t0)
        try:
            with record_function("bench.compile"):
                ctx = port.compile(sql)
            rec.tc_ns = time.perf_counter_ns()
            with record_function("bench.execute"):
                rows, stats = port.run(ctx)
            rec.rows = rows
            rec.launch = dict(stats.launch)
            if trace:
                rec.spans = list(stats.spans)
        except Exception as e:   # a failed query is counted, not fatal
            rec.error = f"{type(e).__name__}: {e}"[:300]
        rec.t1_ns = time.perf_counter_ns()
        out.append(rec)


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: Optional[Dict] = None,
        out=None, err=None, t_proc: Optional[float] = None) -> int:
    out = out or sys.stdout
    err = err or sys.stderr
    t_proc = process_start() if t_proc is None else t_proc

    def log(msg: str) -> None:
        print(msg, file=err, flush=True)

    cell = spec.load_cell(root, workload)
    chips = int(cell.workload["chips"])
    cuda = device.startswith("cuda")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cuda and have < chips:
        log(f"{workload} needs {chips} CUDA device(s); this process sees "
            f"{have}")
        return 2
    config = {**cell.config, **(overrides or {}).get("config", {})}
    traffic = {**cell.traffic, **(overrides or {}).get("traffic", {})}
    readers = spec.metric_readers(root, cell.per_layer) if trace else {}

    # -- set-up ---------------------------------------------------------------
    t0 = time.perf_counter()
    frame = spec.generator(root, config["generator"]).generate(
        config, seed, device)
    _sync(device)
    variants = traffic_mod.draw_variants(traffic, frame.table)
    generate_s = time.perf_counter() - t0
    port = Port(device, config.get("server", {}))
    prep_s, build_s = port.build(frame)
    host_frame = frame.to("cpu")
    del frame
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm_failed = 0
    warm_s: Dict[str, float] = {}
    for tid, vs in variants.items():
        tw = time.perf_counter()
        for v in vs:
            try:
                port.run(port.compile(v.sql))
            except Exception as e:   # the window counts it again
                warm_failed += 1
                log(f"warm-up {tid}[{v.index}] failed: {type(e).__name__}: "
                    f"{e}"[:300])
        warm_s[tid] = round(time.perf_counter() - tw, 3)
    _sync(device)
    stage_s = time.perf_counter() - t0
    counters0 = port.launcher_counters()

    # -- the window -----------------------------------------------------------
    records: List[QueryRecord] = []
    per_client: List[List[QueryRecord]] = [[] for _ in
                                           range(int(traffic["clients"]))]
    stop = threading.Event()
    threads = [threading.Thread(
        target=_client, name=f"bench-client-{c}",
        args=(port, traffic_mod.ClientStream(traffic, seed, c), variants,
              trace, stop, per_client[c], c))
        for c in range(len(per_client))]
    prof = Profiler() if trace else None
    t_start = time.perf_counter()
    setup_s = t_start - t_proc
    t_end = t_start + seconds
    for t in threads:
        t.start()
    if prof is not None:
        time.sleep(max(0.0, t_start + TRACE_AT * seconds
                       - time.perf_counter()))
        prof.start()
        time.sleep(min(TRACE_MAX_S, 0.4 * seconds))
        prof.stop()
    time.sleep(max(0.0, t_end - time.perf_counter()))
    stop.set()
    for t in threads:
        t.join(JOIN_TIMEOUT_S)
    hung = sum(t.is_alive() for t in threads)
    _sync(device)
    for recs in per_client:
        records.extend(recs)
    counters1 = port.launcher_counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    if hung:
        log(f"{hung} client(s) still in a query {JOIN_TIMEOUT_S} s after "
            "the window")
        return 4
    port.close()
    del port
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    t0 = time.perf_counter()
    ref = host_frame.to(device)
    want: Dict = {}
    failed = wrong = 0
    worst = 0.0
    any_frac = False
    for r in records:
        if r.error is not None:
            failed += 1
            continue
        q = variants[r.template][r.variant].query
        key = (r.template, r.variant)
        if key not in want:
            want[key] = answer(ref, q)
        same, rel = compare(q, r.rows, want[key])
        if fractional(q):
            any_frac = True
            worst = max(worst, rel)
        if not same:
            wrong += 1
            if wrong <= 5:
                log(f"wrong rows at {(r.t0_ns / 1e9 - t_start):.3f} s "
                    f"(client {r.client}, launch {json.dumps(r.launch)}): "
                    f"{variants[r.template][r.variant].sql}\n"
                    f"  got  {r.rows[:4]}\n  want {want[key][:4]}")
        else:
            r.correct = True
    if prof is not None:
        widths, ranges = segment_widths(ref), segment_ranges(ref)
        w0, w1 = prof.window
        for r in records:
            r.in_trace = w0 <= prof.host_us(r.t1_ns) <= w1
            if r.in_trace and r.error is None:
                r.bytes = query_bytes(
                    ref, variants[r.template][r.variant].query, widths,
                    ranges)
    del ref
    check_s = time.perf_counter() - t0
    correct, checks = verdict(traffic["limits"], failed, wrong, worst,
                              any_frac)

    # -- the line -------------------------------------------------------------
    setup = {"setup_s": setup_s, "build_s": build_s, "stage_s": stage_s,
             "generate_s": generate_s, "prep_s": prep_s}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and warm_failed == 0),
              "attempted": len(records), "failed": failed}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        qps, p50, p95 = window_metrics(records, t_start, seconds)
        values = {"qps": qps, "p50_ms": p50, "p95_ms": p95,
                  "setup_s": setup_s}
        metrics = {m["name"]: values.get(m["name"])
                   for m in cell.end_to_end}
    else:
        obs = Observation(records, setup, prof, HBM_BYTES_PER_S)
        metrics = {name: rd.read(obs) for name, rd in readers.items()}
        device_info["busy_s"] = prof.busy_us() / 1e6
        device_info["window_s"] = prof.window_us / 1e6
        host = []
        for r in records:
            tc = r.tc_ns or r.t1_ns
            host.append((f"bench.compile {r.template}",
                         prof.host_us(r.t0_ns), prof.host_us(tc)))
            host.append((f"bench.execute {r.template}",
                         prof.host_us(tc), prof.host_us(r.t1_ns)))
        result["breakdown"] = {
            "device_ops": device_ops(prof.events),
            "idle_gaps": idle_gaps(prof.events, prof.window, host)}
    result["metrics"] = {n: {"value": v, "unit": units[n]}
                         for n, v in metrics.items() if v is not None}
    result["device"] = device_info
    result["checks"] = checks

    delta = {k: counters1[k] - counters0.get(k, 0) for k in
             ("requests", "launches", "coalescedLaunches",
              "dedupedRequests", "launchesSaved") if k in counters1}
    by_t: Dict[str, List[float]] = {}
    for r in records:
        by_t.setdefault(r.template, []).append(r.ms)
    log(f"cell {workload} seed {seed}: {len(records)} queries in "
        f"{seconds} s, set-up {setup_s:.3f} s (generate {generate_s:.3f}, "
        f"prep {prep_s:.3f}, build {build_s:.3f}, stage {stage_s:.3f}), "
        f"check {check_s:.3f} s over {len(want)} distinct SQL")
    log("per template (n, p50 ms, p95 ms): " + json.dumps(
        {t: [len(v), round(percentile(v, 50), 3), round(percentile(v, 95), 3)]
         for t, v in sorted(by_t.items())}))
    log(f"first pass by template (s): {json.dumps(warm_s)}")
    log(f"launcher in the window: {json.dumps(delta)}")
    log("the window's first L s as a run of L s would read them (L: qps, "
        "p50 ms, p95 ms): " + json.dumps(
            {L: window_metrics(records, t_start, L) for L in PREFIX_S
             if L < seconds}))
    if cuda:
        log(f"card: {_power_limit()}")
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the benchmark may not hold: {bad}")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), file=out, flush=True)
    return 0
