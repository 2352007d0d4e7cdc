"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--sf 10] [--segments 8] [--seed 42] [--reps 5]
                          [--out-dir DIR]

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the fused-scan CUDA kernel from pinot_tpu_torch/engine/csrc
     (ptxas registers, stack frame and spills logged);
  3. hold the kernel against its plain PyTorch version on the same card and
     inputs: every bit width, a remainder tile, iv/ivs/not/or filters, int
     and float expressions, an i64 column, every aggregation, 128 and 8192
     groups (shared-memory and global accumulators), the probe mode, a
     group key that is also a filter column, a filter at the deepest stack
     the kernel takes, tiles where every doc passes and tiles where none
     does, 56 bits of filter columns; then the same cases as one launch
     over a batch of 3 segments of different sizes plus one padded segment
     with no docs;
  4. the per-segment path: SSB at ``--sf`` in ``--segments`` segments, the
     13 flights ``--reps`` times through ServerQueryExecutor(device="cuda"),
     every launch counted, every answer held against the numpy oracle;
     then the graft-entry SQL on a 5-column segment;
  5. at the per-segment path's shapes (segment 0, every flight and probe):
     the kernel held against its plain version again, then timings of both
     beside the bound;
  6. the batch path: the same segments and flights through
     ShardedQueryExecutor(device="cuda"), one launch per flight over the
     whole batch, every launch counted, every answer held against the
     oracle; then at its shapes (all segments, every flight and probe) the
     kernel against its plain version and timings of both beside the
     bound (the kernel alone and through its wrapper);
  7. the general rung (engine/kernels.py, PyTorch ops on the card): (a) the
     13 flights through ServerQueryExecutor(device="cuda",
     use_fused_scan=False), 0 fused launches and one general-rung call per
     segment, every answer equal to phase 4's and the oracle, p50 beside
     phase 4's; (b) the declined queries G1-G5 (tools/ssb.py) with the
     fused scan on, each with its planned decline and rung (G1's matched
     segment on the hash rung, G2's on the sort rung), held against the
     oracle; a "rungs" line of the segments each rung served; and one JSON
     line listing the kernels ("ms" is the kernel alone).
The last line is {"ok": true, "device": {...}}; any failure raises and
exits non-zero without it. Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM HBM3 rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 3: kernel against plain version -----------------------------------

def _synthetic_segment(n: int, seed: int, i: int = 0):
    """Columns with one of each packed width (1, 2, 4, 8, 16, 32 bits),
    int/float/i64 values, and doc-correlated columns for the probe."""
    from pinot_tpu_torch.segment import ColumnArrays, segment_from_arrays
    from pinot_tpu_torch.spi import DataType, FieldType

    rng = np.random.default_rng(seed)
    D, M = FieldType.DIMENSION, FieldType.METRIC

    def col(dt, ft, values):
        uniq, ids = np.unique(values, return_inverse=True)
        return ColumnArrays(dt, ft, uniq, ids.reshape(-1))

    doc = np.arange(n)
    return segment_from_arrays(f"synthetic_{i}", n, {
        "b1": col(DataType.INT, D, rng.integers(0, 2, n)),
        "b2": col(DataType.INT, D, rng.integers(0, 3, n)),
        "b4": col(DataType.STRING, D,
                  np.array([f"k{i:02d}" for i in range(11)])[
                      rng.integers(0, 11, n)]),
        "b8": col(DataType.INT, D, rng.integers(0, 200, n)),
        "b16": col(DataType.INT, D, doc // 41),
        "b32": col(DataType.INT, D, doc // 3),
        "qty": col(DataType.INT, M, rng.integers(-500, 1000, n)),
        "price": col(DataType.DOUBLE, M,
                     np.round(rng.normal(80.0, 30.0, n), 2)),
        "big": col(DataType.LONG, M,
                   rng.integers(0, 1 << 40, n) - (1 << 39)),
    }, table_name="t")


def _deep_filter(depth: int) -> str:
    """A WHERE clause whose postfix filter program needs a stack of
    ``depth``: leaves nested right, AND and OR alternating (so nothing
    flattens)."""
    leaves = ["b1 = 1", "b2 != 2", "b8 < 150", "b4 != 'k03'", "b16 > 20",
              "b32 < 60000"]
    sql = leaves[(depth - 1) % len(leaves)]
    for d in range(depth - 2, -1, -1):
        sql = f"{leaves[d % len(leaves)]} {'AND' if d % 2 == 0 else 'OR'} " \
              f"({sql})"
    return sql


def _kernel_cases():
    from pinot_tpu_torch.engine.fused_scan import MAX_FILTER_STACK

    scattered = ", ".join(str(v) for v in range(100, 60000, 2500))
    return [
        ("scalar iv/not, every aggregation",
         "SELECT count(*), sum(qty), avg(price), min(price), max(qty), "
         "minmaxrange(qty) FROM t WHERE b1 = 1 AND b2 != 0"),
        ("or, int and float expressions, 128 groups",
         "SELECT b4, sum(qty * 3), sum(price * 2.5), sum(qty - 7), count(*) "
         "FROM t WHERE b8 BETWEEN 10 AND 150 OR b16 < 100 GROUP BY b4"),
        ("ivs (24 runs), i64 column",
         f"SELECT b8, sum(big), avg(big) FROM t WHERE b32 IN ({scattered}) "
         "GROUP BY b8"),
        ("8192 groups, 3 rows: accumulators in device memory (in shared "
         "memory they would leave one block per SM)",
         "SELECT b16, sum(qty), count(*), min(price) FROM t "
         "WHERE b32 > 1000 GROUP BY b16"),
        ("8192 groups, global accumulators",
         "SELECT b16, sum(qty), sum(price), sum(big), min(qty), max(price) "
         "FROM t WHERE NOT b2 IN (1) GROUP BY b16"),
        ("probe narrowing",
         "SELECT b16, b4, sum(qty), count(*) FROM t WHERE b32 < 2000 "
         "GROUP BY b16, b4"),
        ("group key that is also a filter column",
         "SELECT b8, sum(qty), max(price), count(*) FROM t "
         "WHERE b8 < 120 AND b2 = 1 GROUP BY b8"),
        (f"filter stack {MAX_FILTER_STACK} deep",
         f"SELECT b4, sum(qty), count(*) FROM t "
         f"WHERE {_deep_filter(MAX_FILTER_STACK)} GROUP BY b4"),
        ("tiles where every doc passes, tiles where none does",
         "SELECT b4, sum(qty), sum(price), min(qty), count(*) FROM t "
         "WHERE b32 < 4096 GROUP BY b4"),
        ("8192 groups, three filter columns of 56 bits in all",
         "SELECT b16, sum(qty), sum(price) FROM t "
         "WHERE b32 > 100 AND b16 < 7000 AND b8 < 190 GROUP BY b16"),
    ]


def _scan_args(staged, sql) -> dict:
    """{kernel name: (launch, inputs)} of ``sql`` over a staged segment or a
    staged batch, built by the executors' own ``scan_inputs``, which picks
    the wrappers (and so the counters) for the staged type: ``launch()``
    runs the wrapper, ``inputs`` are the plain version's (program, packed
    words, values, num_docs). The probe entry is there when the query
    probes first (the probe launches once here)."""
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.query import compile_query

    plan = plan_segment(compile_query(sql + " LIMIT 100000"), staged.provider)
    reasons = []
    inp = fs.scan_inputs(plan, staged, on_decline=reasons.append)
    if inp is None:
        raise AssertionError(f"{sql}: declined {reasons}")
    k = inp.kernels
    args = {k.scan_counter.name: (
        inp.scan, (inp.prog, inp.words, inp.values, inp.num_docs))}
    if inp.probe is not None:
        prog, words = inp.probe
        args[k.probe_counter.name] = (
            lambda: k.probe(prog, words, inp.num_docs),
            (prog, words, [], inp.num_docs))
    return args


def _acc_path(prog) -> str:
    """Where a program's accumulators live: a scalar scan's per-thread
    rows, a grouped scan's shared-memory or device-memory accumulators."""
    from pinot_tpu_torch.engine import fused_scan as fs

    return ("scalar" if prog.scalar else
            "shared" if fs.scan_layout(prog).acc_smem else "global")


def _check_paths(seen: set, depths: set, tiles: set, what: str) -> None:
    from pinot_tpu_torch.engine.fused_scan import MAX_FILTER_STACK

    want = {"scalar", "shared", "global"}
    if not want <= seen:
        raise AssertionError(f"{what}: cases missed kernel paths "
                             f"{sorted(want - seen)}")
    if MAX_FILTER_STACK not in depths:
        raise AssertionError(f"{what}: no filter {MAX_FILTER_STACK} deep")
    if not {"all", "none"} <= tiles:
        raise AssertionError(f"{what}: no full tile where every doc passes "
                             f"and one where none does: {sorted(tiles)}")


def _tile_kinds(prog, words, num_docs) -> set:
    """'all' if a full tile has every doc passing, 'none' if a full tile
    has none passing."""
    from pinot_tpu_torch.engine import fused_scan as fs

    valid, matched = fs.doc_masks(prog, words, num_docs)
    full = valid.view(-1, fs.TILE).all(dim=1)
    per_tile = matched.view(-1, fs.TILE).sum(dim=1)
    kinds = set()
    if bool((full & (per_tile == fs.TILE)).any()):
        kinds.add("all")
    if bool((full & (per_tile == 0)).any()):
        kinds.add("none")
    return kinds


def _kernel_vs_plain(args: dict, what: str, errs: dict) -> dict:
    """Run each program once through its kernel's wrapper and once through
    the plain version; fold the largest float difference into ``errs``.
    -> {kernel name: the kernel's outputs}."""
    from pinot_tpu_torch.engine import fused_scan as fs

    outs = {}
    for kind, (launch, a) in args.items():
        outs[kind] = launch()
        plain = fs.fused_scan_plain(*a)
        errs[kind] = max(errs[kind], _compare(outs[kind], plain,
                                              f"{what} ({kind})"))
    return outs


def _compare(kern, plain, what: str) -> float:
    """Exact for counts, int sums and min/max; floats within rel 1e-9 (both
    sides sum in f64, only the order of the atomics differs)."""
    import torch

    for name in ("cnt", "isum", "matched", "mm"):
        a, b = getattr(kern, name), getattr(plain, name)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs\n{a}\n{b}")
    err = 0.0
    if plain.fsum.numel():
        diff = (kern.fsum - plain.fsum).abs()
        tol = 1e-9 * plain.fsum.abs() + 1e-9
        if bool((diff > tol).any()):
            raise AssertionError(f"{what}: fsum beyond rel 1e-9, max diff "
                                 f"{float(diff.max())}")
        err = float(diff.max())
    return err


# docs of the phase-3 batch's segments: different sizes, each ending in a
# remainder tile
BATCH_DOCS = (200_123, 150_001, 90_917)


def phase_kernels(n: int = 200_123, seed: int = 7) -> dict:
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.staging import StagedSegment

    seg = _synthetic_segment(n, seed)
    staged = StagedSegment(seg, device="cuda")
    bits_seen = set()
    errs = {"fused_scan": 0.0, "fused_scan_probe": 0.0}
    probed = False
    paths, depths, tiles = set(), set(), set()
    for what, sql in _kernel_cases():
        args = _scan_args(staged, sql)
        prog, words, _values, num_docs = args["fused_scan"][1]
        bits_seen.update(prog.bits)
        probed |= "fused_scan_probe" in args
        paths.add(_acc_path(prog))
        depths.add(prog.filter_depth)
        tiles |= _tile_kinds(prog, words, num_docs)
        _kernel_vs_plain(args, what, errs)
        log(f"  kernel == plain: {what} (G={prog.G}, bits={prog.bits}, "
            f"{_acc_path(prog)} accumulators, filter depth "
            f"{prog.filter_depth})")
    _check_paths(paths, depths, tiles, "segment")
    missing = {1, 2, 4, 8, 16, 32} - bits_seen
    if missing:
        raise AssertionError(f"bit widths not covered: {sorted(missing)}")
    if not probed:
        raise AssertionError("no case ran the probe mode")
    if seg.num_docs % fs.TILE == 0:
        raise AssertionError("the synthetic segment must end in a "
                             "remainder tile")
    errs.update(phase_batch_kernels(seed))
    return errs


def phase_batch_kernels(seed: int) -> dict:
    """The phase-3 cases as one launch over a batch: 3 segments with their
    own dictionaries (unified by the batch) and one padded segment with no
    docs, whose matched count must stay 0."""
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.parallel.batch import SegmentBatch, StagedBatch

    segs = [_synthetic_segment(n, seed + i, i)
            for i, n in enumerate(BATCH_DOCS)]
    if any(n % fs.TILE == 0 for n in BATCH_DOCS):
        raise AssertionError("every batch segment must end in a remainder "
                             "tile")
    staged = StagedBatch(SegmentBatch(segs), device="cuda",
                         num_segs=len(segs) + 1)
    errs = {"sharded_fused_scan": 0.0, "sharded_fused_scan_probe": 0.0}
    paths, depths, tiles = set(), set(), set()
    probed = False
    for what, sql in _kernel_cases():
        args = _scan_args(staged, sql)
        prog, words, _values, num_docs = args["sharded_fused_scan"][1]
        probed |= "sharded_fused_scan_probe" in args
        paths.add(_acc_path(prog))
        depths.add(prog.filter_depth)
        tiles |= _tile_kinds(prog, words, num_docs)
        outs = _kernel_vs_plain(args, f"batch: {what}", errs)
        matched = outs["sharded_fused_scan"].to_host().matched
        if int(matched[-1]) != 0:
            raise AssertionError(f"batch: {what}: the padded segment "
                                 f"matched {int(matched[-1])} docs")
        log(f"  batch kernel == plain: {what} (S={len(segs)}+1 padded, "
            f"G={prog.G}, {_acc_path(prog)} accumulators, per-segment "
            f"matched {matched.tolist()})")
    if not probed:
        raise AssertionError("no batch case ran the probe mode")
    _check_paths(paths, depths, tiles, "batch")
    return errs


# -- phase 4: main path --------------------------------------------------------

def _check_flight(qid: str, table, want) -> None:
    if isinstance(want, int):
        got = table.rows[0][0]
        if got != float(want):
            raise AssertionError(f"{qid}: {got!r} != {want}")
        return
    got = {tuple(r[:-1]): r[-1] for r in table.rows}
    if set(got) != set(want):
        raise AssertionError(f"{qid}: group sets differ: "
                             f"{len(got)} vs {len(want)} groups")
    bad = [k for k, v in want.items() if got[k] != float(v)]
    if bad:
        raise AssertionError(f"{qid}: {len(bad)} sums differ, e.g. {bad[0]}: "
                             f"{got[bad[0]]!r} != {want[bad[0]]}")


def _graft_entry_check() -> None:
    """The graft-entry SQL on a port-built 5-column segment, against a
    numpy answer over the same frame."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.spi import DataType, FieldSpec, FieldType, Schema

    rng = np.random.default_rng(7)
    n = 2048
    frame = {
        "region": np.array(["east", "west", "north", "south"])[
            rng.integers(0, 4, n)],
        "kind": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "year": rng.integers(2015, 2024, n),
        "qty": rng.integers(1, 50, n),
        "price": np.round(rng.normal(100.0, 25.0, n), 2),
    }
    schema = Schema("sales", [
        FieldSpec("region", DataType.STRING), FieldSpec("kind", DataType.STRING),
        FieldSpec("year", DataType.INT),
        FieldSpec("qty", DataType.LONG, FieldType.METRIC),
        FieldSpec("price", DataType.DOUBLE, FieldType.METRIC)])
    seg = SegmentBuilder(schema, "sales_0").build(frame)
    sql = ("SELECT region, sum(qty), count(*), avg(price) FROM sales "
           "WHERE year BETWEEN 2017 AND 2022 AND kind != 'c' "
           "GROUP BY region ORDER BY region")
    table, _ = ServerQueryExecutor(device="cuda").execute(
        compile_query(sql), [seg])
    m = (frame["year"] >= 2017) & (frame["year"] <= 2022) & (frame["kind"] != "c")
    # float columns are staged as f32 (as the JAX package stages them)
    price = frame["price"].astype(np.float32).astype(np.float64)
    want = []
    for r in sorted(set(frame["region"][m].tolist())):
        g = m & (frame["region"] == r)
        want.append([r, float(frame["qty"][g].sum()), int(g.sum()),
                     float(price[g].sum() / g.sum())])
    if len(table.rows) != len(want):
        raise AssertionError(f"graft SQL: {table.rows} vs {want}")
    for got, exp in zip(table.rows, want):
        if got[:3] != exp[:3] or abs(got[3] - exp[3]) > 1e-9 * abs(exp[3]):
            raise AssertionError(f"graft SQL row {got} != {exp}")
    log(f"  graft-entry SQL: {len(table.rows)} rows match numpy")


def _run_flights(ex, ctxs: dict, segs, reps: int) -> tuple:
    """The flights ``reps`` times through ``ex``: -> ({flight: [ms]},
    {flight: last table}); every run must record no decision."""
    import torch

    lat = {qid: [] for qid in ctxs}
    results = {}
    for _ in range(reps):
        for qid, ctx in ctxs.items():
            t0 = time.perf_counter()
            table, stats = ex.execute(ctx, segs)
            torch.cuda.synchronize()
            lat[qid].append((time.perf_counter() - t0) * 1e3)
            results[qid] = table
            if stats.decisions:
                raise AssertionError(f"{qid}: decisions {stats.decisions}")
    return lat, results


def _latencies(lat: dict, rows: int, beside: dict = None,
               beside_label: str = "per segment") -> dict:
    per_flight = {}
    for qid, ms in lat.items():
        p50 = float(np.percentile(ms, 50))
        p99 = float(np.percentile(ms, 99))
        per_flight[qid] = {"p50_ms": p50, "p99_ms": p99,
                           "rows_per_s": rows / (p50 / 1e3)}
        other = ""
        if beside is not None:
            other = (f"  ({beside_label}: p50 {beside[qid]['p50_ms']:.3f} "
                     f"ms, p99 {beside[qid]['p99_ms']:.3f} ms)")
        log(f"  {qid}: p50 {p50:.3f} ms  p99 {p99:.3f} ms  "
            f"{rows / (p50 / 1e3):.4g} rows/s{other}")
    return per_flight


def _reset(counters: dict) -> None:
    for c in counters.values():
        c.reset()


def phase_main(sf: float, segments: int, seed: int, reps: int) -> dict:
    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    t0 = time.perf_counter()
    segs, frames = ssb.build_segments(sf, num_segments=segments, seed=seed)
    rows = sum(s.num_docs for s in segs)
    log(f"  generate SSB SF{sf}: {rows} rows in {len(segs)} segments, "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    wants = {qid: ssb.merge_answers([ssb.numpy_answer(f, qid) for f in frames])
             for qid in ssb.QUERIES}
    wants.update({gid: ssb.declined_answer(frames, gid)
                  for gid in ssb.DECLINED_QUERIES})
    log(f"  numpy oracle, 13 flights and {len(ssb.DECLINED_QUERIES)} "
        f"declined queries: {time.perf_counter() - t0:.1f} s")
    del frames

    ctxs = {qid: compile_query(q + " LIMIT 100000")
            for qid, q in ssb.QUERIES.items()}
    ex = ServerQueryExecutor(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for ctx in ctxs.values():   # untimed pass: stages what the flights read
        ex.execute(ctx, segs)
    torch.cuda.synchronize()
    resident = sum(ex.stage(s).nbytes() for s in segs)
    log(f"  stage on cuda + one untimed pass: {resident} bytes resident "
        f"({resident / rows:.2f} B/row), {time.perf_counter() - t0:.1f} s")

    counters = scan_counters()
    _reset(counters)
    lat, results = _run_flights(ex, ctxs, segs, reps)
    launches = {name: c.launches for name, c in counters.items()}
    expect = {"fused_scan": len(segs) * len(ctxs) * reps,
              "fused_scan_probe": len(segs) * 2 * reps,   # Q3.2 and Q4.3
              "sharded_fused_scan": 0, "sharded_fused_scan_probe": 0}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"  launches on the per-segment path: {launches}; 0 declines")
    for qid, table in results.items():
        _check_flight(qid, table, wants[qid])
    log("  13 flights == numpy oracle (group sets and int sums exact)")
    per_flight = _latencies(lat, rows)
    log(f"  torch.cuda.max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated()} bytes")
    _graft_entry_check()
    return {"segs": segs, "ex": ex, "launches": launches, "ctxs": ctxs,
            "wants": wants, "per_flight": per_flight, "rows": rows,
            "results": results}


# -- phase 5: kernel timings at the per-segment path's shapes -----------------

def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


SECTOR = 32   # bytes the card's memory moves per access


def _sectors(need, per_sector: int) -> int:
    """32-byte sectors holding at least one needed element: ``need`` is a
    bool [..., n] mask, ``per_sector`` elements per sector."""
    return int(need.reshape(-1, per_sector).any(dim=1).sum())


def _needed_bytes(prog, words, values, num_docs) -> int:
    """Bytes this scan must move, from this run's data: the filter's
    packed columns on every sector holding a doc (every doc's filter is
    evaluated), group-key and value columns only on sectors holding a doc
    that passed the filter, ``num_docs`` read once, every output (per-group
    rows, per-segment matched counts) written once."""
    from pinot_tpu_torch.engine import fused_scan as fs

    valid, matched = fs.doc_masks(prog, words, num_docs)
    total = 0
    for c, w in enumerate(words):
        S, T, W = w.shape
        need = valid if c in prog.early else matched
        # doc j of a tile sits in word j % W of the tile (planar layout)
        per_word = need.view(S * T, fs.TILE // W, W).any(dim=1)
        total += SECTOR * _sectors(per_word, SECTOR // 4)
    for v in values:
        total += SECTOR * _sectors(matched, SECTOR // v.element_size())
    outs = (prog.G * (8 * (1 + prog.n_isum + prog.n_fsum) + 4 * prog.n_mm)
            + 8 * num_docs.numel())
    return total + 8 * num_docs.numel() + outs


def _kernel_ms(args, iters: int) -> float:
    """The kernel alone: one prepared launch enqueued ``iters`` times back
    to back, so the wrapper's host work is not in the time (the outputs add
    up; only the time is read)."""
    import torch

    from pinot_tpu_torch.engine import fused_scan as fs

    argv, _out = fs.prepare_launch(*args)
    stream = torch.cuda.current_stream()
    return _time_ms(lambda: fs.enqueue(argv, stream), iters)


def _time_kernels(staged, errs: dict, docs: int, iters: int) -> list:
    """Each flight's scan (and probe) over ``staged``: held against the
    plain version at these shapes (folded into ``errs``), then timed beside
    the bound from the bytes this run's data needs: the kernel alone, and
    the wrapper (the kernel with its host work, as the path launches it)."""
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.tools import ssb

    rows = []
    for qid, q in ssb.QUERIES.items():
        scan_args = _scan_args(staged, q)
        _kernel_vs_plain(scan_args, qid, errs)
        for kind, (launch, args) in scan_args.items():
            prog, words = args[0], args[1]
            nbytes = _needed_bytes(*args)
            full = _full_bytes(*args)
            lay = fs.scan_layout(prog)
            grid = min(words[0].shape[0] * words[0].shape[1],
                       fs.launch_grid(lay.smem))
            k_ms = _kernel_ms(args, iters)
            w_ms = _time_ms(launch, iters)
            p_ms = _time_ms(lambda: fs.fused_scan_plain(*args), 3)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append({"flight": qid, "kernel": kind, "docs": docs,
                         "groups": prog.G, "bytes": nbytes,
                         "all_column_bytes": full, "ms": k_ms,
                         "wrapper_ms": w_ms, "plain_ms": p_ms,
                         "bound_ms": bound, "acc_smem": lay.acc_smem,
                         "smem": lay.smem, "grid": grid})
            log(f"  {qid} {kind}: {k_ms:.4f} ms/launch ({k_ms / bound:.1f}x "
                f"bound {bound:.4f} ms, {nbytes} B needed of {full} B in its "
                f"columns; {lay.smem} B smem, grid {grid}); wrapper "
                f"{w_ms:.4f} ms, plain {p_ms:.3f} ms")
    return rows


def _full_bytes(prog, words, values, num_docs) -> int:
    """Bytes of every column the scan reads, in full: the most any data
    could need (logged beside the bound, not used for it)."""
    return (sum(w.numel() * 4 for w in words)
            + sum(v.numel() * v.element_size() for v in values))


def phase_timing(main: dict, errs: dict, iters: int = 20) -> list:
    seg = main["segs"][0]
    return _time_kernels(main["ex"].stage(seg), errs, seg.num_docs, iters)


# -- phase 6: the batch path ----------------------------------------------------

def phase_batch(main: dict, reps: int, errs: dict, iters: int = 20) -> dict:
    """The main path's segments and flights through ShardedQueryExecutor:
    one launch per flight over the whole batch, the probe once per probed
    flight (at binding), no per-segment launch; then the batch kernel
    against its plain version and timed at these shapes."""
    import torch

    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters

    segs, ctxs, rows = main["segs"], main["ctxs"], main["rows"]
    counters = scan_counters()
    _reset(counters)
    ex = ShardedQueryExecutor(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for ctx in ctxs.values():   # untimed pass: stages and binds each flight
        ex.execute(ctx, segs)
    torch.cuda.synchronize()
    _batch, staged = ex.batch_for(segs)
    resident = staged.nbytes()
    log(f"  batch of {len(segs)} segments staged + bound in one untimed "
        f"pass: {resident} bytes resident ({resident / rows:.2f} B/row), "
        f"{time.perf_counter() - t0:.1f} s")
    lat, results = _run_flights(ex, ctxs, segs, reps)
    launches = {name: c.launches for name, c in counters.items()}
    expect = {"fused_scan": 0, "fused_scan_probe": 0,
              "sharded_fused_scan": len(ctxs) * (reps + 1),
              "sharded_fused_scan_probe": 2}          # Q3.2, Q4.3 at binding
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"  launches on the batch path: {launches}; 0 declines")
    for qid, table in results.items():
        _check_flight(qid, table, main["wants"][qid])
    log("  13 flights == numpy oracle (group sets and int sums exact)")
    per_flight = _latencies(lat, rows, beside=main["per_flight"])
    peak = torch.cuda.max_memory_allocated()
    log(f"  torch.cuda.max_memory_allocated: {peak} bytes")
    log(f"  batch kernel against plain version and timings at the batch "
        f"path's shapes ({rows} docs)")
    timing = _time_kernels(staged, errs, rows, iters)
    return {"launches": launches, "per_flight": per_flight,
            "resident_bytes": resident, "max_memory_allocated": peak,
            "timing": timing}


# -- phase 7: the general rung ---------------------------------------------------

# the rung each declined query's segments with matched docs take at SF10 in
# 8 segments (G4 is scalar); the others are served by the fused scan once
# the probe narrows their empty key space
DECLINED_RUNG = {"G1": "hash", "G2": "sort", "G3": "dense", "G4": None,
                 "G5": "dense"}


def _check_on_card(ex) -> None:
    """Every array the general rung read lies on the card: the staged
    columns and every cached plan's params."""
    for _seg, staged in ex._staged.values():
        for name, col in staged._columns.items():
            for t in col.tree().values():
                if t.device.type != "cuda":
                    raise AssertionError(f"column {name} on {t.device}")
    for _seg, plan in ex._plans.values():
        if any(d.type != "cuda" for d in plan.device_params):
            raise AssertionError(f"plan params on {list(plan.device_params)}")


def phase_general(main: dict, reps: int) -> dict:
    import torch

    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    segs, ctxs, rows = main["segs"], main["ctxs"], main["rows"]
    counters = {**scan_counters(), "general_rung": kernels.RUNG_COUNTER}

    # (a) the flights with the fused scan off
    ex = ServerQueryExecutor(device="cuda", use_fused_scan=False)
    t0 = time.perf_counter()
    for ctx in ctxs.values():   # untimed pass: stages the rung's columns
        ex.execute(ctx, segs)
    torch.cuda.synchronize()
    log(f"  staged for the general rung + one untimed pass: "
        f"{sum(ex.stage(s).nbytes() for s in segs)} bytes resident, "
        f"{time.perf_counter() - t0:.1f} s")
    _reset(counters)
    lat = {qid: [] for qid in ctxs}
    rungs = {}
    off = {"pallas:pallas_kernel->jnp_kernel:pallas_disabled_on_backend":
           len(segs)}
    for _ in range(reps):
        for qid, ctx in ctxs.items():
            t0 = time.perf_counter()
            table, stats = ex.execute(ctx, segs)
            torch.cuda.synchronize()
            lat[qid].append((time.perf_counter() - t0) * 1e3)
            if (sorted(map(tuple, table.rows))
                    != sorted(map(tuple, main["results"][qid].rows))):
                raise AssertionError(f"{qid}: general rung rows differ from "
                                     "the fused scan's")
            _check_flight(qid, table, main["wants"][qid])
            if stats.decisions != off or stats.general_launches != len(segs):
                raise AssertionError(f"{qid}: decisions {stats.decisions}, "
                                     f"{stats.general_launches} rung calls")
            rungs[qid] = stats.rung_segments
    launches = {name: c.launches for name, c in counters.items()}
    expect = {name: 0 for name in counters}
    expect["general_rung"] = len(segs) * len(ctxs) * reps
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"  (a) launches with the fused scan off: {launches}; 13 flights == "
        "phase 4 == numpy oracle")
    for qid in ("Q3.2", "Q4.3"):
        if "hash" not in rungs[qid]:
            raise AssertionError(f"{qid}: no segment on the hash rung: "
                                 f"{rungs[qid]}")
    per_flight = _latencies(lat, rows, beside=main["per_flight"],
                            beside_label="fused scan, phase 4")
    _check_on_card(ex)

    # (b) the declined queries with the fused scan on
    ex_on = ServerQueryExecutor(device="cuda")
    declined = {}
    for gid, sql in ssb.DECLINED_QUERIES.items():
        ctx = compile_query(sql)
        ex_on.execute(ctx, segs)   # untimed: stages and plans
        ms = []
        for _ in range(reps):
            _reset(counters)
            t0 = time.perf_counter()
            table, stats = ex_on.execute(ctx, segs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        got = ssb.declined_rows(gid, table.rows)
        if got != main["wants"][gid]:
            raise AssertionError(f"{gid}: rows differ from the oracle "
                                 f"({len(got)} vs {len(main['wants'][gid])} "
                                 "groups)")
        reason = ssb.DECLINED_REASONS[gid]
        want_key = f"pallas:pallas_kernel->jnp_kernel:{reason}"
        if set(stats.decisions) != {want_key}:
            raise AssertionError(f"{gid}: decisions {stats.decisions}")
        n_general = stats.decisions[want_key]
        if (stats.general_launches != n_general
                or counters["general_rung"].launches != n_general):
            raise AssertionError(f"{gid}: {n_general} declines but "
                                 f"{stats.general_launches} rung calls")
        rung = DECLINED_RUNG[gid]
        if rung is not None and stats.rung_segments.get(rung, 0) < 1:
            raise AssertionError(f"{gid}: no segment on the {rung} rung: "
                                 f"{stats.rung_segments}")
        declined[gid] = {
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "reason": reason, "rung_segments": stats.rung_segments,
            "general_calls": n_general,
            "launches": {k: c.launches for k, c in counters.items()}}
        log(f"  (b) {gid}: p50 {declined[gid]['p50_ms']:.3f} ms  p99 "
            f"{declined[gid]['p99_ms']:.3f} ms; declined {reason} on "
            f"{n_general} segments, rungs {stats.rung_segments}, launches "
            f"{declined[gid]['launches']}; == numpy oracle")
    _check_on_card(ex_on)
    log("rungs " + json.dumps({"flights_fused_off": rungs, "declined": {
        g: d["rung_segments"] for g, d in declined.items()}}))
    return {"per_flight": per_flight, "rungs": rungs, "declined": declined,
            "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out-dir", default=None,
                    help="also write the full report as chip_smoke.json here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from pinot_tpu_torch.engine import _build

    t_all = time.perf_counter()
    log("phase 1: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    log("phase 2: build")
    t0 = time.perf_counter()
    _build.load_library("fused_scan")
    log(f"  fused_scan built and loaded in {time.perf_counter() - t0:.1f} s")
    ptxas = [line.strip() for line in
             _build.BUILD_LOGS.get("fused_scan", ("", ""))[1].splitlines()
             if "registers" in line or "stack frame" in line
             or "spill" in line]
    for line in ptxas:
        log(f"  ptxas: {line}")

    log("phase 3: kernel against plain version")
    t0 = time.perf_counter()
    errs = phase_kernels()
    log(f"  all cases agree ({time.perf_counter() - t0:.1f} s)")

    log("phase 4: per-segment path")
    t0 = time.perf_counter()
    main_run = phase_main(args.sf, args.segments, args.seed, args.reps)
    log(f"  per-segment path phase: {time.perf_counter() - t0:.1f} s")

    log("phase 5: kernel against plain version and timings at the "
        "per-segment path's shapes (segment 0)")
    timing = phase_timing(main_run, errs)

    log("phase 6: batch path")
    t0 = time.perf_counter()
    batch_run = phase_batch(main_run, args.reps, errs)
    log(f"  batch path phase: {time.perf_counter() - t0:.1f} s")
    timing += batch_run["timing"]

    log("phase 7: general rung")
    t0 = time.perf_counter()
    general_run = phase_general(main_run, args.reps)
    log(f"  general rung phase: {time.perf_counter() - t0:.1f} s")
    launches = {**main_run["launches"], **{
        k: v for k, v in batch_run["launches"].items() if k.startswith(
            "sharded")}}
    kernels = []
    for name, replaces in (
            ("fused_scan", "pinot_tpu/engine/pallas_kernels.py:603"),
            ("fused_scan_probe", "pinot_tpu/engine/pallas_kernels.py:456"),
            ("sharded_fused_scan", "pinot_tpu/parallel/combine.py:298"),
            ("sharded_fused_scan_probe",
             "pinot_tpu/parallel/combine.py:360")):
        rs = [r for r in timing if r["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pinot_tpu_torch/engine/csrc/fused_scan.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": float(np.mean([r["ms"] for r in rs])),
            "plain_ms": float(np.mean([r["plain_ms"] for r in rs])),
            "bound_ms": float(np.mean([r["bound_ms"] for r in rs])),
            "bound_by": "bytes", "library_ms": None})
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump({"card": smi, "args": vars(args), "ptxas": ptxas,
                       "per_flight": main_run["per_flight"],
                       "batch_per_flight": batch_run["per_flight"],
                       "batch_resident_bytes": batch_run["resident_bytes"],
                       "batch_max_memory_allocated":
                           batch_run["max_memory_allocated"],
                       "kernel_timing": timing, "kernels": kernels,
                       "general": general_run,
                       "seconds": time.perf_counter() - t_all}, f, indent=1)
    log(f"  total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    # the run used one card, whatever the host holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
