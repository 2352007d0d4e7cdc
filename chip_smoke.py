"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--sf 10] [--segments 8] [--seed 42] [--reps 5]
                          [--user-segments 8] [--user-rows 2500000]
                          [--out-dir DIR]

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the fused-scan CUDA kernel from pinot_tpu_torch/engine/csrc
     (ptxas registers, stack frame and spills logged);
  3. hold the kernel against its plain PyTorch version on the same card and
     inputs: every bit width, a remainder tile, iv/ivs/not/or filters, int
     and float expressions, an i64 column, raw (no-dictionary) INT, LONG
     past 2^31 and FLOAT value columns, a scan that reads no packed column,
     every aggregation, 128 and 8192
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
     oracle;
  8. the user-events table (tools/usertable.py: raw ``latency_ms``, MV
     ``tags``), ``--user-segments`` segments of ``--user-rows`` rows: U1-U7
     ``--reps`` times through ServerQueryExecutor(device="cuda"), each held
     against the numpy oracle over the generator's arrays with its decline
     code and rung per segment (U1 and U2 on the fused scan, U2's raw
     column as a value column; U3-U7 on the general rung); U1 and U2 again
     through ShardedQueryExecutor, one launch over the batch, where U3-U7
     raise NotPortedError; (8b) on a 1 M-doc segment, IS NULL / IS NOT
     NULL on a nullable dictionary and raw column, the MV aggregations and
     an upsert valid-doc mask against numpy;
then a "rungs" line of the segments each rung served and the declines of
phase 8, and one JSON line listing the kernels ("ms" is the kernel alone,
"launches" those of phases 4, 6 and 8).
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
    int/float/i64 values, doc-correlated columns for the probe, and raw
    (no-dictionary) INT, LONG past 2^31 and FLOAT value columns."""
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
        "rint": ColumnArrays(DataType.INT, M,
                             values=rng.integers(-5000, 9000, n)),
        "rlong": ColumnArrays(DataType.LONG, M,
                              values=rng.integers(0, 1 << 36, n) + (1 << 33)),
        "rfloat": ColumnArrays(DataType.FLOAT, M, values=np.round(
            rng.gamma(2.0, 40.0, n), 3).astype(np.float32)),
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
        ("raw INT, raw LONG past 2^31 and raw FLOAT value columns",
         "SELECT b4, sum(rint), min(rint), max(rfloat), sum(rlong), "
         "avg(rfloat), count(*) FROM t WHERE b8 < 100 OR b2 = 1 "
         "GROUP BY b4"),
        ("raw value columns and no packed column",
         "SELECT sum(rint), sum(rlong), sum(rfloat), min(rfloat), "
         "max(rint), count(*) FROM t"),
    ]


def _scan_args(staged, sql) -> dict:
    """{kernel name: (launch, inputs)} of ``sql`` over a staged segment or a
    staged batch, built by the executors' own ``scan_inputs``, which picks
    the wrappers (and so the counters) for the staged type: ``launch()``
    runs the wrapper, ``inputs`` are the plain version's (program, packed
    words, values, num_docs, tiles). The probe entry is there when the
    query probes first (the probe launches once here)."""
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
        inp.scan, (inp.prog, inp.words, inp.values, inp.num_docs,
                   inp.tiles))}
    if inp.probe is not None:
        prog, words = inp.probe
        args[k.probe_counter.name] = (
            lambda: k.probe(prog, words, inp.num_docs),
            (prog, words, [], inp.num_docs, inp.tiles))
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


def _tile_kinds(prog, words, values, num_docs, tiles) -> set:
    """'all' if a full tile has every doc passing, 'none' if a full tile
    has none passing."""
    from pinot_tpu_torch.engine import fused_scan as fs

    valid, matched = fs.doc_masks(prog, words, num_docs, values, tiles)
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
    raw_values = set()
    for what, sql in _kernel_cases():
        args = _scan_args(staged, sql)
        prog = args["fused_scan"][1][0]
        bits_seen.update(prog.bits)
        probed |= "fused_scan_probe" in args
        paths.add(_acc_path(prog))
        depths.add(prog.filter_depth)
        tiles |= _tile_kinds(*args["fused_scan"][1])
        raw_values |= _raw_values(staged, sql)
        _kernel_vs_plain(args, what, errs)
        log(f"  kernel == plain: {what} (G={prog.G}, bits={prog.bits}, "
            f"{_acc_path(prog)} accumulators, filter depth "
            f"{prog.filter_depth})")
    _check_paths(paths, depths, tiles, "segment")
    if raw_values != {"rint", "rlong", "rfloat"}:
        raise AssertionError(f"raw value columns covered: {raw_values}")
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
    raw_values = set()
    for what, sql in _kernel_cases():
        args = _scan_args(staged, sql)
        prog = args["sharded_fused_scan"][1][0]
        probed |= "sharded_fused_scan_probe" in args
        paths.add(_acc_path(prog))
        depths.add(prog.filter_depth)
        tiles |= _tile_kinds(*args["sharded_fused_scan"][1])
        raw_values |= _raw_values(staged, sql)
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
    if raw_values != {"rint", "rlong", "rfloat"}:
        raise AssertionError(f"batch raw value columns covered: "
                             f"{raw_values}")
    return errs


def _raw_values(staged, sql) -> set:
    """The raw (no-dictionary) columns the scan of ``sql`` reads as value
    columns, each checked to be staged in its own type (i64 past 2^31)."""
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.engine.plan import plan_segment
    from pinot_tpu_torch.query import compile_query

    pp = fs.extract_plan(plan_segment(compile_query(sql + " LIMIT 100000"),
                                      staged.provider), staged.provider,
                         unchecked_groups=True)
    raw = {n for n in pp.value_names
           if not staged.provider.metadata.column(n).has_dictionary}
    if "rlong" in raw and staged.value_column("rlong").dtype.itemsize != 8:
        raise AssertionError("raw LONG past 2^31 not staged as i64")
    return raw


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


def _needed_bytes(prog, words, values, num_docs, tiles) -> int:
    """Bytes this scan must move, from this run's data: the filter's
    packed columns on every sector holding a doc (every doc's filter is
    evaluated), group-key and value columns only on sectors holding a doc
    that passed the filter, ``num_docs`` read once, every output (per-group
    rows, per-segment matched counts) written once."""
    from pinot_tpu_torch.engine import fused_scan as fs

    valid, matched = fs.doc_masks(prog, words, num_docs, values, tiles)
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


def _time_kernels(staged, errs: dict, docs: int, iters: int,
                  queries: dict = None) -> list:
    """Each query's scan (and probe) over ``staged`` (``queries``: the SSB
    flights unless given): held against the
    plain version at these shapes (folded into ``errs``), then timed beside
    the bound from the bytes this run's data needs: the kernel alone, and
    the wrapper (the kernel with its host work, as the path launches it)."""
    from pinot_tpu_torch.engine import fused_scan as fs
    from pinot_tpu_torch.tools import ssb

    rows = []
    for qid, q in (queries or ssb.QUERIES).items():
        scan_args = _scan_args(staged, q)
        _kernel_vs_plain(scan_args, qid, errs)
        for kind, (launch, args) in scan_args.items():
            prog, num_docs, tiles = args[0], args[3], args[4]
            nbytes = _needed_bytes(*args)
            full = _full_bytes(*args)
            lay = fs.scan_layout(prog)
            grid = min(num_docs.numel() * tiles, fs.launch_grid(lay.smem))
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


def _full_bytes(prog, words, values, num_docs, tiles) -> int:
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
    return {"per_flight": per_flight, "rungs": rungs, "declined": declined,
            "launches": launches}


# -- phase 8: the user-events table ------------------------------------------

# per query: the fused scan's decline code (None: the fused scan serves
# every segment) and the group-by rung of each segment (None: scalar)
USER_PATH = {"U1": (None, "dense"), "U2": (None, "dense"),
             "U3": ("pallas_vrange", None), "U4": ("pallas_mv_eq", "dense"),
             "U5": ("pallas_mv_lut", None),
             "U6": ("pallas_raw_group_key", "dense"),
             "U7": ("pallas_vin", None)}
# the queries the fused scan serves: one launch over the batch; the others
# raise NotPortedError there (the JAX package's jnp combine is not ported)
USER_BATCH = ("U1", "U2")
# the query whose value column is the raw latency_ms
USER_RAW_FUSED = "U2"


def _decline_key(code: str) -> str:
    return f"pallas:pallas_kernel->jnp_kernel:{code}"


def _check_user_path(qid: str, stats, n_segs: int, path: dict) -> None:
    """The query's declines, general-rung calls and rungs per segment."""
    code, rung = path[qid]
    want = {_decline_key(code): n_segs} if code else {}
    if stats.decisions != want:
        raise AssertionError(f"{qid}: decisions {stats.decisions} != {want}")
    if stats.general_launches != (n_segs if code else 0):
        raise AssertionError(f"{qid}: {stats.general_launches} general-rung "
                             f"calls over {n_segs} segments")
    want_rungs = {rung: n_segs} if rung else {}
    if stats.rung_segments != want_rungs:
        raise AssertionError(f"{qid}: rungs {stats.rung_segments} != "
                             f"{want_rungs}")


def _timed(ex, ctx, segs, reps: int, check) -> list:
    """``reps`` timed runs of ``ctx``, each result passed to ``check``."""
    import torch

    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        table, stats = ex.execute(ctx, segs)
        if ex.device.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(table, stats)
    return ms


def _counted(counters: dict, device) -> dict:
    """The counters' launches: the wrappers count only the launches of
    their kernels on the card (on the CPU they run the plain version)."""
    return ({name: c.launches for name, c in counters.items()}
            if device.type == "cuda" else None)


def phase_users(seed: int, reps: int, segments: int = 8,
                rows_per_segment: int = 2_500_000, device: str = "cuda",
                errs: dict = None) -> dict:
    """U1-U7 (``tools/usertable.py``) on the user-events table, each
    ``reps`` times through ServerQueryExecutor, held against the numpy
    oracle over the generator's arrays, with its decline code and rung per
    segment; U1 and U2 (the fused ones) also through ShardedQueryExecutor
    in one launch over the batch, where U3-U7 raise NotPortedError. On the
    card, U1's and U2's scans are then held against the plain version and
    timed at these shapes (segment 0, and the batch), folded into
    ``errs``."""
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.errors import NotPortedError
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.parallel import ShardedQueryExecutor
    from pinot_tpu_torch.parallel.executor import scan_counters
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import usertable

    rows = segments * rows_per_segment
    t0 = time.perf_counter()
    segs, frames = usertable.build_segments(segments, rows, seed)
    users = usertable.tail_users(rows, segments, seed)
    user = users[len(users) // 2]
    sqls = usertable.queries(user)
    wants = {qid: usertable.numpy_answer(frames, qid, user) for qid in sqls}
    del frames
    lat_cm = segs[0].metadata.column("latency_ms")
    log(f"  generate {rows} rows in {len(segs)} segments and the numpy "
        f"oracle: {time.perf_counter() - t0:.1f} s; tail user {user}; "
        f"latency_ms raw, segment 0 span {lat_cm.min_value}.."
        f"{lat_cm.max_value}")

    ctxs = {qid: compile_query(sql) for qid, sql in sqls.items()}
    counters = {**scan_counters(), "general_rung": kernels.RUNG_COUNTER}
    ex = ServerQueryExecutor(device=device)
    t0 = time.perf_counter()
    for ctx in ctxs.values():   # untimed pass: stages and plans
        ex.execute(ctx, segs)
    log(f"  staged + one untimed pass: "
        f"{sum(ex.stage(s).nbytes() for s in segs)} bytes resident, "
        f"{time.perf_counter() - t0:.1f} s")

    # fused launches per query and path, from each run's stats
    fused = {"fused_scan": {}, "sharded_fused_scan": {}}

    def checker(qid, path):
        def check(table, stats):
            usertable.check_rows(qid, table.rows, wants[qid])
            _check_user_path(qid, stats, len(segs), path)
            for name, n in (("fused_scan", stats.scan_launches),
                            ("sharded_fused_scan",
                             stats.sharded_scan_launches)):
                fused[name][qid] = fused[name].get(qid, 0) + n
        return check

    _reset(counters)
    lat = {qid: _timed(ex, ctx, segs, reps, checker(qid, USER_PATH))
           for qid, ctx in ctxs.items()}
    launches = _counted(counters, ex.device)
    if launches is not None:
        expect = {name: 0 for name in counters}
        expect["fused_scan"] = len(segs) * reps * len(USER_BATCH)
        expect["general_rung"] = len(segs) * reps * (len(ctxs)
                                                    - len(USER_BATCH))
        if launches != expect:
            raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"  per segment: launches {launches}; U1-U7 == numpy oracle, "
        "declines and rungs as planned")
    per_query = _latencies(lat, rows)
    rungs = {qid: {"decline": USER_PATH[qid][0],
                   "rung_per_segment": USER_PATH[qid][1]} for qid in ctxs}

    bex = ShardedQueryExecutor(device=device)
    batch_path = {qid: (None, None) for qid in USER_BATCH}
    for qid in USER_BATCH:      # untimed: stages the batch and binds
        bex.execute(ctxs[qid], segs)
    _reset(counters)
    batch_lat = {}
    for qid in USER_BATCH:
        batch_lat[qid] = _timed(bex, ctxs[qid], segs, reps,
                                checker(qid, batch_path))
    batch_launches = _counted(counters, bex.device)
    for qid in ctxs:
        if qid in USER_BATCH:
            continue
        try:
            bex.execute(ctxs[qid], segs)
        except NotPortedError as e:
            if e.reason_code != USER_PATH[qid][0]:
                raise AssertionError(f"batch {qid}: {e.reason_code}")
        else:
            raise AssertionError(f"batch {qid}: served, expected "
                                 "NotPortedError")
    if batch_launches is not None:
        expect = {name: 0 for name in counters}
        expect["sharded_fused_scan"] = reps * len(USER_BATCH)
        if batch_launches != expect or _counted(counters,
                                                bex.device) != expect:
            raise AssertionError(f"batch launch counts {batch_launches} != "
                                 f"{expect}")
    log(f"  batch: launches {batch_launches}; U1, U2 == numpy oracle; "
        f"U3-U7 raise NotPortedError with their decline codes")
    batch_per_query = _latencies(batch_lat, rows, beside=per_query)
    raw_fused = {name: by_query.get(USER_RAW_FUSED, 0)
                 for name, by_query in fused.items()}
    if ex.device.type == "cuda" and raw_fused != {
            "fused_scan": len(segs) * reps, "sharded_fused_scan": reps}:
        raise AssertionError(f"{USER_RAW_FUSED}: fused launches {raw_fused}")
    log(f"  fused launches reading the raw latency_ms ({USER_RAW_FUSED}): "
        f"{raw_fused}")
    timing = []
    if ex.device.type == "cuda":
        fused_sqls = {qid: sqls[qid] for qid in USER_BATCH}
        log("  U1, U2 kernel against plain version and timings: segment 0, "
            "then the batch")
        timing = (_time_kernels(ex.stage(segs[0]), errs, segs[0].num_docs,
                                20, fused_sqls)
                  + _time_kernels(bex.batch_for(segs)[1], errs, rows, 20,
                                  fused_sqls))
    return {"rows": rows, "segments": len(segs), "user": user,
            "per_query": per_query, "batch_per_query": batch_per_query,
            "paths": rungs, "launches": launches,
            "batch_launches": batch_launches, "raw_fused_launches": raw_fused,
            "timing": timing}


def _columns_segment(n: int, seed: int, valid_doc_ids=None):
    """(segment, its arrays): a nullable STRING dictionary column ``dim``
    (null rows hold the default "null"), a nullable raw LONG ``rawm``
    (null rows hold 0), an INT multi-value dictionary column ``nums`` (1-4
    values a row) and an INT ``grp``; an upsert-managed segment when
    ``valid_doc_ids`` is given."""
    from pinot_tpu_torch.segment import ColumnArrays, segment_from_arrays
    from pinot_tpu_torch.spi import DataType, FieldType

    rng = np.random.default_rng(seed)
    D, M = FieldType.DIMENSION, FieldType.METRIC
    dim_null = rng.random(n) < 0.1
    dim = np.array(["d0", "d1", "d2", "d3", "d4", "d5"])[
        rng.integers(0, 6, n)]
    dim[dim_null] = "null"
    raw_null = rng.random(n) < 0.07
    rawm = np.where(raw_null, 0, rng.integers(-1000, 100_000, n))
    counts = rng.integers(1, 5, n).astype(np.int32)
    nums = rng.integers(0, 1000, (n, 4)).astype(np.int64)
    entry = np.arange(4)[None, :] < counts[:, None]
    uniq, inv = np.unique(nums[entry], return_inverse=True)
    ids = np.zeros((n, 4), dtype=np.int32)
    ids[entry] = inv.reshape(-1)
    d_uniq, d_ids = np.unique(dim, return_inverse=True)
    g_uniq, g_ids = np.unique(rng.integers(0, 50, n), return_inverse=True)
    seg = segment_from_arrays(
        "columns_0" if valid_doc_ids is None else "columns_upsert", n, {
            "dim": ColumnArrays(DataType.STRING, D, d_uniq,
                                d_ids.reshape(-1), null=dim_null),
            "rawm": ColumnArrays(DataType.LONG, M, values=rawm,
                                 null=raw_null),
            "nums": ColumnArrays(DataType.INT, D, uniq, ids,
                                 mv_counts=counts),
            "grp": ColumnArrays(DataType.INT, D, g_uniq, g_ids.reshape(-1)),
        }, table_name="cols", valid_doc_ids=valid_doc_ids)
    return seg, {"dim": dim, "dim_null": dim_null, "rawm": rawm,
                 "raw_null": raw_null, "nums": nums, "counts": counts,
                 "entry": entry, "grp": g_uniq[g_ids]}


def _columns_answers(a: dict, live) -> dict:
    """numpy rows of phase 8b's queries over the arrays' ``live`` docs."""
    dim, rawm, grp = a["dim"], a["rawm"], a["grp"]
    out = {}
    m = a["dim_null"] & live
    out["N1"] = [[int(m.sum()), int(rawm[m].sum())]]
    m = ~a["raw_null"] & live
    out["N2"] = sorted([d, int((m & (dim == d)).sum()),
                        int(rawm[m & (dim == d)].sum()),
                        int(rawm[m & (dim == d)].min()),
                        int(rawm[m & (dim == d)].max())]
                       for d in np.unique(dim[m]).tolist())
    m = (dim == "d3") & live
    e = a["entry"] & m[:, None]
    vals = a["nums"][e]
    out["M1"] = [[int(e.sum()), int(vals.sum()), int(vals.min()),
                  int(vals.max()), float(vals.sum()) / int(e.sum())]]
    m = (grp < 20) & live
    out["V1"] = sorted([d, int((m & (dim == d)).sum()),
                        int(rawm[m & (dim == d)].sum())]
                       for d in np.unique(dim[m]).tolist())
    return out


# phase 8b's queries: (sql, the fused scan's decline code, the rung)
COLUMN_QUERIES = {
    "N1": ("SELECT count(*), sum(rawm) FROM cols WHERE dim IS NULL",
           "pallas_isnull", None),
    "N2": ("SELECT dim, count(*), sum(rawm), min(rawm), max(rawm) FROM cols "
           "WHERE rawm IS NOT NULL GROUP BY dim ORDER BY dim",
           "pallas_isnotnull", "dense"),
    "M1": ("SELECT countmv(nums), summv(nums), minmv(nums), maxmv(nums), "
           "avgmv(nums) FROM cols WHERE dim = 'd3'", "pallas_mv_aggregation",
           None),
    "V1": ("SELECT dim, count(*), sum(rawm) FROM cols WHERE grp < 20 "
           "GROUP BY dim ORDER BY dim", "pallas_validdocs", "dense"),
}


def phase_columns(seed: int, reps: int, n: int = 1_000_000,
                  device: str = "cuda") -> dict:
    """Null bitmaps (SV dictionary and raw), a numeric MV column's MV
    aggregations and an upsert valid-doc mask on one segment of ``n`` docs,
    each query ``reps`` times on the general rung against numpy; V1 runs
    on the upsert-managed copy (a random 60% of docs live), then again
    after 1000 more docs are invalidated."""
    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools.usertable import check_rows

    rng = np.random.default_rng(seed + 1)
    valid = rng.random(n) < 0.6
    seg, arrays = _columns_segment(n, seed)
    useg, _ = _columns_segment(n, seed, valid_doc_ids=valid.copy())
    wants = _columns_answers(arrays, np.ones(n, dtype=bool))
    wants["V1"] = _columns_answers(arrays, valid)["V1"]
    path = {qid: (code, rung) for qid, (_, code, rung)
            in COLUMN_QUERIES.items()}
    ex = ServerQueryExecutor(device=device)
    lat = {}
    for qid, (sql, _, _) in COLUMN_QUERIES.items():
        on = [useg if qid == "V1" else seg]
        ctx = compile_query(sql)
        ex.execute(ctx, on)     # untimed: stages and plans

        def check(table, stats, qid=qid):
            check_rows(qid, table.rows, wants[qid])
            _check_user_path(qid, stats, 1, path)
        lat[qid] = _timed(ex, ctx, on, reps, check)
    # the snapshot follows the bitmap: invalidate 1000 live docs
    gone = np.nonzero(useg.valid_doc_ids)[0][:1000]
    useg.valid_doc_ids[gone] = False
    valid[gone] = False
    want = _columns_answers(arrays, valid)["V1"]
    table, _ = ex.execute(compile_query(COLUMN_QUERIES["V1"][0]), [useg])
    check_rows("V1", table.rows, want)
    log(f"  8b: IS NULL / IS NOT NULL (SV dictionary and raw), the MV "
        f"aggregations, the upsert mask ({int(valid.sum())} live docs after "
        "1000 invalidated) == numpy, each on the general rung")
    return {"docs": n, "per_query": _latencies(lat, n),
            "paths": {q: {"decline": c, "rung": r}
                      for q, (c, r) in path.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--user-segments", type=int, default=8)
    ap.add_argument("--user-rows", type=int, default=2_500_000,
                    help="rows per user-events segment")
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

    log("phase 8: the user-events table (raw, multi-value columns)")
    t0 = time.perf_counter()
    users_run = phase_users(args.seed, args.reps,
                            segments=args.user_segments,
                            rows_per_segment=args.user_rows, errs=errs)
    log("phase 8b: null bitmaps, multi-value aggregations, upsert mask")
    columns_run = phase_columns(args.seed, args.reps)
    log(f"  user-events phase: {time.perf_counter() - t0:.1f} s")
    log("rungs " + json.dumps({
        "flights_fused_off": general_run["rungs"],
        "declined": {g: d["rung_segments"]
                     for g, d in general_run["declined"].items()},
        "user_events": users_run["paths"], "columns": columns_run["paths"]}))
    # each path's launches, read after its own run: phase 4 (per segment),
    # phase 6 (batch) and phase 8 (per segment and batch)
    launches = {**main_run["launches"], **{
        k: v for k, v in batch_run["launches"].items() if k.startswith(
            "sharded")}}
    for k in launches:
        launches[k] += (users_run["launches"][k]
                        + users_run["batch_launches"][k])
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
                       "user_events": users_run, "columns": columns_run,
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
