"""What tracing costs a query: the 13 SSB flights, untraced and traced in
turns, query by query.

    python3 pinot_tpu_torch/tools/trace_cost.py --out FILE [--root DIR]
        [--sf 2] [--reps 200] [--device cuda]

Builds SSB at ``--sf`` in 8 segments with the generator of the checkout
at ``--root`` (default: the one this file is in) and queries it through
that checkout's ``ShardedQueryExecutor(device=...)``, the path the
benchmark's SSB cell runs (one launch over the kept segments' batch).
``measure`` runs each flight once untraced and once with
OPTION(trace=true) to stage, plan and build, then ``--reps`` rounds in
which every flight runs untraced and traced back to back, the order
swapped every round, each timed on the host clock around ``execute`` and
the device's synchronize. The two runs of a pair meet the same host and
the same heap, so the median of the pairs' differences resolves a cost
far below the spread between two processes. Writes, a flight each, the
untraced and traced medians and the median difference (and the sums over
the flights), with the card's name and power limit, as JSON to
``--out`` (a checkout without tracing ignores the option: its
difference is the noise floor). Run it as a file, not as a module:
``--root`` decides which ``pinot_tpu_torch`` it imports, so two trees
compare inside one chip call. ``measure`` takes any executor and
queries, so another table can be measured the same way.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

TRACE = " OPTION(trace=true)"


def _card(device: str) -> str:
    if device != "cuda":
        return device
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def measure(run: Callable[[object], object],
            pairs: Dict[str, Sequence[Tuple[object, object]]], reps: int,
            sync: Callable[[], None] = lambda: None) -> Dict[str, Dict]:
    """``pairs``: a flight -> its (untraced, traced) queries, taken in turn
    round by round; ``run(query)`` executes one. -> ``untraced`` and
    ``traced`` (a flight's median ms), ``diff`` (its median traced less
    untraced ms over the rounds) and ``sums`` (of each over the
    flights)."""
    for qs in pairs.values():          # stage, plan and build every query
        for q in qs:
            for one in q:
                run(one)
    sync()

    def timed(query) -> float:
        t0 = time.perf_counter()
        run(query)
        sync()
        return (time.perf_counter() - t0) * 1e3

    lat: Dict[str, Tuple[List[float], List[float]]] = {
        f: ([], []) for f in pairs}
    for rep in range(reps):
        for f, qs in pairs.items():
            plain, traced = qs[rep % len(qs)]
            if rep % 2:
                t_tr, t_pl = timed(traced), timed(plain)
            else:
                t_pl, t_tr = timed(plain), timed(traced)
            lat[f][0].append(t_pl)
            lat[f][1].append(t_tr)
    med = statistics.median
    out = {"untraced": {f: med(u) for f, (u, _t) in lat.items()},
           "traced": {f: med(t) for f, (_u, t) in lat.items()},
           "diff": {f: med([b - a for a, b in zip(u, t)])
                    for f, (u, t) in lat.items()}}
    out["sums"] = {k: sum(out[k].values()) for k in ("untraced", "traced",
                                                      "diff")}
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--sf", type=float, default=2.0)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    from pinot_tpu_torch.parallel.executor import ShardedQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    if args.device == "cuda" and not torch.cuda.is_available():
        print("trace_cost: no CUDA card", file=sys.stderr)
        return 2
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    segs, _ = ssb.build_segments(args.sf, num_segments=8, seed=42)
    ex = ShardedQueryExecutor(device=args.device)
    pairs = {q: [(compile_query(t), compile_query(t + TRACE))]
             for q, t in ssb.QUERIES.items()}
    out = {"root": root, "card": _card(args.device), "sf": args.sf,
           "reps": args.reps,
           **measure(lambda ctx: ex.execute(ctx, segs), pairs, args.reps,
                     sync)}
    ex.close()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("card", "sums", "diff")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
