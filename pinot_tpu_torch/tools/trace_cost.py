"""Per-query wall time of the 13 SSB flights, untraced and traced.

    python3 pinot_tpu_torch/tools/trace_cost.py --out FILE [--root DIR]
        [--sf 2] [--reps 20] [--device cuda]

Builds SSB at ``--sf`` in 8 segments with the generator of the checkout
at ``--root`` (default: the one this file is in), runs each flight once
to stage, plan and build, then ``--reps`` passes of the 13 flights
through that checkout's ``ServerQueryExecutor(device=...)``, each timed
on the host clock around ``execute`` and the device's synchronize: first
untraced, then with OPTION(trace=true) (a checkout without tracing
ignores the option). Writes each flight's median ms and the card's name
and power limit as JSON to ``--out``. Run it as a file, not as a module:
``--root`` decides which ``pinot_tpu_torch`` it imports, so two trees
compare inside one chip call, in turns (old, new, new, old).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _card(device: str) -> str:
    if device != "cuda":
        return device
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--sf", type=float, default=2.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    from pinot_tpu_torch.engine.executor import ServerQueryExecutor
    from pinot_tpu_torch.query import compile_query
    from pinot_tpu_torch.tools import ssb

    if args.device == "cuda" and not torch.cuda.is_available():
        print("trace_cost: no CUDA card", file=sys.stderr)
        return 2
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    segs, _ = ssb.build_segments(args.sf, num_segments=8, seed=42)
    ex = ServerQueryExecutor(device=args.device)
    out = {"root": root, "card": _card(args.device), "sf": args.sf,
           "reps": args.reps}
    for label, suffix in (("untraced", ""),
                          ("traced", " OPTION(trace=true)")):
        ctxs = {q: compile_query(t + suffix) for q, t in ssb.QUERIES.items()}
        for ctx in ctxs.values():           # stage, plan and build once
            ex.execute(ctx, segs)
        sync()
        lat = {q: [] for q in ctxs}
        for _ in range(args.reps):
            for q, ctx in ctxs.items():
                t0 = time.perf_counter()
                ex.execute(ctx, segs)
                sync()
                lat[q].append((time.perf_counter() - t0) * 1e3)
        out[label] = {q: float(np.median(v)) for q, v in lat.items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("card", "untraced", "traced")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
