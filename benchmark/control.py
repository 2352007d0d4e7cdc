"""The control of the comparison that decides ``correct``, at a cell's size.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

For each seed it draws the cell's table and every SQL variant of its
traffic, then puts the reference computed in float32 (the precision below
the one the configurations state) in the program's place and holds it to
the exact reference, as a run holds the program. It prints, per seed, the
numbers the check compares (``wrong_queries`` over every variant once, and
``max_rel_err`` where the traffic has a fractional aggregate). The
benchmark's runs never run it; the limits in the traffic files lie below
what it reads.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(root: str, workload: str, seed: int, device: str,
            overrides=None) -> dict:
    import torch

    from benchmark.harness import spec, traffic as traffic_mod
    from benchmark.harness.check import compare, fractional
    from benchmark.reference.evaluate import answer

    cell = spec.load_cell(root, workload)
    config = {**cell.config, **(overrides or {}).get("config", {})}
    traffic = {**cell.traffic, **(overrides or {}).get("traffic", {})}
    frame = spec.generator(root, config["generator"]).generate(
        config, seed, device)
    variants = traffic_mod.draw_variants(traffic, frame.table)
    wrong = n = 0
    worst = 0.0
    for vs in variants.values():
        for v in vs:
            got = answer(frame, v.query, precision="float32")
            same, rel = compare(v.query, got, answer(frame, v.query))
            n += 1
            wrong += not same
            if fractional(v.query):
                worst = max(worst, rel)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    return {"workload": workload, "seed": seed, "queries": n,
            "wrong_queries": wrong, "max_rel_err": worst}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    for seed in args.seeds:
        print(json.dumps(control(ROOT, args.workload, seed, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
