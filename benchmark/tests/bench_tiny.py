"""Tiny sizes for running the harness on the CPU in the tests."""

import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 977
TINY = {
    "ssb-flights-c1": {"config": {"orders": 15_000, "customers": 300,
                                  "suppliers": 20, "parts": 2_000,
                                  "segments": 4},
                       "traffic": {"variants": 2}},
}


def run_tiny(workload: str, trace: bool = False, seconds: float = 1.5,
             seed: int = SEED, root: str = ROOT):
    """(exit code, the last line as a dict or None, standard error) of one
    run of ``workload`` at a tiny size on the CPU."""
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.harness.main import run

    out, err = io.StringIO(), io.StringIO()
    rc = run(root, workload, seed, seconds, trace, device="cpu",
             overrides=TINY[workload], out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
