"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output and the numbers the check compared, each beside its
limit, as the last lines of standard error. See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches live in the checkout, at fixed paths
    cache = os.path.join(ROOT, "benchmark", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                     "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # few threads: the host path runs under one GIL, and on a shared host
    # the process keeps to a handful of its own
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    if sys.path[0] != ROOT:
        sys.path.insert(0, ROOT)
    from benchmark.harness.main import process_start, run

    return run(ROOT, args.workload, args.seed, args.seconds,
               bool(args.trace), t_proc=min(process_start(), T_START))


if __name__ == "__main__":
    sys.exit(main())
