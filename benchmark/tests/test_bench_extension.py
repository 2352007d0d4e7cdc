"""A configuration, a traffic mix and a per-layer metric added as files in
a copy of the benchmark: the harness finds and runs them, with no other
file edited."""

import json
import os
import shutil
import subprocess
import sys

from bench_tiny import ROOT

METRIC = '''"""queries_done (queries): queries that finished."""


def read(obs):
    return float(sum(1 for q in obs.queries if q.error is None))
'''


def test_added_files_are_found(tmp_path):
    root = tmp_path / "copy"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: (root / p).read_bytes() for p in
              [os.path.relpath(os.path.join(d, f), root)
               for d, _, fs in os.walk(root) for f in fs]}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/ssb-sf5.json").read_text())
    cfg.update(name="ssb-tiny", orders=7_500, customers=150, suppliers=10,
               parts=1_000, segments=3)
    (root / "benchmark/configs/ssb-tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "benchmark/traffic/flights-c1.json")
                    .read_text())
    tr.update(name="tiny-mix", clients=2, variants=2,
              templates=[t for t in tr["templates"]
                         if t["id"] in ("Q1.1", "Q2.1", "Q4.3")])
    (root / "benchmark/traffic/tiny-mix.json").write_text(json.dumps(tr))
    (root / "benchmark/metrics/queries_done.py").write_text(METRIC)
    bench["configs"].append({"name": "ssb-tiny", "source": "test",
                             "file": "benchmark/configs/ssb-tiny.json",
                             "reduced": cfg["reduced"], "why": "test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "ssb-tiny",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "queries_done", "unit": "queries",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "qps", "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from benchmark.harness.main import run; "
            "sys.exit(run(sys.argv[1], 'tiny-cell', 3, 1.0, True, "
            "device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code, str(root), ROOT],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(root))
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["queries_done"]["value"] >= 1
    # every file that was there is as it was, BENCHMARK.json aside
    for path, raw in before.items():
        if path != "BENCHMARK.json":
            assert (root / path).read_bytes() == raw, path


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run fails and prints no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from benchmark.harness.main import run; "
            "sys.exit(run(sys.argv[1], 'ssb-flights-c1', 3, 1.0, False, "
            "device='cpu', overrides={'config': {'orders': 500, 'customers': 30, "
            "'suppliers': 5, 'parts': 100}}))")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
