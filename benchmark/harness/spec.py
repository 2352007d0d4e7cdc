"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration's file is the ``file`` its entry gives; its ``generator``
  is ``benchmark/generators/<generator>.py``;
- a traffic mix is ``benchmark/traffic/<traffic>.json``;
- a per-layer metric is read by ``benchmark/metrics/<name>.py``.

Nothing else needs an edit when a cell, a configuration or a metric is
added.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, workload: str) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(root, entry["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic",
                                      f"{w['traffic']}.json"))
    return Cell(w, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


def generator(root: str, name: str):
    return load_module(os.path.join(root, "benchmark", "generators",
                                    f"{name}.py"),
                       f"benchmark_generator_{name.replace('-', '_')}")


def metric_readers(root: str, metrics: List[dict]) -> Dict[str, object]:
    return {m["name"]: load_module(
        os.path.join(root, "benchmark", "metrics", f"{m['name']}.py"),
        "benchmark_metric_" + m["name"].replace("-", "_").replace(".", "_"))
        for m in metrics}
