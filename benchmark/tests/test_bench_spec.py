"""BENCHMARK.json's names, units and files, and the result's last line."""

import json
import os
import re

import pytest

from bench_tiny import ROOT, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(names) == len(set(names))
    assert 1 <= b["run_seconds"] <= 51
    for s in b["command"] + [x for c in b["configs"]
                             for x in (c["source"], c["why"])]:
        assert 1 <= len(s) <= 200 and "\t" not in s and "\n" not in s


def test_named_files_exist():
    b = _bench()
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "generators", f"{cfg['generator']}.py"))
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "metrics", f"{m['name']}.py"))


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    rc, line, err = run_tiny("ssb-flights-c1", trace=trace)
    assert rc == 0, err
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    b = _bench()
    want = {m["name"] for m in (b["per_layer"] if trace else b["end_to_end"])
            if "ssb-flights-c1" in m.get("workloads", ["ssb-flights-c1"])}
    got = set(line["metrics"])
    # on the CPU the trace holds no device event: those metrics stay out
    assert got <= want and ("qps" in got if not trace else "stage_s" in got)
    for name, c in line["checks"].items():
        assert f"check {name}: {c['value']} (limit {c['limit']})" in err
    assert err.strip().splitlines()[-1].startswith("check ")
