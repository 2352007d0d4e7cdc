"""The comparison fails what it must: the control (the reference in
float32 in the program's place) and a timed path broken underneath (an
answer altered where it is produced; half of the segments left out)."""

from types import SimpleNamespace

import pytest

from benchmark.harness import port as port_mod
from benchmark.harness import spec, traffic as traffic_mod
from benchmark.reference.evaluate import answer

from bench_tiny import ROOT, SEED, TINY, run_tiny


def _control_run(monkeypatch, workload):
    cell = spec.load_cell(ROOT, workload)
    cfg = {**cell.config, **TINY[workload]["config"]}
    tr = {**cell.traffic, **TINY[workload]["traffic"]}
    frame = spec.generator(ROOT, cfg["generator"]).generate(cfg, SEED, "cpu")
    by_sql = {v.sql: v.query for vs in traffic_mod.draw_variants(
        tr, frame.table).values() for v in vs}

    def control(self, ctx):
        return (answer(frame, by_sql[ctx.sql], precision="float32"),
                SimpleNamespace(launch={}, spans=[]))

    monkeypatch.setattr(port_mod.Port, "run", control)
    return run_tiny(workload)


def test_control_is_not_correct(monkeypatch):
    rc, line, err = _control_run(monkeypatch, "ssb-flights-c1")
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["wrong_queries"]["value"] > 0


def _altered(self, ctx):
    rows, stats = _real_run(self, ctx)
    rows = [list(r) for r in rows]
    for r in rows[:1]:
        for i, c in enumerate(r):
            if isinstance(c, (int, float)) and not isinstance(c, bool):
                r[i] = c + 1
                break
    return rows, stats


def _half(self, ctx):
    table, stats = self.executor.execute(
        ctx, self.segments[:len(self.segments) // 2])
    return table.rows, stats


_real_run = port_mod.Port.run


@pytest.mark.parametrize("fault", [_altered, _half],
                         ids=["answer_altered", "half_left_out"])
def test_faults_are_not_correct(monkeypatch, fault):
    monkeypatch.setattr(port_mod.Port, "run", fault)
    rc, line, err = run_tiny("ssb-flights-c1")
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["wrong_queries"]["value"] > 0


def test_control_script_reads_the_control():
    from benchmark.control import control

    got = control(ROOT, "ssb-flights-c1", SEED, "cpu",
                  overrides=TINY["ssb-flights-c1"])
    assert got["wrong_queries"] > 0
