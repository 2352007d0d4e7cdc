"""On the card: one short run of each cell at its full size. Marked
``card``; skips where the process sees no CUDA card."""

import io
import json

import pytest

from bench_tiny import ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ssb-flights-c1"])
def test_cell_on_the_card(card, workload):
    from benchmark.harness.main import run

    out, err = io.StringIO(), io.StringIO()
    assert run(ROOT, workload, 2**31 + 5, 3.0, False, device=card,
               out=out, err=err) == 0, err.getvalue()[-3000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
