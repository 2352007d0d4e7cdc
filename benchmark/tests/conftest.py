"""Tests of the benchmark: ``python -m pytest benchmark/tests -q`` from the
root of the repository. Tests marked ``card`` need a CUDA card and skip
without one; ``python -m pytest benchmark/tests -q -m card`` runs them on
the card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where the process sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return "cuda"


@pytest.fixture(scope="session")
def root():
    return ROOT
