"""Tests of the benchmark harness, run with ``python -m pytest benchmark/tests``.

They run on the CPU at tiny sizes, through the port's plain kernels and the
test-only cells under ``tiny/``. Tests marked ``card`` need the CUDA card:
each decides inside itself whether there is one and skips without it; on the
card, ``python -m pytest benchmark/tests -m card`` runs them.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
