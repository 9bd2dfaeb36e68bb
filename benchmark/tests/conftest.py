"""The benchmark's CPU tests: `python -m pytest benchmark/tests`.  Tests
marked `chip` need a CUDA device and skip without one; run them on the card
with `python -m pytest -m chip benchmark/tests`."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
