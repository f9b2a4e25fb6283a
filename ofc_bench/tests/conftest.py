"""Tests of the benchmark harness. They run on the CPU at tiny sizes through
the port's plain path; tests marked `card` need a CUDA device and skip
without one (`python3 -m pytest ofc_bench/tests -m card` on the card)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
