"""Tests of the benchmark harness (benchmark/). They run on the CPU at
SF0.01; a test marked `cuda` needs the card and skips without one,
decided inside its fixture."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels have no CPU mode)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only on the card")
    return torch.cuda.get_device_name(0)
