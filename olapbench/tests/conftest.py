"""Fixtures of the benchmark's own tests (run them from the checkout's root:
``python -m pytest olapbench/tests``). They run on the CPU at tiny
scales; a test marked ``card`` needs a CUDA device and skips without one,
decided inside its fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 3_000_000_019          # past 2**31, as the driver's seeds are


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def bench():
    from olapbench import catalog
    return catalog.benchmark(ROOT)
