"""CPU tests of the benchmark; tests marked ``cuda`` need a card and skip here."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU with CUDA; skips where torch.cuda.is_available() is false")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def root():
    return ROOT


def tiny(cell, side=16, width=16, height=12):
    """Configuration overrides that shrink a cell to a CPU test's size."""
    return {"volume": dict(cell.config["volume"], side=side), "width": width, "height": height}
