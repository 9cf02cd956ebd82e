"""Tests of the benchmark, on the CPU.  Tests that need a card take the
``card`` marker and skip without one (decided inside the test)."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "python3 -m pytest sdrbench/tests -m card")
    return torch.device("cuda")
