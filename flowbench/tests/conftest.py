"""CPU tests of the benchmark: `python -m pytest flowbench/tests -q`.

Tests marked `card` need a CUDA device; they skip elsewhere, decided
inside the `card` fixture (never while a module is imported).  On the
card: `python -m pytest flowbench/tests -q -m card`."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
