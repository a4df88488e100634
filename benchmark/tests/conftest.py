"""The benchmark's tests. Run from the root of the checkout:

    python -m pytest benchmark/tests -q

Tests marked ``card`` run on an NVIDIA GPU and skip elsewhere; whether
there is a card is decided inside the ``card`` fixture."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs on an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return "cuda"
