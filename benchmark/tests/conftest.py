"""The benchmark's tests: run them with the repository's pytest flags,

    python -m pytest benchmark/tests -q -p xdist -n 6

Tests that need a CUDA card carry the ``card`` marker and skip without
one (the fixture ``card`` decides, at run time); on the card:

    python -m pytest benchmark/tests -q -m card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false here)")
    return torch.cuda.get_device_name(0)
