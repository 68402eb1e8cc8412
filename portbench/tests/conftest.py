r"""Settings of the benchmark's own tests: the repository root on the
import path, the ``card`` marker, and the ``card`` fixture that decides,
while a test runs, whether there is a CUDA device."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one (run "
        "`python3 -m pytest portbench/tests -m card` on the card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
