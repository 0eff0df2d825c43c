"""The benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need the card carry the ``chip`` marker and skip without one;
run them on the card with ``python -m pytest -m chip portbench/tests``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    """Skip the test where no CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is present")
    return "cuda"
