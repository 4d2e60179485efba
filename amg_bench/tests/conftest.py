"""The benchmark's own tests, on the CPU at tiny grids (the
cells run on the card; these hold the harness, the reference and the
comparison).  ``card`` marks a test that needs a CUDA card; it skips here.

    python -m pytest amg_bench/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
