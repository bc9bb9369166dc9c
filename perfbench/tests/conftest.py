"""Tests of the benchmark harness.

Most run on the CPU at small sizes. Those that need an NVIDIA card are
marked ``chip`` and skip without one (decided in the ``card`` fixture);
on a machine with the card run them with

    python -m pytest perfbench/tests -m chip
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a sample small enough for the CPU: every pair's 10 copies fit the
# genome, and the amplicons are covered ~30 times
SMALL = {"genome_bp": 1_000_000, "n_reads": 20_000, "batch_reads": 4096,
         "amplicon_copies": 10}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    return torch.device("cuda", 0)


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def small():
    return dict(SMALL)
