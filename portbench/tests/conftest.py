"""Shared fixtures of the benchmark's own tests (``pytest portbench/tests``).

Card tests carry the ``cuda`` marker and take the ``card`` fixture, which
decides when the test runs whether there is a card, and skips if not.
"""

import pytest
import torch

# CPU runs of the harness: tiny slices, tiny batches, a pool of two
SHRINK = {"slice": [32, 48], "batch": 3, "pool_bytes": 1}
CELLS = ("xray_clahe.archive", "ct_lowdose_nlm.archive",
         "ct_median_bilateral.archive")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")
