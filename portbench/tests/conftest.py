"""The benchmark's own tests: run from the checkout's root with
``python -m pytest portbench/tests``.  They put ``portbench/`` (the
harness and the reference) and the checkout's root (the program) on the
path."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
