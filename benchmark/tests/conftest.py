"""The benchmark's tests: its modules from benchmark/, the program from
the checkout root. Run with

    python -m pytest benchmark/tests -q -o addopts=""

(tests marked cuda need a card and skip without one)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
