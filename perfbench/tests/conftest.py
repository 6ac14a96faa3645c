"""The benchmark's own tests: CPU tests at small sizes, and `gpu` tests that
run a cell on the card (they skip without one)."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite may run beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
