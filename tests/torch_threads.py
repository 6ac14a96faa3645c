"""One torch thread for the port's CPU tests.

The suite runs in several worker processes at once (pytest-xdist), each of
which would give torch one OpenMP thread per core. The port's tests run
thousands of small ops, each a parallel region whose barrier waits for
threads the other processes have descheduled: measured on 8 cores, a golden
row that takes 4.5 s alone took 687 s so. A test module takes the fixture
below by importing it; the thread count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
