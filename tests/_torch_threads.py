"""An autouse fixture that runs each test of the port with one PyTorch CPU
thread.

The tier-1 command runs six pytest-xdist workers on the machine's cores,
and PyTorch's OpenMP pool (a thread per core in every worker) then spins
against the other workers: one tiny DDPM training run took 124 s in each of
six concurrent processes at 8 threads and 2.6 s at 1 thread, on an 8-core
host.  Import the fixture into a test module to apply it there.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
