"""One PyTorch intra-op thread for the port's CPU tests.

The tier-1 run puts six pytest workers on the machine's cores.  PyTorch
gives each worker one OpenMP thread per core, and the workers' threads then
wait on each other at every parallel region: a TINY_R SmoothGrad sweep of
small chunks ran about 200x slower in the suite than alone.  With one
thread a worker, each test takes about what it takes alone.

Import the fixture into a test module to apply it there.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
