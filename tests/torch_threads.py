"""An autouse fixture for the test modules of lpe_tpu_torch on the CPU:
import it into a module to run that module's tests with one torch thread.

The suite runs several worker processes on one host. torch's default of one
intra-op thread per core then oversubscribes the cores: the port's small
tensor ops slowed some twenty-fold, and the JAX workers beside them too.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
