"""One intra-op thread for the port's CPU tests: their tensors are tiny, and
the suite runs in parallel workers beside threaded real-clock tests that a
pool of torch threads per worker would starve."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
