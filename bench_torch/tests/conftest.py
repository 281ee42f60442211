import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six test workers, each with one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
