"""One intra-op thread for torch in the port's CPU tests.

The suite runs in several pytest-xdist workers on one machine, and torch
would start one intra-op thread per core in each of them; the port's
tests work on small tensors, where those threads only contend. Every
``tests/test_torch_*.py`` imports ``one_torch_thread``, which sets one
thread for each test and restores the count after it."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_one_torch_thread_inside_a_test():
    assert torch.get_num_threads() == 1
