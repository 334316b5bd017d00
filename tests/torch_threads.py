"""Shared fixture of the port's test files (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes, one per core or so;
    one PyTorch intra-op thread per worker keeps them from oversubscribing
    the cores (the port's CPU tests are many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
