"""Shared fixture of the port's CPU test modules (imported by each)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work: the suite runs
    several worker processes on the host's cores, where each process's
    OpenMP pool (a thread per core) stalls the others' at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
