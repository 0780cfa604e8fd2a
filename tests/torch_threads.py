"""One intra-op thread for the port's CPU work, shared by every
`tests/test_torch_*.py` module (`one_torch_thread`, a module fixture they
import) and the spawned ranks of `torch_parallel_worker.py`
(`one_thread`).

The suite runs under 6 xdist workers on a host of about as many cores.
Torch's intra-op OpenMP team defaults to one thread per core in every
worker, so six teams oversubscribed the cores and small-shape steps that
take a fraction of a second alone took tens of seconds (one CLI run 11
minutes instead of 9 s; one Adam trajectory test over 600 s). Torch only:
the ranks import it."""

import pytest
import torch


def one_thread() -> int:
    """Pin torch to one intra-op thread; returns the count it had."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after."""
    n = one_thread()
    yield
    torch.set_num_threads(n)
