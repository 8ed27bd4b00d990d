"""Shared fixture of the port's CPU tests (tests/test_torch_*.py).

The suite runs several pytest workers on one machine.  PyTorch's intra-op
thread pool in each worker would contend for the same cores, and its
spinning threads then slow every small tensor operation by orders of
magnitude (a 0.5 s GTAO comparison took 33 s beside six busy processes).
The port's tests run PyTorch on one thread; the results do not depend on
the thread count beyond the rounding of large float reductions, which the
tests' tolerances already cover.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the importing test module's PyTorch work on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
