"""One torch intra-op thread for the port's tests: every
``tests/test_torch_*.py`` imports ``one_torch_thread``, an autouse fixture
of module scope, so its cases and its module-scoped fixtures run on one
thread.  Not collected (its name does not start with ``test_``).

The tier-1 run puts several pytest-xdist workers on the host's cores, and
in each worker torch's intra-op pool starts one thread per core.  The
port's CPU cases are small tensors: under that load their threads mostly
wait for each other, and one thread runs them several times faster, as
fast as the pool when nothing runs beside.  A new port test file imports
the fixture too.

This module imports neither JAX nor the JAX package, so that the card
tests run on a machine without it (``--noconftest``; README).
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for the module; the old count after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
