"""One intra-op thread for the port's CPU tests (tests/test_torch_*.py).

The suite runs under pytest-xdist, several workers on one machine. torch
gives each process as many intra-op threads as the machine has cores, so
six workers run ~48 threads on 8 cores, and the port's many small CPU
ops each wait at a parallel region for threads that are not scheduled:
a tiny engine run that takes 0.24 s alone took ~10 s there. Each port
test module imports ``one_intra_op_thread`` (an autouse, module-scoped
fixture), which runs the module on one intra-op thread and restores the
count after it, so the JAX package's tests in the same worker keep
theirs.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
