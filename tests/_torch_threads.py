"""One torch thread for the port's CPU tests.

The port's tests run small shapes on the CPU, where torch's intra-op
threads gain little, and under the suite's parallel run (several pytest
workers on a few cores) each worker's threads only contend with the
others' (on an 8-core host a jamba witness took 62 s alone and 403 s
inside the suite's six-worker run).  Importing ``one_torch_thread`` into a test module makes it an
autouse fixture there: each test runs under ``torch.set_num_threads(1)``,
and the count is restored after it.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
