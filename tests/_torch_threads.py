"""One intra-op thread for a module of the port's tests.

The suite runs its files in several processes at once on one host, and
the port's tests are mostly many small PyTorch ops. Each of them, on a
thread pool as wide as the host and with the host already busy, waits on
threads that other processes hold: a loop of 500 tiny calls takes 80 times
as long on 8 threads as on one under such a load. A test module imports
`one_intra_op_thread` (an autouse module fixture) to run on one thread, as
the gloo processes that the multi-process tests start already do
(`OMP_NUM_THREADS=1`).
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
