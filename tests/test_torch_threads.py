"""The PyTorch thread count of a test run under pytest-xdist.

Each xdist worker imports every test file while it collects, so the lines
below, run as this module is imported, set the thread count for the whole
run: the workers share the host's cores (cores // workers each, at least
1) instead of each starting a thread a core, whose spinning threads then
take the cores from each other (five workers of the LSTM arithmetic tests
on 8 cores: 363 s with a thread a core each, 66 s with two).  A run in one
process keeps PyTorch's default.
"""

import os

import torch


def worker_threads():
    """Threads a worker takes under xdist, or None outside it."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    return max(1, (os.cpu_count() or 1) // int(workers)) if workers else None


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)


def test_xdist_workers_share_the_cores():
    """The count still holds when the tests run: nothing of the run set it
    again."""
    assert THREADS is None or torch.get_num_threads() == THREADS
