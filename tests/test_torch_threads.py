"""The CPU threads of torch in a parallel test run.

Under pytest-xdist every worker collects every test file, so this module's
set-up runs in each worker before its first test. Left alone, each worker's
torch takes one intra-op thread per core: six workers on eight cores then
run ~48 busy threads, and the port's CPU training tests ran up to 20 times
slower than alone (the whole tier took 700 s instead of 310 s on one
8-core machine). Each worker instead takes its share of the cores, rounded
up. A run in one process keeps torch's default.
"""

import os

import torch


def _cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


def worker_threads(cores, workers):
    """Intra-op threads for each of ``workers`` processes on ``cores``."""
    return max(1, -(-cores // workers))


_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(worker_threads(_cores(), _WORKERS))


def test_worker_threads_share_the_cores():
    assert worker_threads(8, 6) == 2
    assert worker_threads(8, 1) == 8
    assert worker_threads(2, 6) == 1
    if _WORKERS > 1:
        assert torch.get_num_threads() == worker_threads(_cores(), _WORKERS)
