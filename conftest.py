"""How many threads a test process may use, set once for the whole suite.

The port's CPU tests are many small torch ops.  Beside other test workers on
a loaded host, each op's thread-pool barrier waits for descheduled threads
and costs far more than the op (a smoke Jamba train run: 2.2 s on one thread
against 65 s on eight, with eight busy processes beside it).  So each process
that runs tests takes its share of the cores it may use, ``max(1, cores //
workers)`` with ``workers`` pytest-xdist's count (1 without it), for torch's
intra-op pool and, unless the caller set it, as ``OMP_NUM_THREADS`` for the
processes its tests spawn.  A plain ``pytest`` keeps every core.

pytest puts this file's folder, the repo root, on ``sys.path``, so a test
run from any folder imports ``portbench``."""
import os

import torch


def pytest_configure(config):
    if config.getoption("numprocesses", None):
        # xdist's controller: it runs no test, and its workers inherit its
        # environment, so it leaves OMP_NUM_THREADS to them
        return
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, len(os.sched_getaffinity(0)) // workers)
    torch.set_num_threads(threads)
    os.environ.setdefault("OMP_NUM_THREADS", str(threads))
