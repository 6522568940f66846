"""The suite's rule for threads (the root ``conftest.py``): a process that
runs tests gives torch's intra-op pool its share of the cores, and the
processes its tests spawn see a thread count in ``OMP_NUM_THREADS``."""
import os
import subprocess
import sys

import torch


def test_a_test_process_takes_its_share_of_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    share = max(1, len(os.sched_getaffinity(0)) // workers)
    assert torch.get_num_threads() == share
    # the rule's count, or the caller's own where the caller set one
    omp = os.environ.get("OMP_NUM_THREADS")
    assert omp
    child = subprocess.run(
        [sys.executable, "-c",
         "import os; print(os.environ['OMP_NUM_THREADS'])"],
        capture_output=True, text=True, check=True, timeout=60)
    assert child.stdout.strip() == omp
