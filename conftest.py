"""Test-run settings for every pytest run from this repo: one torch thread
in each xdist worker, and a time limit on each phase of each test."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

from time_limit import PhaseLimit  # noqa: E402

# `-n 6` runs six workers on the machine's cores, and torch's OpenMP pool in
# each has a thread per core.  Measured on an 8-vCPU host, six copies of
# test_torch_align_train_step's fixture at once: a port step of 0.93 s alone
# had not finished after 130 s; with one torch thread each, 2.5-2.9 s.  The
# tier-1 run took 888 s unpinned and 382-714 s pinned, on a shared host.
# Spawned rank processes inherit OMP_NUM_THREADS.  A plain run (one process)
# keeps torch's default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    torch.set_num_threads(1)

# In the pinned tier-1 runs on a shared 8-vCPU host the slowest test took
# 121-317 s, 37-45 % of the run's wall time; a test past 600 s means a run of
# some 1,340 s of its 1,470 s limit, so the limit cuts a test only in a run
# near its own limit.
TEST_LIMIT_S = 600


def pytest_configure(config):
    config.pluginmanager.register(PhaseLimit(TEST_LIMIT_S), "phase_limit")
