"""The benchmark's own tests: CPU tests at small sizes, one torch thread
each (several pytest workers share the cores); tests marked ``cuda`` need a
card and skip without one, decided inside their fixture."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def cpu_context(cell, seed=20260101, seconds=0.5, overrides=None,
                faults=None):
    """A run's context on the CPU at a small size."""
    import torch
    from benchmark.run import Context
    return Context(cell, seed, seconds, False, torch.device("cpu"),
                   overrides=overrides, faults=faults)


SMALL = {
    "hrda_star.uda_step": dict(backbone="mit_b0", channels=32, size=64,
                               compute_dtype="float32"),
    "uawarpc_s1.train_step": dict(vgg="vgg11", size=80, crop=64,
                                  compute_dtype="float32"),
    "hrda_star.slide_1080p": dict(backbone="mit_b0", channels=32,
                                  height=128, width=192, crop=[128, 128],
                                  stride=[64, 64], dtype="float32"),
}
