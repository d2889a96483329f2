"""The test harness's own guards: one torch thread per xdist worker and
a time limit on each test phase (the repo's root ``conftest.py``, with
``time_limit.py``), and ``torch_dist_ranks.spawn``, which leaves no rank
behind."""
import os
import re
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))


def _env():
    """This environment without the xdist worker's variables, with this
    directory importable."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = TESTS
    return env


def test_one_torch_thread_in_each_worker():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        pytest.skip("a plain run keeps torch's default threads")
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"


def test_limit_raises_and_dumps_the_stacks():
    code = textwrap.dedent("""
        import time
        from time_limit import TestTimeLimit, limit
        t0 = time.monotonic()
        try:
            with limit(1):
                time.sleep(5)
        except TestTimeLimit:
            print(f"raised after {time.monotonic() - t0:.3f}")
    """)
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    waited = float(re.search(r"raised after ([\d.]+)", out.stdout).group(1))
    assert 0.9 < waited < 3.0
    # the dumped stack ends in the sleep, line 7 of the program
    assert 'File "<string>", line 7' in out.stderr, out.stderr


def test_a_hang_fails_one_test_under_xdist(tmp_path):
    (tmp_path / "conftest.py").write_text(textwrap.dedent("""
        from time_limit import PhaseLimit

        def pytest_configure(config):
            config.pluginmanager.register(PhaseLimit(2), "phase_limit")
    """))
    (tmp_path / "test_a.py").write_text(textwrap.dedent("""
        import time

        def test_sleeps():
            time.sleep(30)

        def test_after():
            pass
    """))
    (tmp_path / "test_b.py").write_text(
        "def test_one():\n    pass\n\n\ndef test_two():\n    pass\n")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "2", "--dist", "loadfile", "-rf", str(tmp_path)],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=60)
    took = time.monotonic() - t0
    assert out.returncode == 1, out.stdout + out.stderr
    assert re.search(r"\b1 failed, 3 passed\b", out.stdout), out.stdout
    failed = re.findall(r"^FAILED (\S+)", out.stdout, re.M)
    assert failed == ["test_a.py::test_sleeps"], out.stdout
    assert "TestTimeLimit" in out.stdout
    assert took < 30


@pytest.fixture
def setup_timer():
    return signal.getitimer(signal.ITIMER_REAL)[0]


def test_each_phase_runs_under_the_limit(request, setup_timer):
    seconds = request.config.pluginmanager.get_plugin("phase_limit").seconds
    assert 0 < setup_timer <= seconds
    assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= seconds


def _sleeps(rank, world):
    time.sleep(60)


def test_spawn_under_a_limit_leaves_no_rank(tmp_path):
    code = textwrap.dedent("""
        import multiprocessing, sys
        import torch_dist_ranks as R
        from test_harness_limits import _sleeps
        from time_limit import TestTimeLimit, limit
        try:
            with limit(2):
                R.spawn(_sleeps, 2, sys.argv[1], join=False)
        except TestTimeLimit:
            print("left:", len(multiprocessing.active_children()))
    """)
    t0 = time.monotonic()
    # a rank left alive would also hold up the interpreter's exit, which
    # joins its children
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=_env(), capture_output=True, text=True,
                         timeout=40)
    assert out.returncode == 0, out.stderr
    assert "left: 0" in out.stdout, out.stdout + out.stderr
    assert time.monotonic() - t0 < 30
