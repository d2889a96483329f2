"""A run prints no result and exits non-zero without the cards its cell
asks for, and in a directory that holds only the manifest and the
benchmark's files; on a card, a short run of a cell is correct."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


def run_py(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          capture_output=True, text=True, cwd=cwd,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "",
                               "CUDA_VISIBLE_DEVICES": ""}, timeout=300)


ARGS = ("--workload", "hrda_star.slide_1080p", "--seed", "3000000007",
        "--seconds", "1", "--trace", "0")


def test_no_card_no_result():
    out = run_py(ROOT, *ARGS)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path, *ARGS)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py",
                          "--workload", "hrda_star.slide_1080p", "--seed",
                          "3000000008", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
