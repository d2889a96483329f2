"""The plain reference agrees with the port at small sizes on the CPU
(where the port's kernel wrappers run their plain versions, in fp32): each
cell's whole run, the port driven by its own entry points, comes out
correct with every compared number under a tenth of its limit.  The two
are written apart, so they agree to rounding, not bit for bit."""
import pytest

from benchmark.run import run
from benchmark import harness
from benchmark.tests.conftest import SMALL, cpu_context


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_reference_agrees_with_the_port(cell):
    line = run(cpu_context(cell, overrides=SMALL[cell]), harness.manifest())
    assert line["correct"]
    assert all(v < 0.1 * lim for _, v, lim in line["checks"]), line["checks"]
    assert line["attempted"] >= 1
