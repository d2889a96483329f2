"""The control, the plain reference computed with float8 products in the
port's place, comes out not correct against the fp32 reference at each
cell's limits (here at a small size on the CPU; its readings at the cells'
own sizes on the card are in PERF.md)."""
import pytest

from benchmark import harness
from benchmark.tests.conftest import SMALL, cpu_context


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    ctx = cpu_context(cell, overrides=SMALL[cell])
    out = harness.driver(ctx.cell["driver"]).control(ctx)
    checks = out["float8"]
    assert any(not v <= lim for _, v, lim in checks), checks
