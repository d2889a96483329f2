"""Neither the harness, a driver nor the reference loads JAX or the JAX
package; the reference loads nothing of the port.  Each in a fresh
process, top-level module names compared whole."""
import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import {mod}
print(json.dumps(sorted(m for m in sys.modules)))
"""


def loaded(mod):
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=ROOT, mod=mod)],
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""},
                         cwd=ROOT)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


@pytest.mark.parametrize("mod", ["benchmark.run", "benchmark.harness",
                                 "benchmark.drivers.uda_step",
                                 "benchmark.drivers.align_step",
                                 "benchmark.drivers.slide_infer"])
def test_no_jax(mod):
    top = loaded(mod)
    assert not top & {"jax", "jaxlib", "flax", "optax", "refign_tpu"}


def test_reference_imports_nothing_of_the_port():
    top = loaded("benchmark.reference.build")
    assert not top & {"jax", "jaxlib", "flax", "optax", "refign_tpu",
                      "refign_tpu_torch"}
