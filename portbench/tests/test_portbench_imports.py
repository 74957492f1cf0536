"""What importing the harness and the references loads: never JAX nor the
JAX package (top-level names compared whole: the port's name begins with
the JAX package's), and for the references nothing of the port either."""

import json
import os
import subprocess
import sys

from portbench.harness import runner

JAX_PACKAGE = "imagesequenceregistrationfor6dposeestimationlabeling_tpu"
PORT = JAX_PACKAGE + "_torch"

LOAD_ALL = """
import glob, json, os, sys
sys.path.insert(0, {root!r})
import portbench.run, portbench.calibrate
from portbench.harness import runner
for i, p in enumerate(sorted(glob.glob(os.path.join({root!r}, "portbench", "drivers", "*.py"))
                      + glob.glob(os.path.join({root!r}, "portbench", "metrics", "*.py")))):
    runner.load_module(p, "m%d" % i)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.field, portbench.reference.nerf, portbench.reference.pose
import portbench.reference.pnp, portbench.reference.unet, portbench.reference.adam, portbench.reference.precision
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=runner.ROOT)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _tops(LOAD_ALL)
    assert not tops & {"jax", "jaxlib", "flax", JAX_PACKAGE}


def test_reference_loads_neither_jax_nor_the_port():
    tops = _tops(LOAD_REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", JAX_PACKAGE, PORT}


def test_forbidden_names_compare_whole(monkeypatch):
    before = runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, PORT + ".models", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert runner.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, JAX_PACKAGE + ".config", object())
    assert JAX_PACKAGE in runner.forbidden_modules()
