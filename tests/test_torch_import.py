"""The port imports torch and never jax, nor any module of the JAX package,
and builds nothing at import."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import native
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build
ref = "imagesequenceregistrationfor6dposeestimationlabeling_tpu"
loaded = [m for m in sys.modules if m.split(".")[0] == ref]
new = {port.__name__ + "." + m for m in ("cli", "utils.viz", "data.bop", "data.mesh_scene", "data.scene_cache",
                                         "ops.rasterize", "pipeline.pose_est_surf", "pipeline.pose_refine",
                                         "utils.profiling", "parallel.mesh")}
print(len(names), new <= set(names), "jax" in sys.modules, "flax" in sys.modules, cuda_build.kernels.cache_info().currsize,
      native._TRIED, len(loaded))
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout.split()
    n_modules, has_cli, jax_loaded, flax_loaded, built, native_tried, n_ref = out
    assert int(n_modules) >= 20 and has_cli == "True"  # the CLI and its helpers are among them
    assert jax_loaded == "False" and flax_loaded == "False"
    assert n_ref == "0"  # no module of the JAX package, not even a jax-free one
    assert built == "0" and native_tried == "False"  # no kernel or library build at import
