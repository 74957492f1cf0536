"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repo.  Tests marked ``gpu`` need a CUDA card and skip
without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips (with its reason) where torch.cuda is unavailable")
