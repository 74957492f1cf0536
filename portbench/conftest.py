"""The tiny size of each cell whose runs ``tests/test_portbench_checks.py``
drives but whose size its ``TINY`` table does not hold: that module runs
every cell of ``BENCHMARK.json`` on the CPU, and a cell added beside the
table (a configuration brings new files only) takes the size of the cell
named here.  Each test of a module with a ``TINY`` table sees the entries
for its own run alone, whatever else is collected with it."""

import pytest

# cell -> the cell whose tiny size (field and traffic cuts) it takes
SAME_SIZE = {"siren-act32.nerf-fused": "siren.nerf-fused"}


@pytest.fixture(autouse=True)
def _tiny_sizes(request, monkeypatch):
    table = getattr(request.module, "TINY", None)
    if isinstance(table, dict):
        for cell, like in SAME_SIZE.items():
            if cell not in table and like in table:
                monkeypatch.setitem(table, cell, table[like])
    yield
