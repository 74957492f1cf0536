"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import os
import re

import pytest

from portbench.harness import runner

ROOT = runner.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and not any(".." in w or w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    lines = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    lines += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(1 <= len(s) <= 200 and "\n" not in s and "\t" not in s for s in lines)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"]), cell


def test_each_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = runner.Cell(cell)
    assert os.path.isfile(c.driver_path)
    assert all(os.path.isfile(p) for p in c.metric_paths.values())
    assert set(c.traffic) == {"driver", "params", "limits"}
    for conf in BENCH["configs"]:
        assert conf["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, conf["file"]))
    mod, drv = c.driver(0, "cpu")
    assert callable(mod.calibration) and hasattr(drv, "check")


def test_config_files_hold_what_the_configs_say():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["name"] == c["name"] and body["source"] == c["source"]
