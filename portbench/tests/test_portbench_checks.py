"""A run of each cell on the CPU at a size a test can hold, past the look
for a card: a sound run completes with its checks; the fp8 control put in
the program's place, and each fault planted in the timed path, come out
not correct.  On a card (``gpu``): one short run of each cell at its own
size is correct."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import calibrate
from portbench.harness import runner

TINY = {
    "siren.nerf-fused": (dict(n_harmonic_functions=8, n_hidden=48, fused_kernel=True),
                         dict(views_per_half=6, image_size=32, rays_per_image=16, n_pts_coarse=8, n_pts_fine=16,
                              max_steps=50, warmup_extra=1)),
    "siren.pose-train": (dict(n_harmonic_functions=8, n_hidden=48),
                         dict(views=4, image_size=32, batch_size=2, sample_size=16, n_neg=300, max_steps=50,
                              warmup_extra=1)),
    "siren.serve": ({}, dict(views=8, image_size=48, batch=2, n_keys=700, ransac_iters=20, check_share=0.5)),
}
BENCH = json.load(open(os.path.join(runner.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
# each cell as it stands, and the descriptor cells with the MLP key head
# (``siren`` false), the other head the reference carries for a later cell
DRIVEN = [(c, True) for c in CELLS] + [(c, False) for c in CELLS if "pose-train" in c]
SEED = 2**31 + 977


def tiny_cell(name: str, siren: bool = True) -> runner.Cell:
    cell = runner.Cell(name)
    field, params = TINY[name]
    cell.config["field"].update(field, siren=siren)
    if "aug" in cell.traffic["params"]:
        params = {**params, "aug": {**cell.traffic["params"]["aug"], "crop_res": params["image_size"]}}
    cell.traffic["params"].update(params)
    return cell


def faults(name: str) -> list:
    mod, _ = runner.Cell(name).driver(0, "cpu")
    return [(name, f) for f in mod.FAULTS]


@pytest.mark.parametrize("name,siren", DRIVEN)
def test_sound_run_completes(name, siren):
    cell = tiny_cell(name, siren)
    out = runner.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert set(out["checks"]) == set(cell.traffic["limits"]) and list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.parametrize("name,siren", DRIVEN)
def test_control_is_not_correct(name, siren):
    cell = tiny_cell(name, siren)
    got = calibrate.readings(cell, SEED, "control", "cpu")
    limits = cell.traffic["limits"]
    assert any(got[n] > lim for n, lim in limits.items() if n in got), got


@pytest.mark.parametrize("name,fault", [f for c in CELLS for f in faults(c)])
def test_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    mod, _ = cell.driver(0, "cpu")
    undo = mod.FAULTS[fault]()
    try:
        out = runner.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    finally:
        undo()
    assert out["correct"] is False, out["checks"]


def test_run_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=runner.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed", str(SEED), "--seconds",
                          "2", "--trace", "0"], cwd=runner.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
