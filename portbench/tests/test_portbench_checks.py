"""A run of each cell on the CPU at a size a test can hold, past the look
for a card: a sound run completes with its checks; the fp8 control put in
the program's place, and each fault planted in the timed path, come out
not correct.  The NeRF cell's step is also driven in chunks, on both of
the chunked step's paths: K5 / K6 (their plain twins here) and the field's
own colour path.  On a card (``gpu``): one short run of each cell at its
own size is correct."""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import calibrate
from portbench.harness import runner
from portbench.reference import nerf as ref_nerf

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
NERF = "siren.nerf-fused"
# the NeRF cell's step in chunks: 48 rays a half in chunks of 20, 20 and 8,
# through K5 / K6 (their plain twins here) or through the field's own
# colour path, which a field the kernels do not take runs
CHUNKED = dict(cams_per_step=3, ray_chunk=20)
PATHS = {"k5k6": True, "plain": False}
# each cell as it stands; the descriptor cells with the MLP key head
# (``siren`` false), the other head the reference carries for a later cell;
# and the NeRF cell's chunked step on both of its paths
DRIVEN = ([pytest.param(c, True, None, id=f"{c}-True") for c in CELLS]
          + [pytest.param(c, False, None, id=f"{c}-False") for c in CELLS if "pose-train" in c]
          + [pytest.param(NERF, True, p, id=f"{NERF}-chunked-{p}") for p in PATHS])
SEED = 2**31 + 977
# the numbers a NeRF fault has to fail: a training number, not ``depth``
FAULT_NUMBERS = {"fault_half_batch": ("loss", "grad"), "fault_unchanged": ("change",)}


def tiny_cell(name: str, siren: bool = True, path: str | None = None) -> runner.Cell:
    cell = runner.Cell(name)
    field, params = TINY[name]
    cell.config["field"].update(field, siren=siren)
    if "aug" in cell.traffic["params"]:
        params = {**params, "aug": {**cell.traffic["params"]["aug"], "crop_res": params["image_size"]}}
    cell.traffic["params"].update(params)
    if path is not None:
        cell.traffic["params"].update(CHUNKED)
        cell.config["field"]["fused_kernel"] = PATHS[path]
    return cell


def faults(name: str) -> list:
    mod, _ = runner.Cell(name).driver(0, "cpu")
    return [(name, f) for f in mod.FAULTS]


@pytest.mark.parametrize("name,siren,path", DRIVEN)
def test_sound_run_completes(name, siren, path):
    cell = tiny_cell(name, siren, path)
    out = runner.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert set(out["checks"]) == set(cell.traffic["limits"]) and list(out)[-1] == "checks"
    assert all(math.isfinite(c["value"]) for c in out["checks"].values()), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.parametrize("name,siren,path", DRIVEN)
def test_control_is_not_correct(name, siren, path):
    cell = tiny_cell(name, siren, path)
    got = calibrate.readings(cell, SEED, "control", "cpu")
    limits = cell.traffic["limits"]
    assert any(got[n] > lim for n, lim in limits.items() if n in got), got


@pytest.mark.parametrize("name,path,fault",
                         [pytest.param(c, None, f, id=f"{c}-{f}") for c in CELLS for _, f in faults(c)]
                         + [pytest.param(NERF, p, f, id=f"{NERF}-chunked-{p}-{f}") for p in PATHS
                            for _, f in faults(NERF)])
def test_fault_is_not_correct(name, path, fault):
    cell = tiny_cell(name, path=path)
    mod, _ = cell.driver(0, "cpu")
    undo = mod.FAULTS[fault]()
    try:
        out = runner.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    finally:
        undo()
    assert out["correct"] is False, out["checks"]
    if cell.traffic["driver"] == "nerf_train":
        got = {n: c["value"] for n, c in out["checks"].items()}
        assert any(got[n] > cell.traffic["limits"][n] for n in FAULT_NUMBERS[fault]), got


def set_up(cell: runner.Cell):
    _, drv = cell.driver(SEED, "cpu")
    drv.setup()
    return drv


def test_chunked_depths_join_as_one_chunk():
    """The first checked step's fine depths, resampled a chunk at a time
    and joined, against one chunk of every ray on the same draws."""
    cell = tiny_cell(NERF, path="plain")
    p = cell.traffic["params"]
    many = set_up(cell).checked["depths"][0]
    cell.traffic["params"] = {**p, "ray_chunk": p["cams_per_step"] * p["rays_per_image"]}
    one = set_up(cell).checked["depths"][0]
    for a, b in zip(many, one):
        assert a is not None and a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5


def test_reference_blocks_give_the_one_block_step(monkeypatch):
    """The reference's first step in blocks of 20 rays a half (the chunked
    step's ``ray_chunk``) against one block of every ray: the same losses
    and own fine depths but for the order of the sums; grads whose leaf
    norms part by at most twice bf16's half ulp, 2^-8, since each block's
    weight grads are rounded to bf16 before they are summed."""
    from portbench.harness import compare

    drv = set_up(tiny_cell(NERF, path="k5k6"))
    blocks = drv._reference("bfloat16", None)
    monkeypatch.delitem(drv.tr, "ray_chunk")
    monkeypatch.setattr(ref_nerf, "BLOCK", 10**6)
    whole = drv._reference("bfloat16", None)
    assert torch.allclose(blocks["losses"][0], whole["losses"][0], rtol=1e-5, atol=0)
    assert compare.worst_leaf_gap(blocks["grads"], whole["grads"])[0] <= 2.0**-8
    for a, b in zip(blocks["depths"][0], whole["depths"][0]):
        assert float((a - b).abs().max()) <= 1e-5


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
