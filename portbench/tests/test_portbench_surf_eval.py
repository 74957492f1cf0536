"""The SurfEmb cell, ``surfemb.surf-eval``: its entries in BENCHMARK.json,
its configuration and traffic; ``surf_mfu`` and ``k2_roofline_pct``
against hand counts; the plain reference imports nothing of the port; and
on the CPU at a small size, a sound run completes, the control (fp8
maps, bf16 scoring) and each planted fault fail their number."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import calibrate
from portbench.harness import counts, runner, surf_counts

CELL = "surfemb.surf-eval"
BENCH = json.load(open(os.path.join(runner.ROOT, "BENCHMARK.json")))
PUBLISHED = {"down_sample": 3, "max_poses": 10000, "max_pose_evaluations": 1000, "alpha": 1.5, "dist_2d_min": 0.1,
             "max_pool": True, "refine": True, "refine_steps": 50, "n_denom": 10960, "translation_only": False}
# the CPU's size: 48 px crops, 600 keys, 200 hypotheses, 50 scored (the
# published 50 BFGS steps, so that the refinement ends where more steps
# gain nothing); under the float32 cdf the distribution flat (the driver's
# QUERY_GAIN 1), so that a float32 running sum of its 153,600 entries
# moves draws visibly at this size
SMALL = dict(max_poses=200, max_pose_evaluations=50)
SCENE = dict(views=6, image_size=48, n_keys=600, bake_batch=6, check_span=4)
FLAT = {"fault_f32_cdf": 1.0}
SEED = 2**31 + 977
# the number each fault has to fail
FAULT_NUMBERS = {"fault_f32_cdf": "draw", "fault_no_prune": "hyp", "fault_wrong_root": "hyp",
                 "fault_half_scored": "score", "fault_second_best": "start", "fault_no_refine": "refine",
                 "fault_short_bfgs": "refine", "fault_altered_pose": "objective"}
NUMBERS = ("query", "draw", "hyp", "order", "start", "score", "refine", "objective")


def small_cell() -> runner.Cell:
    cell = runner.Cell(CELL)
    cell.config["surfemb"].update(SMALL)
    cell.traffic["params"].update(SCENE)
    return cell


def flat_driver(monkeypatch, gain: float):
    """Cells load their driver with ``QUERY_GAIN`` set to ``gain``."""
    load = runner.load_module

    def load_module(path, name):
        mod = load(path, name)
        if name == "portbench_driver_surf_eval":
            mod.QUERY_GAIN = gain
        return mod
    monkeypatch.setattr(runner, "load_module", load_module)


def test_entries():
    conf = {c["name"]: c for c in BENCH["configs"]}["surfemb"]
    assert conf["file"] == "portbench/configs/surfemb.json" and conf["reduced"] == []
    body = json.load(open(os.path.join(runner.ROOT, conf["file"])))
    assert body["surfemb"] == PUBLISHED
    same = json.load(open(os.path.join(runner.ROOT, "portbench/configs/siren-act32.json")))
    assert body["field"] == same["field"] and body["unet"] == same["unet"]
    cell = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("surfemb", "surf-eval", 1)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["infer_images_per_s"]["workloads"] and CELL not in e2e["infer_batch_p95_ms"]["workloads"]
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ("surf_mfu", "device_idle_pct.surf", "k2_roofline_pct"):
        assert layer[name]["workloads"] == [CELL] and layer[name]["moves"] == "infer_images_per_s"
    tr = runner.Cell(CELL).traffic
    assert tr["driver"] == "surf_eval" and tuple(tr["limits"]) == NUMBERS
    p = tr["params"]
    assert (p["views"], p["image_size"], p["n_keys"], p["warmup_requests"], p["max_requests"], p["trace_steps"]) == (
        32, 224, 80000, 2, 100000, 4)


def test_surf_mfu_against_a_hand_count():
    cell = runner.Cell(CELL)
    unet = sum(counts.unet_conv_flops(cell.config["unet"], 1, 224))
    by_hand = {"distribution": 2 * 5476 * 80000 * 12, "score": 24 * 1000 * 80000,
               "denominator": 2 * 50176 * 10960 * 12, "objective": (50 * 15 + 3) * 50176 * (24 + 8 * 13 + 24)}
    got = surf_counts.image_flops(cell.config, cell.traffic["params"])
    assert got == {"unet": unet, **by_hand}
    reader = runner.load_module(runner.metric_path("surf_mfu"), "surf_mfu_test")
    ctx = {"steps": 4, "window_s": 2.0, "config": cell.config, "traffic": cell.traffic["params"]}
    assert reader.read(ctx) == pytest.approx(100.0 * 4 * (unet + sum(by_hand.values())) / (2.0 * 989e12), rel=1e-12)
    assert reader.read({**ctx, "steps": 0}) is None


def test_k2_roofline_reads_nothing_without_its_kernels():
    cell = runner.Cell(CELL)
    reader = runner.load_module(runner.metric_path("k2_roofline_pct"), "k2_roofline_test")
    ctx = {"steps": 3, "kernels": {"corr_argmax_kernel": 1e-3}, "traffic": cell.traffic["params"]}
    assert reader.read(ctx) is None
    least = 9 * 50176 * 80000 / (132 * 128 * 1.98e9)
    ctx["kernels"] = {"nn_min_kernel": 4e-3, "nn_min_merge_kernel": 1e-3}
    assert reader.read(ctx) == pytest.approx(100.0 * 3 * least / 5e-3, rel=1e-12)


def test_reference_loads_neither_jax_nor_the_port():
    code = ("import json, sys; sys.path.insert(0, %r); import portbench.reference.surfemb; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % runner.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    jax_package = "imagesequenceregistrationfor6dposeestimationlabeling_tpu"
    assert not tops & {"jax", "jaxlib", "flax", jax_package, jax_package + "_torch"}


def test_sound_run_is_correct():
    cell = small_cell()
    out = runner.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert list(out)[-1] == "checks" and tuple(out["checks"]) == NUMBERS
    assert out["attempted"] > 0 and out["failed"] == 0 and "infer_images_per_s" in out["metrics"]
    assert out["correct"] is True, out["checks"]


def test_control_is_not_correct():
    cell = small_cell()
    got = calibrate.readings(cell, SEED, "control", "cpu")
    for number in ("query", "score"):
        assert got[number] > cell.traffic["limits"][number], got


@pytest.mark.parametrize("fault", sorted(FAULT_NUMBERS))
def test_fault_fails_its_number(fault, monkeypatch):
    if fault in FLAT:
        flat_driver(monkeypatch, FLAT[fault])
    cell = small_cell()
    got = calibrate.readings(cell, SEED, fault, "cpu")
    number = FAULT_NUMBERS[fault]
    assert got[number] > cell.traffic["limits"][number], got
