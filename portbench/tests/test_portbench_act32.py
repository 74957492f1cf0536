"""The configuration ``siren-act32``, its traffic ``nerf-fused-act32``,
its driver's number ``act`` (``drivers/nerf_train_act32.py``) and the
metric ``k4_act32_roofline_pct``.

The runs of every cell at a size a test can hold are
``test_portbench_checks.py``'s, parametrised over the cells of
``BENCHMARK.json``; the cell added here takes ``siren.nerf-fused``'s size
there (``portbench/conftest.py``)."""

import json
import math
import os

import pytest
import torch

from portbench import calibrate
from portbench.harness import counts, runner

CELL = "siren-act32.nerf-fused"
# the cell cut as test_portbench_checks.py cuts siren.nerf-fused
TINY = (dict(n_harmonic_functions=8, n_hidden=48, fused_kernel=True),
        dict(views_per_half=6, image_size=32, rays_per_image=16, n_pts_coarse=8, n_pts_fine=16, max_steps=50,
             warmup_extra=1))
SEEDS = (2**31 + 977, 5, 1234567)

ROOT = runner.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _json(path):
    return json.load(open(os.path.join(ROOT, "portbench", path)))


def test_config_is_siren_at_float32_activations_as_field_config_defaults():
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig

    base, act = _json("configs/siren.json"), _json("configs/siren-act32.json")
    assert act["field"] == {**base["field"], "act_dtype": "float32"} and act["unet"] == base["unet"]
    entry = {c["name"]: c for c in BENCH["configs"]}["siren-act32"]
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/siren-act32.json"
    default = FieldConfig()
    assert all(getattr(default, k) == v for k, v in act["field"].items())


def test_traffic_is_nerf_fused_with_its_own_limits():
    fused, act = _json("traffic/nerf-fused.json"), _json("traffic/nerf-fused-act32.json")
    assert fused["driver"] == "nerf_train" and act["driver"] == "nerf_train_act32"
    assert act["params"] == fused["params"]
    assert set(act["limits"]) == set(fused["limits"]) | {"act"}
    cell = runner.Cell(CELL)
    assert cell.config["field"]["act_dtype"] == "float32"
    assert [m["name"] for m in cell.per_layer] == ["nerf_step_mfu", "device_idle_pct.nerf", "k4_act32_roofline_pct"]


def _ctx(kernels: dict) -> dict:
    cell = runner.Cell(CELL)
    return {"steps": 40, "kernels": kernels, "config": cell.config, "traffic": cell.traffic["params"]}


def test_k4_act32_roofline_reads_the_variant_alone():
    act = runner.load_module(runner.metric_path("k4_act32_roofline_pct"), "test_k4_act32")
    bf16 = runner.load_module(runner.metric_path("k4_roofline_pct"), "test_k4_bf16")
    t = {"dw_kernel": 0.1, "sum_slices": 0.001}
    got = act.read(_ctx({"bundle_loss_act32_kernel": 0.6, **t}))
    # the same least time as K4's, over the variant's kernels
    assert got == pytest.approx(bf16.read(_ctx({"bundle_loss_kernel": 0.6, **t})))
    s = counts.nerf_shapes(_ctx({})["traffic"])
    E, nh = counts.field_dims(_ctx({})["config"]["field"])
    n_bytes = sum(counts.k4_pass(s["H"], s["R"], P, E, nh, w)[0] for P, w in ((s["Pc"], True), (s["Pf"], False)))
    n_ops = sum(counts.k4_pass(s["H"], s["R"], P, E, nh, w)[1] for P, w in ((s["Pc"], True), (s["Pf"], False)))
    assert got == pytest.approx(100.0 * 40 * counts.bound_s(n_bytes, n_ops, counts.BF16_FLOPS) / 0.701)
    assert 0 < got < 100
    # nothing where the variant did not run, or where the bf16 K4 ran beside it
    assert act.read(_ctx(t)) is None
    assert act.read(_ctx({"bundle_loss_kernel": 0.6, **t})) is None
    assert act.read(_ctx({"bundle_loss_act32_kernel": 0.6, "bundle_loss_kernel": 0.6, **t})) is None
    # and K4's own roofline reads nothing of the variant's
    assert bf16.read(_ctx({"bundle_loss_act32_kernel": 0.6})) is None


def _tiny(plain: bool = False) -> runner.Cell:
    cell = runner.Cell(CELL)
    field, params = TINY
    cell.config["field"].update(field, fused_kernel=not plain)
    cell.traffic["params"].update(params)
    return cell


def test_probe_field_holds_one_activation_per_unit():
    """The probe field's forward through the plain reference at the
    configuration's precision: every point of a ray holds the same
    density and colour, the density at the probe's alpha, and the trunk's
    h2 lies off bf16's grid at most units (what the bf16 storage would
    round)."""
    from portbench.reference.field import Field
    from portbench.reference.precision import Precision

    mod, drv = _tiny().driver(SEEDS[0], "cpu")
    drv.setup()
    fc, p = drv.cfg["field"], drv.probe_init[0]["coarse"]
    field = Field(fc, p, Precision("bfloat16"), Precision("float32"))
    pts = torch.randn((5, 7, 3))
    dens, rgb = field.forward(pts, torch.randn((5, 3)))
    assert torch.allclose(dens, torch.full_like(dens, mod.PROBE_ALPHA), rtol=1e-5, atol=0)
    assert torch.allclose(rgb, rgb[:1, :1].expand_as(rgb), rtol=1e-6, atol=0)
    h2 = field.trunk(pts)
    assert torch.allclose(h2, h2[:1, :1].expand_as(h2), rtol=1e-6, atol=0)
    assert float((h2 != h2.to(torch.bfloat16).float()).float().mean()) > 0.9


def test_act_tells_float32_storage_from_bf16():
    """``act`` on the CPU at the tiny size: K4's float32 twin and the
    field's own colour path (the parent's path for this field) read far
    under the limit; the bf16-activation K4 (``fault_bf16_acts``) and the
    reference with its activations stored in bf16 (the control) far over
    it, on every seed."""
    limit = _json("traffic/nerf-fused-act32.json")["limits"]["act"]
    for seed in SEEDS:
        sound = [calibrate.readings(_tiny(plain), seed, "program", "cpu")["act"] for plain in (False, True)]
        lower = [calibrate.readings(_tiny(), seed, mode, "cpu")["act"] for mode in ("fault_bf16_acts", "control")]
        assert max(sound) < limit / 3 and min(lower) > 3 * limit, (seed, sound, lower)
        assert all(math.isfinite(v) for v in sound + lower)
