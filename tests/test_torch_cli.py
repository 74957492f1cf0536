"""The port's command-line interface against the JAX package's, on the CPU
(``--device cpu``; the kernels take their plain versions, the reference's
Pallas kernels their CPU paths).

Where a command draws its data, both CLIs get the same numpy scene: each
CLI's ``load_data`` is replaced by one that hands in the reference's
synthetic scene of that half.  Where a command draws random numbers, the
port is handed the reference's draws (the surface-hit samples of
``gen-feat``, the CAD sample of ``icp``).

Tolerances, each stated where it is used: relative poses to 1e-6; the
agreement matrix, the top-50 list and the best verified image equal; the
ICP summary's transform to 1e-4, its fitness to 1e-3, its RMSE and Chamfer
to 1e-3 of the CAD scale (``_compare_icp``); the correspondence artifacts with the bars of
``tests/test_torch_cors.py`` (a ray or point may differ only where its
cause sits at a threshold: a density within the field's tolerance of the
pass's threshold, a mesh distance within 1e-5 of the filter's).
"""

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu import cli as jcli
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry.rotations import rotvec_to_matrix
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import artifacts as jart
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import checkpoint as jckpt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import cli as tcli
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import config as tconfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic as tsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as tcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as tpc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as tmesh
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import surface_sampling as tss
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer as trend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint as tckpt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer as tnt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import generate_cors as tgc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference as tinf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ parser


def _subparsers(parser):
    return next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction)).choices


def _flags(sub):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, type(a).__name__)
            for a in sub._actions if a.dest != "help"}


@pytest.mark.parametrize("cmd", sorted(_subparsers(jcli.build_parser())))
def test_parser_matches_reference(cmd):
    """Every flag of the reference's command, with its default, type and
    choices; the port adds ``--device`` (default cuda) and nothing else."""
    want = _flags(_subparsers(jcli.build_parser())[cmd])
    got = _flags(_subparsers(tcli.build_parser())[cmd])
    assert got.pop("device")[:2] == (("--device",), "cuda")
    assert got.keys() == want.keys()
    for dest in want:
        assert got[dest][:4] == want[dest][:4] and got[dest][4] == want[dest][4], dest


def test_module_entry_point_lists_every_command():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.cli",
                          "--help"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120, check=True).stdout
    for cmd in _subparsers(jcli.build_parser()):
        assert cmd in out, cmd


def test_commands_default_to_the_card(tmp_path, monkeypatch):
    """Without --device a command runs on the card and raises on a host
    with none; with ``--device cpu`` the SurfEmb, full-frame and mesh-scene
    paths run: ``train-nerf --synthetic-mesh`` (one step), ``poses-est
    --use-surf-eval`` and ``inference --full-frames`` on fabricated keys and
    a fresh ResNetUNet checkpoint."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--root", str(tmp_path), "--synthetic", "--image-size", "16"]
    for cmd in _subparsers(tcli.build_parser()):
        for device in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tcli.main([cmd, *base, *device])
    assert not os.listdir(tmp_path)
    monkeypatch.setattr(tnt, "extract_point_cloud", functools.partial(tnt.extract_point_cloud, grid_res=16))
    small = ["--objid", "1", "--dataset", "tless", "--UH", "0", "--device", "cpu", "--log-every", "0", "--viz-every",
             "0", "--image-size", "24"]
    tcli.main(["train-nerf", *small, "--root", str(tmp_path / "mesh"), "--synthetic-mesh", "--synthetic-views", "2",
               "--field-preset", "small", "--steps", "1"])
    assert os.path.exists(jart.nerf_dir(str(tmp_path / "mesh" / "0_tless_obj_1"), 1))
    root, bop_root, _ = _nocs_experiment(tmp_path, with_unet=True)
    tcli.main(["poses-est", *small, "--root", root, "--synthetic", "--synthetic-views", "2", "--use-surf-eval"])
    pred_R = np.load(os.path.join(root, "0_tless_obj_1", "1pred_R.npy"))
    assert pred_R.shape == (2, 3, 3) and np.isfinite(pred_R).all()
    tcli.main(["inference", *small, "--root", root, "--bop-root", bop_root, "--full-frames", "--fsamps", "1"])
    assert os.path.exists(os.path.join(root, "0_tless_obj_1", "1correctly_predicted_list.txt"))


# ------------------------------------------------------------ shared scenes


@functools.lru_cache(maxsize=None)
def _scene(uh: int, size: int, views: int = 8):
    """The reference's synthetic half ``uh`` as its loader returns it."""
    sc = jsyn.make_scene(n_views=views, image_size=size, key=jax.random.PRNGKey(uh))
    d = sc.diameter
    return (np.asarray(sc.images), np.asarray(sc.sils), np.asarray(sc.R_bop), np.asarray(sc.t_bop) * (d / 1.8),
            np.asarray(sc.K), d)


def _fake_load_data(args, image_size):
    return _scene(int(args.UH), int(image_size), int(args.synthetic_views))


@pytest.fixture
def reference_cad(monkeypatch):
    """The port's ``icp --synthetic`` samples the reference's analytic CAD
    points (the draws of PRNGKey(9))."""
    orig = tsyn.analytic_surface_points

    def reference_draws(n, generator=None, which=None, dirs=None, device=None):
        k1, k2 = jax.random.split(jax.random.PRNGKey(9))
        return orig(n, which=np.asarray(jax.random.randint(k1, (n,), 0, 4)),
                    dirs=np.asarray(jax.random.normal(k2, (n, 3))), device=device)

    monkeypatch.setattr(tsyn, "analytic_surface_points", reference_draws)


@pytest.fixture
def same_scene(monkeypatch, reference_cad):
    """Both CLIs load the reference's scene of each half."""
    monkeypatch.setattr(jcli, "load_data", _fake_load_data)
    monkeypatch.setattr(tcli, "load_data", _fake_load_data)


def _base(root, uh=0, port=False, extra=()):
    argv = ["--objid", "1", "--dataset", "ruapc", "--UH", str(uh), "--root", str(root), "--synthetic",
            "--log-every", "0", *extra]
    return argv + (["--device", "cpu"] if port else [])


# ----------------------------------------------------------- finale commands


def _fabricate(root):
    """The registration finale's inputs for both halves: baked keys on the
    analytic surface and predicted poses of half 0 = the other half's GT,
    five with a little noise, three far off."""
    rng = np.random.default_rng(0)
    pts, ok = jsyn.analytic_surface_points(4000, jax.random.PRNGKey(1))
    _, _, R_gt, t_gt, _, diam = _scene(1, 64)
    scale = diam / 1.8
    verts = np.asarray(pts)[np.asarray(ok)] * scale
    for uh in (0, 1):
        pose_d = jart.pose_dir(os.path.join(root, f"{uh}_ruapc_obj_1"), 1)
        half = verts[verts[:, 2] < 2] if uh == 0 else verts[verts[:, 2] > -2]
        jart.save_array(pose_d, "vert1_scaled.npy", half)
        jart.save_array(pose_d, "feat1_scaled.npy", np.zeros((half.shape[0], 12), np.float32))
    exp0 = os.path.join(root, "0_ruapc_obj_1")
    noise = [0.01] * 5 + [0.5] * 3
    dR = np.stack([np.asarray(rotvec_to_matrix(jnp.asarray(rng.normal(size=3) * s))) for s in noise])
    np.save(os.path.join(exp0, "1pred_R.npy"), np.einsum("nij,njk->nik", dR, R_gt))
    np.save(os.path.join(exp0, "1pred_t.npy"), t_gt + rng.normal(size=(8, 3)) * np.array(noise)[:, None] * scale)
    return scale


def _last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def _best_verified(text: str) -> int:
    return int([ln for ln in text.splitlines() if ln.startswith("best image ")][-1].split()[2].rstrip(","))


def _finale(root, cli_mod, port, icp_threshold, capsys, extra=()):
    base = _base(root, port=port, extra=extra)
    cli_mod.main(["rel-poses", *base, "--cal-gt", "--cal-pred"])
    cli_mod.main(["choose-image", *base])
    capsys.readouterr()
    cli_mod.main(["icp", *base, "--icp-threshold", str(icp_threshold)])
    icp = _last_json(capsys.readouterr().out)
    cli_mod.main(["verify", *base])
    return icp, _best_verified(capsys.readouterr().out)


def _compare_finale(jroot, troot, jout, tout, scale):
    exp_j, exp_t = os.path.join(jroot, "0_ruapc_obj_1"), os.path.join(troot, "0_ruapc_obj_1")
    for tag in ("gt", "pred"):
        a = np.load(os.path.join(exp_j, f"1{tag}_relative_poses.npy"))
        b = np.load(os.path.join(exp_t, f"1{tag}_relative_poses.npy"))
        np.testing.assert_allclose(b, a, atol=1e-6, err_msg=tag)
    np.testing.assert_array_equal(np.load(os.path.join(exp_t, "1error.npy")),
                                  np.load(os.path.join(exp_j, "1error.npy")))
    with open(os.path.join(exp_j, "1top_50_choices.txt")) as fj, open(os.path.join(exp_t, "1top_50_choices.txt")) as ft:
        assert ft.read() == fj.read()
    (icp_j, best_j), (icp_t, best_t) = jout, tout
    _compare_icp(icp_j, icp_t, scale)
    assert best_t == best_j


def _compare_icp(icp_j, icp_t, scale):
    """The transform to 1e-4; the fitness to 1e-3; the RMSE and the Chamfer
    distance to 1e-3 of the CAD scale: the reference's CPU neighbour
    distances come from |a|^2 + |b|^2 - 2 a.b, whose f32 rounding leaves a
    floor of ~1e-4 where points coincide, the port's from exact
    differences."""
    np.testing.assert_allclose(icp_t["R"], icp_j["R"], atol=1e-4)
    np.testing.assert_allclose(icp_t["t"], icp_j["t"], atol=1e-4)
    assert abs(icp_t["fitness"] - icp_j["fitness"]) <= 1e-3
    for k in ("inlier_rmse", "chamfer"):
        assert abs(icp_t[k] - icp_j[k]) <= 1e-3 * scale, k
    assert icp_t["correct"] == icp_j["correct"]


def test_finale_commands_match_reference(tmp_path, same_scene, capsys):
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    scale = _fabricate(str(jroot))
    shutil.copytree(jroot, troot)
    jout = _finale(jroot, jcli, False, 0.2 * scale, capsys)
    tout = _finale(troot, tcli, True, 0.2 * scale, capsys)
    agree = np.load(os.path.join(troot, "0_ruapc_obj_1", "1error.npy"))
    assert 0 < agree.sum() < agree.size  # some pairs agree, some do not
    _compare_finale(jroot, troot, jout, tout, scale)


def test_choose_image_on_an_auto_mesh(tmp_path, same_scene, monkeypatch, capsys):
    """``choose-image`` calls ``auto_mesh()``, as the reference's does: with
    it patched to a 2-entry CPU mesh (the reference's own test of its
    default patches its ``auto_mesh`` alike) the pairs split over the mesh
    and ``error.npy`` is the one the unsharded run writes, and the
    reference's on its 8-device auto mesh."""
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    _fabricate(str(jroot))
    shutil.copytree(jroot, troot)
    base = _base(troot, port=True)
    tcli.main(["rel-poses", *base, "--cal-gt", "--cal-pred"])
    tcli.main(["choose-image", *base])
    exp = os.path.join(troot, "0_ruapc_obj_1")
    unsharded = np.load(os.path.join(exp, "1error.npy"))
    seen = []
    monkeypatch.setattr(tmesh, "auto_mesh", lambda *a, **kw: seen.append(kw) or tmesh.Mesh(["cpu"] * 2))
    os.remove(os.path.join(exp, "1error.npy"))
    tcli.main(["choose-image", *base])
    assert seen == [{"device": torch.device("cpu")}]
    np.testing.assert_array_equal(np.load(os.path.join(exp, "1error.npy")), unsharded)
    jbase = _base(jroot)
    jcli.main(["rel-poses", *jbase, "--cal-gt", "--cal-pred"])
    jcli.main(["choose-image", *jbase])
    capsys.readouterr()
    np.testing.assert_array_equal(np.load(os.path.join(jroot, "0_ruapc_obj_1", "1error.npy")), unsharded)


# ------------------------------------------ correspondences and the bake


def _pixels(xys, S):
    col = np.rint((1.0 - xys[:, 0]) * S / 2.0 - 0.5).astype(np.int64)
    row = np.rint((1.0 - xys[:, 1]) * S / 2.0 - 0.5).astype(np.int64)
    return row * S + col


def _near_threshold(field, cors, cfg, uh, view, pix, tol):
    """Per pixel of ``view``: does a cause of a flip sit at its threshold (a
    front or back sample's density within ``tol`` of the pass's threshold,
    a front or back hit within 1e-5 of the mesh filter's distance)?"""
    _, _, R, t, K, diam = _scene(uh, cfg.render_size)
    t = t / (diam / 1.8)
    S, P = cfg.render_size, cfg.grid_pts_per_ray
    z = np.abs(t[:, 2])
    lo, hi = float(z.min() - 2.0), float(z.max() + 2.0)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    a1 = f32(jart.load_array(cors, "a1.npy"))
    cam = tcam.camera_from_bop(f32(R), f32(t), f32(K), S)[view]
    pt = torch.as_tensor(np.asarray(pix))
    out = tgc.view_surface_hits(field, cam, pt, a1, S, P, lo, hi, cfg.density_threshold, cfg.mesh_filter_dist,
                                cfg.back_len_div)
    front = tcam.rays_at_pixels(cam, pt, S, P, lo, hi)
    back = trend.back_ray_bundle(front, out["pos_vec"], cfg.back_len_div)
    with torch.no_grad():
        df = field.density(tcam.ray_points(front))[..., 0]
        db = field.density(tcam.ray_points(back))[..., 0]
    near = ((df - cfg.density_threshold).abs() < tol).any(-1) | ((db - 0.05).abs() < tol).any(-1)
    for hits in (out["pos_vec"], out["back_vec"]):
        d, _ = tpc.nn_query(hits, a1)
        near |= (d - cfg.mesh_filter_dist).abs() < 1e-5
    return near.numpy()


def _matched_rows(got, want, atol, max_moved=4):
    """The row of ``want`` each row of ``got`` is within ``atol`` of, one to
    one: FPS picks the same points in the same order but where two of its
    selections tie within the clouds' agreement (then they swap places)."""
    match = np.abs(got[:, None] - want[None]).max(-1).argmin(1)
    assert np.array_equal(np.sort(match), np.arange(want.shape[0]))
    assert (match != np.arange(want.shape[0])).sum() <= max_moved
    np.testing.assert_allclose(got, want[match], atol=atol)
    return match


def _compare_cors(jroot, troot, field, cfg, uh, tol, a1_atol):
    exp = f"{uh}_ruapc_obj_1"
    jdir, tdir = jart.cors_dir(os.path.join(jroot, exp), 1), jart.cors_dir(os.path.join(troot, exp), 1)
    a, b = jart.load_array(jdir, "a1.npy"), jart.load_array(tdir, "a1.npy")
    assert a.shape == b.shape and a.shape[0] >= 100
    np.testing.assert_allclose(b, a, atol=a1_atol)
    match = _matched_rows(jart.load_array(tdir, "subvert1.npy"), jart.load_array(jdir, "subvert1.npy"), a1_atol)
    nj, nt = jart.load_array(jdir, "subnormal1.npy"), jart.load_array(tdir, "subnormal1.npy")
    assert ((nj[match] * nt).sum(-1) > 0.99).mean() > 0.95
    S, kept = cfg.render_size, 0
    for v in range(8):
        xj, pj, bxj, bj = jart.load_view_rays(jdir, S, v)
        xt, pt, bxt, bt = jart.load_view_rays(tdir, S, v)
        flips = set()
        for (xa, ha), (xb, hb) in (((xj, pj), (xt, pt)), ((bxj, bj), (bxt, bt))):
            ra, rb = dict(zip(_pixels(xa, S), ha)), dict(zip(_pixels(xb, S), hb))
            flips |= (set(ra) ^ set(rb)) | {p for p in set(ra) & set(rb) if np.abs(ra[p] - rb[p]).max() > 1e-5}
            kept += len(set(ra) & set(rb))
        if flips:
            assert _near_threshold(field, tdir, cfg, uh, v, sorted(flips), tol).all(), (v, sorted(flips))
    assert kept > 100


def _cli_cors_cfg(analytic: bool):
    """CorsConfig of ``generate-cors --image-size 40``."""
    return tconfig.CorsConfig(render_size=40, grid_pts_per_ray=96, mesh_filter_dist=0.15, outlier_nb_points=4,
                              outlier_radius=0.2, n_subsurface=200, normals_k=48,
                              density_threshold=0.5 if analytic else 0.2)


def _reference_hit_draws(sils, n_loops, n_rays=50, n_pts=128, seed=0):
    """The reference's surface-sampling draws (seed 0) as the port takes
    them: one (pixels, jitter, depth uniforms) triple a loop."""
    V = sils.shape[0]
    key = jax.random.PRNGKey(seed)
    logits = jnp.where(jnp.asarray(sils.reshape(V, -1)) > 0.5, 0.0, -1e9)
    draws = []
    for _ in range(n_loops):
        key, sub = jax.random.split(key)
        parts = []
        for v, k in enumerate(jax.random.split(sub, V)):
            k_pix, k_jit, k_z = jax.random.split(k, 3)
            parts.append((np.asarray(jax.random.categorical(k_pix, logits[v], shape=(n_rays,))),
                          np.asarray(jax.random.uniform(k_jit, (n_rays, 2))),
                          np.asarray(jax.random.uniform(k_z, (n_rays, n_pts)))))
        draws.append(tuple(np.stack(x) for x in zip(*parts)))
    return draws


CORS_FLAGS = ("--image-size", "40", "--grid-res", "40", "--field-preset", "small")


def _planted():
    """A planted shell of the small preset (flax layout), moved off the
    grid's symmetries by a low-frequency tilt so FPS meets no exact ties
    (as tests/test_torch_cors.py plants it)."""
    p = convert.planted_field_params(tconfig.FieldConfig(n_harmonic_functions=8, n_hidden=48), seed=0)
    rng = np.random.default_rng(3)
    k = p["params"]["trunk1"]["kernel"]
    for d in range(3):
        k[d * 8 + 1, 0] = rng.uniform(0.3, 0.6)
        k[d * 8 + 2, 0] = rng.uniform(-0.3, 0.3)
    return p


def test_cors_and_bake_on_the_analytic_field(tmp_path, same_scene, monkeypatch):
    """With no NeRF checkpoint both CLIs take the analytic stand-in field.
    ``generate-cors``: flips bounded by their cause (densities of the two
    packages' analytic fields agree to 1e-6: a cause within 1e-5).
    ``gen-feat`` on the reference's draws: the same baked keys (positions
    to 1e-5 of the CAD scale, keys to 1e-5, normals, the real count; FPS
    may order two near-tied points the other way)."""
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    jcli.main(["generate-cors", *_base(jroot, extra=CORS_FLAGS)])
    tcli.main(["generate-cors", *_base(troot, port=True, extra=CORS_FLAGS)])
    field = tsyn.AnalyticField("cpu")
    _compare_cors(jroot, troot, field, _cli_cors_cfg(True), 0, 1e-5, 1e-5)

    sils = _scene(0, 40)[1]
    orig = tss.sample_surface_hits
    monkeypatch.setattr(tss, "sample_surface_hits", lambda *a, n_loops, generator=None, draws=None, **kw: orig(
        *a, n_loops=n_loops, draws=_reference_hit_draws(sils, n_loops), **kw))
    jcli.main(["gen-feat", *_base(jroot, extra=CORS_FLAGS)])
    tcli.main(["gen-feat", *_base(troot, port=True, extra=CORS_FLAGS)])
    scale = _scene(0, 40)[5] / 1.8
    jp, tp = jart.pose_dir(str(jroot / "0_ruapc_obj_1"), 1), jart.pose_dir(str(troot / "0_ruapc_obj_1"), 1)
    vj, fj, nj, n_j = jart.load_keys(jp, trim=True)
    vt, ft, nt, n_t = jart.load_keys(tp, trim=True)
    assert n_t == n_j > 100 and jart.load_keys(tp, trim=False)[0].shape == jart.load_keys(jp, trim=False)[0].shape
    match = _matched_rows(vt, vj, 1e-5 * scale)
    np.testing.assert_allclose(ft, fj[match], atol=1e-5)
    assert ((nj[match] * nt).sum(-1) > 0.99).mean() > 0.95


def test_generate_cors_on_a_converted_nerf_field(tmp_path, same_scene):
    """A planted JAX field saved as the reference's checkpoint, brought
    across with ``convert.params_from_jax`` into the port's checkpoint:
    the two CLIs' correspondences, flips bounded by their cause (bf16
    matmuls, f32 sums in another order: a density within 2e-2 of its
    threshold, surface points to 2e-3)."""
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    p = _planted()
    for root, save in ((jroot, lambda path: jckpt.save(path, jax.tree.map(jnp.asarray, p), 7)),
                       (troot, lambda path: tckpt.save(path, convert.params_from_jax(p), 7))):
        save(os.path.join(jart.nerf_dir(str(root / "0_ruapc_obj_1"), 1), "nerflatestFine"))
    jcli.main(["generate-cors", *_base(jroot, extra=CORS_FLAGS)])
    tcli.main(["generate-cors", *_base(troot, port=True, extra=CORS_FLAGS)])
    field = tcli.load_field(tcli.build_parser().parse_args(["generate-cors", *_base(troot, port=True,
                                                                                    extra=CORS_FLAGS)]))
    assert not isinstance(field, tsyn.AnalyticField)
    _compare_cors(jroot, troot, field, _cli_cors_cfg(False), 0, 2e-2, 2e-3)


# ------------------------------------------------------- the port's chain


class _Stop(Exception):
    pass


def _state_tensors(path):
    obj = torch.load(path, weights_only=True)
    out = []
    for v in obj.values():
        if isinstance(v, dict):
            out += list(v.values())
        elif isinstance(v, list):
            out += v
        else:
            out.append(torch.tensor(v))
    return out


def _assert_same_state(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_port_chain_resumes_exactly_and_feeds_the_reference(tmp_path, monkeypatch, reference_cad, capsys):
    """The port's CLI alone: ``train-nerf --steps 8`` stopped after its
    step-4 checkpoint and resumed with ``--cont`` equals the straight run
    bit for bit; ``train-pose`` likewise; then, on planted fields (an
    8-step NeRF has no surface yet), the serving and registration
    commands; the reference's ``choose-image`` and ``icp`` on the port's
    artifacts agree with the port's (tolerances as the finale's)."""
    flags = ("--image-size", "40", "--grid-res", "40", "--field-preset", "small", "--viz-every", "4",
             "--synthetic-views", "4")
    orig_cfg = tconfig.NerfTrainConfig
    monkeypatch.setattr(tconfig, "NerfTrainConfig", functools.partial(orig_cfg, ckpt_every=4))
    # the final point clouds on a 40^3 grid, not 128^3 (~8 s each on the CPU)
    monkeypatch.setattr(tnt, "extract_point_cloud", functools.partial(tnt.extract_point_cloud, grid_res=40))
    straight, cut = tmp_path / "straight", tmp_path / "cut"
    tcli.main(["train-nerf", *_base(straight, 1, True, flags), "--steps", "8"])
    save_latest = tckpt.save_latest

    def stop_at_4(directory, state):
        save_latest(directory, state)
        if state.step == 4:
            raise _Stop

    monkeypatch.setattr(tckpt, "save_latest", stop_at_4)
    with pytest.raises(_Stop):
        tcli.main(["train-nerf", *_base(cut, 1, True, flags), "--steps", "8"])
    monkeypatch.setattr(tckpt, "save_latest", save_latest)
    tcli.main(["train-nerf", *_base(cut, 1, True, flags), "--steps", "8", "--cont"])
    nerf = lambda root: jart.nerf_dir(str(root / "1_ruapc_obj_1"), 1)  # noqa: E731
    _assert_same_state(os.path.join(nerf(straight), "trainstate"), os.path.join(nerf(cut), "trainstate"))
    assert os.path.exists(os.path.join(nerf(cut), "previews", "8_grid.png"))

    # the serving chain on planted fields, on the reference's scenes
    monkeypatch.setattr(jcli, "load_data", _fake_load_data)
    monkeypatch.setattr(tcli, "load_data", _fake_load_data)
    root = tmp_path / "chain"
    planted = convert.params_from_jax(_planted())
    for uh in (0, 1):
        tckpt.save(os.path.join(jart.nerf_dir(str(root / f"{uh}_ruapc_obj_1"), 1), "nerflatestFine"), planted, 8)
        tcli.main(["generate-cors", *_base(root, uh, True, flags)])
        if uh == 0:
            tcli.main(["train-pose", *_base(root, uh, True, flags), "--neg-only"])
            shutil.copytree(root / "0_ruapc_obj_1", tmp_path / "pose_straight" / "0_ruapc_obj_1")
            tcli.main(["train-pose", *_base(root, uh, True, flags), "--steps", "1"])
            tcli.main(["train-pose", *_base(root, uh, True, flags), "--steps", "2", "--cont"])
            tcli.main(["train-pose", *_base(tmp_path / "pose_straight", uh, True, flags), "--steps", "2"])
            pose = lambda r: jart.pose_dir(str(r / "0_ruapc_obj_1"), 1)  # noqa: E731
            _assert_same_state(os.path.join(pose(root), "trainstate"),
                               os.path.join(pose(tmp_path / "pose_straight"), "trainstate"))
        tcli.main(["gen-feat", *_base(root, uh, True, flags)])
    for cmd in ("poses-est", "inference"):
        tcli.main([cmd, *_base(root, 0, True, flags)])
    capsys.readouterr()
    tcli.main(["check", *_base(root, 0, True, flags)])
    assert "MISSING" not in capsys.readouterr().out
    exp0 = root / "0_ruapc_obj_1"
    assert np.isfinite(np.load(exp0 / "1pred_R.npy")).all() and np.load(exp0 / "1pred_t.npy").shape == (4, 3)
    assert os.path.exists(exp0 / "1correctly_predicted_list.txt")

    tout = _finale(root, tcli, True, 20.0, capsys, flags[-2:])
    ports = {n: (exp0 / n).read_bytes() for n in ("1error.npy", "1top_50_choices.txt")}
    jroot = tmp_path / "reference_on_port"
    shutil.copytree(root, jroot)
    jcli.main(["choose-image", *_base(jroot, extra=flags[-2:])])
    capsys.readouterr()
    jcli.main(["icp", *_base(jroot, extra=flags[-2:]), "--icp-threshold", "20.0"])
    icp_j = _last_json(capsys.readouterr().out)
    for n, data in ports.items():
        assert (jroot / "0_ruapc_obj_1" / n).read_bytes() == data, n
    _compare_icp(icp_j, tout[0], _scene(0, 64, 4)[5] / 1.8)


# ------------------------------------- SurfEmb, full frames and the mesh scene


_MEAN, _STD = np.float32([0.485, 0.456, 0.406]), np.float32([0.229, 0.224, 0.225])


def _colour_features(c, xp):
    """Fourier features (12) of colours (..., 3) in [0, 1], whose dot product
    is largest where the colours meet."""
    k = xp.asarray(np.pi * np.arange(1, 3, dtype=np.float32))
    ang = c[..., :, None] * k
    parts = [xp.cos(ang).reshape(c.shape[:-1] + (6,)), xp.sin(ang).reshape(c.shape[:-1] + (6,))]
    return torch.cat(parts, -1) if xp is torch else xp.concatenate(parts, -1)


class _JaxNocsNet:
    """The reference CLI's CNN stand-in: colour features of the
    de-normalized crop, mask logit 0."""

    def apply(self, params, x):
        f = _colour_features(x * _STD + _MEAN, jnp)
        return jnp.concatenate([f, jnp.zeros(f.shape[:-1] + (1,))], -1)


class _TorchNocsNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(0), requires_grad=False)

    def forward(self, x):
        f = _colour_features(x * torch.from_numpy(_STD) + torch.from_numpy(_MEAN), torch)
        return torch.cat([f, torch.zeros(f.shape[:-1] + (1,))], -1)


def _write_bop_tree(ds, objid, ids, frames, masks, R, t, K, diameter, cad):
    """A BOP-layout object folder: rgb, mask and mask_visib PNGs (the
    reference's inference reads the half's loader crops, through ``mask``,
    before its full frames), scene_gt, scene_camera, models_info and an
    ascii PLY of the CAD points."""
    from PIL import Image

    obj = os.path.join(ds, "train", f"{objid:06d}")
    for sub in ("rgb", "mask", "mask_visib"):
        os.makedirs(os.path.join(obj, sub), exist_ok=True)
    gts, cams = {}, {}
    for a, i in enumerate(ids):
        Image.fromarray(np.round(np.clip(frames[a], 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(obj, "rgb", f"{i:06d}.png"))
        for sub in ("mask", "mask_visib"):
            Image.fromarray((masks[a] > 0).astype(np.uint8) * 255).save(os.path.join(obj, sub, f"{i:06d}_000000.png"))
        gts[str(i)] = [{"cam_R_m2c": R[a].reshape(-1).tolist(), "cam_t_m2c": t[a].tolist(), "obj_id": objid}]
        cams[str(i)] = {"cam_K": K.reshape(-1).tolist()}
    with open(os.path.join(obj, "scene_gt.json"), "w") as f:
        json.dump(gts, f)
    with open(os.path.join(obj, "scene_camera.json"), "w") as f:
        json.dump(cams, f)
    os.makedirs(os.path.join(ds, "models"), exist_ok=True)
    with open(os.path.join(ds, "models", "models_info.json"), "w") as f:
        json.dump({str(objid): {"diameter": float(diameter)}}, f)
    head = (f"ply\nformat ascii 1.0\nelement vertex {len(cad)}\nproperty float x\nproperty float y\n"
            "property float z\nend_header\n")
    with open(os.path.join(ds, "models", f"obj_{objid:06d}.ply"), "w") as f:
        f.write(head + "".join(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in cad))


def _nocs_experiment(tmp_path, with_unet=False, n_frames=2, size=(120, 90)):
    """Experiment 0 of tless object 1 with baked keys of the blob mesh
    (20,000 points drawn on its triangles, scale 40, their NOCS colours'
    features as keys) and, with ``with_unet``, a fresh ResNetUNet
    checkpoint; and a BOP tree of ``n_frames`` frames of the other half's
    first ids: the blob rendered off-centre in its NOCS colours (no shading:
    a pixel's colour is its surface point's, so every correspondence lands
    within a key's spacing of the truth) at ``size``.  Returns (root, bop
    root, the frames' GT)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene as tms
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import rasterize as tras

    scale = 40.0
    verts, faces, colors, normals = tms.blob_mesh(3)
    diameter = float(np.linalg.norm(verts.max(0) - verts.min(0))) * scale
    root, bop_root = str(tmp_path / "exp"), str(tmp_path / "bop")
    pose_d = jart.pose_dir(os.path.join(root, "0_tless_obj_1"), 1)
    rng = np.random.default_rng(4)
    bary = rng.dirichlet(np.ones(3), size=20000)
    tri = rng.integers(0, len(faces), size=20000)
    pts = np.einsum("nk,nkd->nd", bary, verts[faces[tri]])
    pts_colors = np.einsum("nk,nkd->nd", bary, colors[faces[tri]])
    pts_normals = np.einsum("nk,nkd->nd", bary, normals[faces[tri]])
    for name, arr in (("vert1_scaled.npy", pts * scale), ("feat1_scaled.npy", _colour_features(pts_colors, np)),
                      ("normals_scaled.npy", pts_normals), ("n_keys.npy", np.asarray([len(pts)]))):
        jart.save_array(pose_d, name, np.asarray(arr, np.float32) if name != "n_keys.npy" else arr)
    if with_unet:
        tckpt.save(os.path.join(pose_d, tckpt.ENCODER),
                   ResNetUNet().reset_parameters(torch.Generator().manual_seed(0)).state_dict(), 1)
    W, H = size
    K = np.float32([[150.0, 0, W / 2 + 0.5], [0, 152.0, H / 2 - 0.5], [0, 0, 1]])
    Rs = np.stack([_rot(rng) for _ in range(n_frames)]).astype(np.float32)
    ts = np.stack([[0.5 + 0.1 * a, -0.3, 5.5] for a in range(n_frames)]).astype(np.float32)
    cam = tcam.camera_from_bop(torch.from_numpy(Rs), torch.from_numpy(ts), torch.from_numpy(K).expand(n_frames, 3, 3),
                               W)
    rgb, sil, _ = tras.render_mesh(*(torch.from_numpy(x) for x in (verts, faces, colors, normals)), cam, W,
                                   ambient=1.0, diffuse=0.0)
    ids = np.asarray(_tless_ids(1)[:n_frames])
    _write_bop_tree(os.path.join(bop_root, "tless"), 1, ids, rgb.numpy()[:, :H], sil.numpy()[:, :H], Rs, ts * scale,
                    K, diameter, verts * scale)
    return root, bop_root, (Rs, ts * scale)


def _tless_ids(uh):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import bop

    return bop.half_sequence_ids("tless", uh)


def _rot(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q * np.linalg.det(q)


def _printed_adds(text):
    return [float(ln.split("ADD=")[1].split()[0]) for ln in text.splitlines() if ln.startswith("img ")]


def test_inference_full_frames_matches_reference(tmp_path, monkeypatch, capsys):
    """``inference --full-frames`` of both CLIs on one fabricated BOP tree
    (two 120 x 90 frames, the object off-centre), each CLI's CNN replaced by
    a colour-feature stand-in, the port handed the reference's RANSAC draws
    (its key path: PRNGKey(1) split once a frame, then ops/pnp.py's split
    and categorical over the confidence mask): the printed ADD-S (tless:
    CAD points against the baked cloud) to 3e-3 of the diameter, the
    correct list equal, and every frame correct.  The crops and confidence
    masks are equal; a correspondence at RANSAC's 2 px inlier threshold
    flips (inlier counts 1 apart), which moves the refit pose by ~2e-3 in
    R and ~0.05 in t."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import unet as junet

    root, bop_root, _ = _nocs_experiment(tmp_path)
    monkeypatch.setattr(junet, "ResNetUNet", _JaxNocsNet)
    monkeypatch.setattr(tcli, "_load_cnn", lambda path, dev: (_TorchNocsNet(), 0))
    keys = []
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        key, sub = jax.random.split(key)
        keys.append(jax.random.split(sub, 2)[0])
    orig = tinf.estimate_pose_full_frame

    def with_reference_draws(*a, **kw):
        conf = orig(*a, **kw).conf_mask[0]
        logits = jnp.log(jnp.maximum(jnp.asarray(conf.numpy(), jnp.float32), 1e-12))
        samples = np.asarray(jax.random.categorical(keys.pop(0), logits, shape=(500, 4)))
        return orig(*a, **{**kw, "samples": torch.from_numpy(samples[None])})

    monkeypatch.setattr(tinf, "estimate_pose_full_frame", with_reference_draws)
    argv = ["inference", "--objid", "1", "--dataset", "tless", "--UH", "0", "--root", root, "--bop-root", bop_root,
            "--full-frames", "--fsamps", "2"]
    listed = os.path.join(root, "0_tless_obj_1", "1correctly_predicted_list.txt")
    jcli.main(argv)
    want, want_list = _printed_adds(capsys.readouterr().out), open(listed).read()
    tcli.main([*argv, "--device", "cpu"])
    got, got_list = _printed_adds(capsys.readouterr().out), open(listed).read()
    diameter = json.load(open(os.path.join(bop_root, "tless", "models", "models_info.json")))["1"]["diameter"]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=3e-3 * diameter)
    assert got_list == want_list == "".join(f"{i}\n" for i in _tless_ids(1)[:2])


def _ideal_maps(uh, size, views, features):
    """Per view of the reference's synthetic half: the ideal query map (the
    ``features`` of each pixel's surface point, 0 off the object) and mask
    logits, (V, S, S, 13)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import raymarch as jrm
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import renderer as jrend

    images, sils, R, t, K, diam = _scene(uh, size, views)
    t = t / (diam / 1.8)
    cams = jcam.camera_from_bop(jnp.asarray(R), jnp.asarray(t), jnp.asarray(K), size)
    z = np.abs(t[:, 2])
    maps = []
    for v in range(views):
        _, w, b = jrend.render_grid_chunked(lambda p, d, m: jsyn.analytic_field(p, d, m), cams[v], size, 96,
                                            float(z.min() - 2), float(z.max() + 2), mode="feature",
                                            threshold_mode=True, threshold=0.5, chunk=size * size)
        pos = jrm.surface_points(b.origins, b.directions, b.lengths, w)
        q = np.asarray(features(pos)).reshape(size, size, 12) * (sils[v] > 0.5)[..., None]
        maps.append(np.concatenate([q, (sils[v] * 12.0 - 6.0)[..., None]], -1))
    return np.stack(maps).astype(np.float32), images


class _JaxIdeal:
    """The reference CLI's CNN stand-in: the ideal map of whichever of the
    half's images it is shown."""

    def __init__(self, maps, images):
        self.maps, self.imgs = jnp.asarray(maps), jnp.asarray((images - _MEAN) / _STD)

    def apply(self, params, x):
        return self.maps[jnp.argmin(((x[:, None] - self.imgs[None]) ** 2).sum((2, 3, 4)), axis=1)]


class _TorchIdeal(torch.nn.Module):
    def __init__(self, maps, images):
        super().__init__()
        self.maps, self.imgs = torch.from_numpy(maps), torch.from_numpy(((images - _MEAN) / _STD).astype(np.float32))
        self.anchor = torch.nn.Parameter(torch.zeros(0), requires_grad=False)

    def forward(self, x):
        return self.maps[torch.argmin(((x[:, None] - self.imgs[None]) ** 2).sum((2, 3, 4)), dim=1)]


def _surf_keys(n):
    """Each image's SurfEmb key as both CLIs derive it, in image order:
    poses-est's split(PRNGKey(1), n) and inference's PRNGKey(1) split once an
    image."""
    img_keys, key = [], jax.random.PRNGKey(1)
    for _ in range(n):
        key, sub = jax.random.split(key)
        img_keys.append(sub)
    return {"poses-est": list(jax.random.split(jax.random.PRNGKey(1), n)), "inference": img_keys}


def _well_posed_surf_draws(maps, K, verts, feats, key, max_poses, reference_p3p):
    """One image's SurfEmb draws from its key, moved off the two causes of
    divergence as ``test_torch_surfemb.well_posed_draws`` does: ((k_samp,
    u), (k_sol, pick)) for the reference and the port's ``SurfEmbDraws``."""
    from test_torch_surfemb import well_posed_draws

    k_est, k_ref = jax.random.split(key)
    scene = dict(mask_lgts=maps[..., 12], qmap=maps[..., :12], feats=feats, verts=verts, K=K.astype(np.float32))
    u, pick, _ = well_posed_draws(scene, k_est, max_poses, reference_p3p=reference_p3p)
    k_samp, k_sol = jax.random.split(k_est)
    sel = np.array(jax.random.permutation(k_ref, verts.shape[0]))
    return ((k_samp, u), (k_sol, pick)), tinf.SurfEmbDraws(torch.from_numpy(u), torch.from_numpy(pick),
                                                         torch.from_numpy(sel))


def _uniforms_by_key(monkeypatch, table):
    """``jax.random.uniform`` of the reference replaced: a draw of a key in
    ``table`` [(key, values)] returns its values (a lookup that traces, so
    it holds inside the reference's jitted sequence program too)."""
    keys = jnp.stack([k for k, _ in table])
    assert len({tuple(np.asarray(k)) for k in keys}) == len(table)
    vals = jnp.asarray(np.stack([v for _, v in table]))
    orig = jax.random.uniform

    def uniform(key, shape=(), *a, **kw):
        if tuple(shape) != vals.shape[1:]:
            return orig(key, shape, *a, **kw)
        return vals[jnp.argmax(jnp.all(keys == key, axis=-1))]

    monkeypatch.setattr(jax.random, "uniform", uniform)


def _unjitted_batch_estimator(cnn, cfg, diameter, refine=True, refine_steps=50, translation_only=False, mesh=None,
                              group=None):
    """The reference's ``make_batch_surfemb_estimator`` as a loop of its
    ``_surfemb_core`` over the batch's images and keys, without jit."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import inference as jinf

    def batch_fn(cnn_params, images, cam_Ks, verts, normals, feats, keys):
        outs = [jinf._surfemb_core(cnn, cnn_params, image, K, verts, normals, feats, diameter, key, cfg, refine,
                                   refine_steps, translation_only) for image, K, key in zip(images, cam_Ks, keys)]
        return tuple(jnp.stack([jnp.asarray(x) for x in part]) for part in zip(*outs))

    return batch_fn


def test_surf_eval_commands_match_reference(tmp_path, same_scene, monkeypatch, capsys):
    """``poses-est`` and ``inference --use-surf-eval`` of both CLIs on 4
    views of the reference's synthetic half 1 at 48 px, with baked analytic
    keys and each CLI's CNN replaced by the ideal query maps of a sharp
    descriptor, both estimators at InferenceConfig(max_poses=512,
    max_pose_evaluations=128).

    Both CLIs get each image's draws from its key (poses-est: key i of
    split(PRNGKey(1), n); inference: PRNGKey(1) split once an image), moved
    off the cdf's bin edges and the ill-posed P3P triples as
    tests/test_torch_surfemb.py does.  Unrefined (the refiner turned off in
    both), the saved poses agree to 1e-3 (f32 Grunert), the printed ADD to
    1e-3 of the diameter (its 3 printed decimals) and the correct lists are
    equal.  Refined (4 BFGS steps): the refiner carries the two CLIs'
    unrefined poses' 1e-3 apart, so the port CLI's refinement is held to
    the reference's ``refine_pose`` from the port CLI's own starts.  Each
    image's refiner starts from that command's unrefined best pose
    (poses-est: the saved poses, exactly), is handed the permutation the
    reference draws from the image's key, and lands on the reference's R
    and t to 1e-5 (1e-5 of |t0| for t, as tests/test_torch_surfemb.py holds
    ``refine_pose``); the saved poses are the refiner's.  Four steps: from
    these 8 starts the two refiners agree to 2e-6 in R through step 4; by
    step 10 the f32 sums' drift through the BFGS updates reaches 8.5e-4 at
    one start, and at another an Armijo trial near its bound branches
    (7e-3)."""
    from test_torch_surfemb import sharp_features

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import InferenceConfig as JCfg
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import unet as junet
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import pnp as jpnp
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import inference as jinf
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import pose_est_surf as jpes
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import pose_refine as jpr
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine as tpr

    S, V, P = 48, 4, 512
    maps, images = _ideal_maps(1, S, V, sharp_features)
    pts, ok = jsyn.analytic_surface_points(1500, jax.random.PRNGKey(3))
    pts_n = np.asarray(pts)[np.asarray(ok)]
    K, diam = _scene(1, S, V)[4:]
    verts = (pts_n * diam / 1.8).astype(np.float32)
    feats = np.asarray(sharp_features(jnp.asarray(pts_n)), np.float32)
    for root in (tmp_path / "jax", tmp_path / "port"):
        pose_d = jart.pose_dir(str(root / "0_ruapc_obj_1"), 1)
        jart.save_array(pose_d, "vert1_scaled.npy", verts)
        jart.save_array(pose_d, "feat1_scaled.npy", feats)
        jart.save_array(pose_d, "normals_scaled.npy", (pts_n / np.linalg.norm(pts_n, axis=-1, keepdims=True)))
    monkeypatch.setattr(junet, "ResNetUNet", lambda: _JaxIdeal(maps, images))
    monkeypatch.setattr(tcli, "_load_cnn", lambda path, dev: (_TorchIdeal(maps, images), 0))
    # per command: poses-est's key i is inference's key i - 1
    p3p = jax.jit(jpnp.solve_p3p_batch)
    ref_draws, port_draws = {}, {}
    for cmd, keys in _surf_keys(V).items():
        ref_draws[cmd], port_draws[cmd] = [], []
        for i, key in enumerate(keys):
            ref, port = _well_posed_surf_draws(maps[i], K[i], verts, feats, key, P, p3p)
            ref_draws[cmd] += ref
            port_draws[cmd].append(port)
    # the hypotheses op by op (P3P compiled), as the draws were checked
    # against: compiled whole, XLA sums the cdf in another order; the
    # reference's sequence program (one jit of lax.map over vmapped images)
    # becomes a loop of its per-image core over the same keys
    monkeypatch.setattr(jpes, "estimate_pose", jpes.estimate_pose.__wrapped__)
    monkeypatch.setattr(jpnp, "solve_p3p_batch", p3p)
    monkeypatch.setattr(jinf, "make_batch_surfemb_estimator", _unjitted_batch_estimator)
    small = dict(max_poses=P, max_pose_evaluations=128)

    def configure(mp, refine):
        kw = dict(refine=refine, refine_steps=4)
        for mod, cfg in ((jinf, JCfg(**small)), (tinf, tconfig.InferenceConfig(**small))):
            for fn in ("run_sequence_surfemb", "estimate_pose_surfemb"):
                mp.setattr(mod, fn, functools.partial(getattr(mod, fn), cfg=cfg, **kw))
        mp.setattr(tinf, "run_sequence_surfemb",
                   functools.partial(tinf.run_sequence_surfemb, draws=port_draws["poses-est"]))
        per_image = iter(port_draws["inference"])
        one = tinf.estimate_pose_surfemb
        mp.setattr(tinf, "estimate_pose_surfemb", lambda *a, generator=None, **kw: one(*a, draws=next(per_image), **kw))

    extra = ["--synthetic-views", str(V), "--image-size", str(S), "--use-surf-eval"]

    def run(cli_mod, root, port):
        capsys.readouterr()
        for cmd in ("poses-est", "inference"):
            _uniforms_by_key(monkeypatch, ref_draws[cmd])
            cli_mod.main([cmd, *_base(root, port=port, extra=extra)])
        exp = root / "0_ruapc_obj_1"
        return (np.load(exp / "1pred_R.npy"), np.load(exp / "1pred_t.npy"), _printed_adds(capsys.readouterr().out),
                (exp / "1correctly_predicted_list.txt").read_text())

    with monkeypatch.context() as mp:
        configure(mp, refine=False)
        Rj, tj, addj, listj = run(jcli, tmp_path / "jax", False)
        Rt, tt, addt, listt = run(tcli, tmp_path / "port", True)
    assert Rt.shape == (V, 3, 3) and len(addt) == len(addj) == V
    np.testing.assert_allclose(Rt, Rj, atol=1e-3)
    np.testing.assert_allclose(tt, tj, atol=1e-3 * np.abs(tj).max())
    np.testing.assert_allclose(addt, addj, atol=1e-3 * diam)
    assert listt == listj
    configure(monkeypatch, refine=True)
    calls, refine = [], tpr.refine_pose

    def recording(*a, **kw):
        calls.append((a, kw, refine(*a, **kw)))
        return calls[-1][2]

    monkeypatch.setattr(tpr, "refine_pose", recording)
    Rr, tr, addr, _ = run(tcli, tmp_path / "port", True)
    assert np.isfinite(addr).all() and len(addr) == V and len(calls) == 2 * V
    starts = {"poses-est": calls[:V], "inference": calls[V:]}
    for cmd, keys in _surf_keys(V).items():
        for i, (a, kw, (R1, t1, _)) in enumerate(starts[cmd]):
            R0, t0 = a[0].numpy(), a[1].numpy()
            k_ref = jax.random.split(keys[i])[1]
            assert kw["n_steps"] == 4 and not kw["translation_only"]
            np.testing.assert_array_equal(kw["sel"].numpy(), np.asarray(jax.random.permutation(k_ref, len(verts))))
            Rj, tj, _ = jpr.refine_pose(*(jnp.asarray(x.numpy()) for x in a[:6]), k_ref, n_steps=4)
            np.testing.assert_allclose(R1.numpy(), np.asarray(Rj), atol=1e-5)
            np.testing.assert_allclose(t1.numpy(), np.asarray(tj), atol=1e-5 * np.abs(t0).max())
            assert np.abs(t1.numpy() - t0).max() > 0
            if cmd == "poses-est":
                np.testing.assert_array_equal(R0, Rt[i])
                np.testing.assert_array_equal(t0, tt[i])
                np.testing.assert_array_equal(Rr[i], R1.numpy())
                np.testing.assert_array_equal(tr[i], t1.numpy())


def test_synthetic_mesh_load_data_matches_reference(monkeypatch):
    """``--synthetic-mesh``'s load_data, the port handed the reference's pose
    draws of PRNGKey(UH): poses to 1e-5 (the uniforms' scaling rounds once
    in either order), translations in the loader's units (t x diam / 1.8),
    K and the diameter equal; images and silhouettes differ on at most
    0.5 % of pixels (triangle-edge pixels, tests/test_torch_mesh_scene.py
    bounds them by that cause) and by 1e-4 elsewhere."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene as tms

    orig = tms.make_mesh_scene

    def reference_poses(*a, generator=None, **kw):
        ks = jax.random.split(jax.random.PRNGKey(generator.initial_seed()), 3)
        n = kw["n_views"]
        return orig(*a, uniforms=np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in ks]), **kw)

    monkeypatch.setattr(tms, "make_mesh_scene", reference_poses)
    for uh in (0, 1):
        argv = ["--UH", str(uh), "--synthetic-mesh", "--synthetic-views", "3"]
        want = jcli.load_data(jcli.build_parser().parse_args(["train-nerf", *argv]), 32)
        got = tcli.load_data(tcli.build_parser().parse_args(["train-nerf", *argv, "--device", "cpu"]), 32)
        images, sils, R, t, K, diam = got
        assert diam == want[5] and images.shape == (3, 32, 32, 3) and sils.shape == (3, 32, 32)
        np.testing.assert_allclose(R, np.asarray(want[2]), atol=1e-5)
        np.testing.assert_allclose(t, np.asarray(want[3]), atol=1e-5)
        np.testing.assert_array_equal(K, np.asarray(want[4]))
        bad = (sils != np.asarray(want[1])) | (np.abs(images - np.asarray(want[0])).max(-1) > 1e-4)
        assert bad.mean() <= 5e-3
