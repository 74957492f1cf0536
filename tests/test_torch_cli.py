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
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import surface_sampling as tss
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer as trend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint as tckpt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer as tnt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import generate_cors as tgc

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
    with none; the not-yet-ported paths raise NotImplementedError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--root", str(tmp_path), "--synthetic", "--image-size", "16"]
    for cmd in _subparsers(tcli.build_parser()):
        for device in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tcli.main([cmd, *base, *device])
    assert not os.listdir(tmp_path)
    for argv in (["poses-est", "--use-surf-eval"], ["inference", "--full-frames"],
                 ["train-nerf", "--synthetic-mesh"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcli.main([*argv, "--root", str(tmp_path), "--device", "cpu"])


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
