"""The serving slice end to end, JAX reference vs port, on the bench-SMALL
scene (8 harmonics, 48 hidden, 48 px, 48^3 grid) with the planted field:
density grid -> marching tetrahedra -> surface hits -> bake -> inference
with injected RANSAC draws -> ADD -> verification and ICP registration.
Both sides run on the CPU; the JAX side without a mesh."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FeatConfig, FieldConfig, InferenceConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import mcubes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import metrics as jmetrics
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import artifacts
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import gen_feat as jgen
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import inference as jinf
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import registration as jreg
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import surface_sampling as jss
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import renderer as jrend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics as tmetrics
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as tpc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import gen_feat as tgen
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference as tinf
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import registration as treg
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import surface_sampling as tss
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer as trend

torch.set_num_threads(1)

IMG, GRID, N_INF = 48, 48, 4
FEAT = FeatConfig(mc_threshold=0.05, n_points=4000, sample_loops=2, mesh_dist=0.15)
CFG = FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16")


def _np(x):
    return np.array(x, dtype=np.float32)


@pytest.fixture(scope="module")
def slice_state(tmp_path_factory):
    return _bake_both(CFG, tmp_path_factory)


@pytest.fixture(scope="module")
def slice_state_nosiren(tmp_path_factory):
    return _bake_both(FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", siren=False),
                      tmp_path_factory)


def _bake_both(cfg, tmp_path_factory):
    """Both packages' bake of the planted field of ``cfg`` on half 0."""
    halves = [jsyn.make_scene(n_views=8, image_size=IMG, key=jax.random.PRNGKey(uh)) for uh in (0, 1)]
    planted = convert.planted_field_params(cfg, seed=0)
    jfield = jfields.NerfField(cfg)
    jparams = jax.tree.map(jnp.asarray, planted)
    tfield = tfields.NerfField(cfg)
    tfield.load_state_dict(convert.params_from_jax(planted))
    root = tmp_path_factory.mktemp("slice")
    s0 = halves[0]
    diam = s0.diameter
    args = (s0.R_bop, s0.t_bop, s0.K, s0.sils)
    jout = jgen.gen_feat(jfield, jparams, *args, diam, str(root / "jax"), 1, FEAT, image_size=IMG, grid_res=GRID)
    tout = tgen.gen_feat(tfield, *map(_np, args), diam, str(root / "port"), 1, FEAT, image_size=IMG,
                         grid_res=GRID, generator=torch.Generator().manual_seed(0))
    return dict(halves=halves, jfield=jfield, jparams=jparams, tfield=tfield, root=root, jout=jout,
                tout=tout, diam=diam, scale=diam / 1.8)


def test_density_grid_and_marching_tets(slice_state):
    st = slice_state
    gj = np.asarray(jrend.density_grid_cached(st["jfield"], st["jparams"], grid_res=GRID))
    gt = trend.density_grid_cached(st["tfield"], grid_res=GRID).numpy()
    # both run the flax numerics (the kernel is CUDA-only).  The frameworks'
    # linspace rounds most grid coordinates one ulp apart; where that crosses
    # a bf16 rounding boundary of a trunk output on the planted shell, the
    # density moves by up to ~1e-3
    err = np.abs(gt - gj)
    assert (err > 1e-5).mean() < 1e-2 and err.max() < 5e-3, (np.mean(err > 1e-5), err.max())
    # at identical points the port agrees with the reference's eager density
    # to f32 rounding (the reference's jitted grid itself differs from its
    # eager density at those shell voxels: XLA elides some bf16 roundings)
    t = np.asarray(jnp.linspace(-1.0, 1.0, GRID))
    pts = np.stack(np.meshgrid(t, t, t, indexing="ij"), -1).reshape(-1, 3)
    with torch.no_grad():
        same = st["tfield"].density(torch.from_numpy(pts)).numpy()
    eager = np.asarray(st["jfield"].apply(st["jparams"], jnp.asarray(pts), method=st["jfield"].density))
    np.testing.assert_allclose(same, eager, atol=1e-6)
    vj, tj = mcubes.marching_tetrahedra(gj, FEAT.mc_threshold)
    vt, tt = mcubes.marching_tetrahedra(gt, FEAT.mc_threshold)
    assert vj.shape[0] == vt.shape[0] > 100
    assert tj.shape == tt.shape


def test_surface_hits_with_reference_draws(slice_state):
    st = slice_state
    s0 = st["halves"][0]
    n_rays, n_pts, n_loops = 50, 128, 2
    # the reference's draws (pipeline/surface_sampling.py), replayed
    key = jax.random.PRNGKey(0)
    flat = np.asarray(s0.sils).reshape(8, -1)
    logits = jnp.where(jnp.asarray(flat) > 0.5, 0.0, -1e9)
    draws = []
    for _ in range(n_loops):
        key, sub = jax.random.split(key)
        pix, jit, u = [], [], []
        for k in jax.random.split(sub, 8):
            k_pix, k_jit, k_z = jax.random.split(k, 3)
            pix.append(np.asarray(jax.random.categorical(k_pix, logits[len(pix)], shape=(n_rays,))))
            jit.append(np.asarray(jax.random.uniform(k_jit, (n_rays, 2))))
            u.append(np.asarray(jax.random.uniform(k_z, (n_rays, n_pts))))
        draws.append((np.stack(pix), np.stack(jit), np.stack(u)))
    args = (s0.R_bop, s0.t_bop, s0.K, s0.sils)
    hj = jss.sample_surface_hits(st["jfield"], st["jparams"], *args, n_loops=n_loops, rays_per_image=n_rays,
                                 image_size=IMG)
    ht = tss.sample_surface_hits(st["tfield"], *map(_np, args), n_loops=n_loops, rays_per_image=n_rays,
                                 image_size=IMG, draws=draws)
    assert ht.shape == hj.shape and hj.shape[0] > 300
    # the same sample depths: a hit moves only where a bf16 flip moves the
    # first above-threshold sample (one step of 4/128 along the ray)
    d = np.linalg.norm(ht.numpy() - hj, axis=-1)
    assert np.mean(d > 1e-4) < 0.01 and np.median(d) < 1e-5


def test_bake_matches_reference(slice_state):
    # the keys are the feature head at the baked points (SIREN, omega 30:
    # the f32 rescale by diameter / 1.8 and back moves them by ~1e-5)
    _check_bake(slice_state)


def test_bake_matches_reference_nosiren(slice_state_nosiren):
    """The bake of a planted field with the softplus MLP head (siren=False):
    keys from the head on the embedding, strictly inside (0, 1).  At the
    same points the keys agree to 1e-5 except where feat1's or feat2's
    bf16 output rounds the other way (the frameworks sum the products in
    another order)."""
    st = slice_state_nosiren
    _check_bake(st, flips=_head_rounding_flips)
    ft = st["tout"][1]
    assert np.isfinite(ft).all() and ft.min() > 0.0 and ft.max() < 1.0


def _head_rounding_flips(st, pts):
    """Rows where the reference's bf16 output of feat1 (on the port's
    embedding) or of feat2 (on the port's softplus) differs from the
    port's."""
    tf, jf, jp = st["tfield"], st["jfield"], st["jparams"]
    with torch.no_grad():
        e = tf.embed(torch.from_numpy(pts))
        z1 = tf._matmul(e, tf.feat1)
        h = tfields.softplus_beta(z1, CFG.softplus_beta)
        z2 = tf._matmul(h, tf.feat2)
    j1 = np.asarray(jf.apply(jp, jnp.asarray(e.numpy()), method=lambda m, x: m.feat1(x)).astype(jnp.float32))
    j2 = np.asarray(jf.apply(jp, jnp.asarray(h.numpy()), method=lambda m, x: m.feat2(x)).astype(jnp.float32))
    return (j1 != z1.numpy()).any(-1) | (j2 != z2.numpy()).any(-1)


def _check_bake(st, flips=None):
    (vj, fj, nj), (vt, ft, nt) = st["jout"], st["tout"]
    assert ft.shape[1] == fj.shape[1] == 12 and vt.shape[0] % FEAT.pad_multiple == 0
    _, _, _, n_j = artifacts.load_keys(artifacts.pose_dir(str(st["root"] / "jax"), 1))
    vt_real, ft_real, nt_real, n_t = artifacts.load_keys(artifacts.pose_dir(str(st["root"] / "port"), 1))
    # independent hit draws: both clouds cover the same planted shell
    assert abs(n_t - n_j) < 0.25 * n_j
    cham = float(tpc.chamfer_distance(torch.from_numpy(vt_real), torch.from_numpy(_np(vj[:n_j]))))
    # mean NN distance of two independent ~900-point samplings of a shell of
    # radius 0.5 is about half their spacing, ~0.03 before scaling
    assert cham < 0.05 * st["scale"], cham
    pts = vt_real / st["scale"]
    fj_at_t = np.asarray(jfields.eval_features(st["jfield"], st["jparams"], jnp.asarray(pts)))
    err = np.abs(tfields.eval_features(st["tfield"], torch.from_numpy(pts)).numpy() - fj_at_t).max(-1)
    if flips is None:
        assert err.max() <= 1e-5, err.max()
    else:
        flipped = flips(st, pts)
        assert not (err > 1e-5)[~flipped].any() and flipped.mean() < 1e-2, (err.max(), flipped.mean())
    np.testing.assert_allclose(ft_real, fj_at_t, atol=1e-3)
    assert np.allclose(np.linalg.norm(nt_real, axis=-1), 1.0, atol=1e-4)


class QueryMaps:
    """Reference-side CNN stand-in: ``params`` holds one (S, S, 13) query map
    per image, and channel 0 of each image carries its index."""

    def apply(self, params, image_batch):
        return params[image_batch[0, 0, 0, 0].astype(jnp.int32)][None]


class TorchQueryMaps(torch.nn.Module):
    """The port's counterpart of ``QueryMaps``."""

    def __init__(self, qmaps):
        super().__init__()
        self.register_buffer("qmaps", torch.from_numpy(qmaps))

    def forward(self, images):
        return self.qmaps[images[:, 0, 0, 0].long()]


def _unit(f):
    """Keys and queries of equal norm: argmax of q . k then finds the
    nearest key in feature space (trained descriptors have this structure)."""
    return (3.0 * f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(np.float32)


def _query_maps(st, s1, radius):
    """Ideal queries: the planted field's keys where each pixel's ray meets
    the planted shell, so correspondences (and RANSAC) are well posed."""
    cam = jcam.camera_from_bop(s1.R_bop[:N_INF], s1.t_bop[:N_INF], s1.K[:N_INF], IMG)
    b = jcam.grid_rays(cam, IMG, 2, 2.0, 6.0)
    o, d = np.asarray(b.origins), np.asarray(b.directions)
    qa, qb, qc = (d * d).sum(-1), 2 * (o * d).sum(-1), (o * o).sum(-1) - radius ** 2
    disc = qb * qb - 4 * qa * qc
    hit = disc > 0
    depth = (-qb - np.sqrt(np.maximum(disc, 0))) / (2 * qa)
    feats = _unit(np.asarray(jfields.eval_features(st["jfield"], st["jparams"], jnp.asarray(o + depth[..., None] * d))))
    qmaps = np.concatenate([feats, np.zeros_like(feats[..., :1])], -1).reshape(N_INF, IMG, IMG, 13)
    return qmaps.astype(np.float32), hit.reshape(N_INF, IMG, IMG).astype(np.float32)


@pytest.fixture(scope="module")
def inference_state(slice_state):
    st = slice_state
    s1 = st["halves"][1]
    scale = st["scale"]
    verts, feats = st["jout"][0], _unit(st["jout"][1])   # the reference's baked keys for both
    n_real = artifacts.load_keys(artifacts.pose_dir(str(st["root"] / "jax"), 1))[3]
    radius = float(np.median(np.linalg.norm(verts[:n_real] / scale, axis=-1)))
    qmaps, masks = _query_maps(st, s1, radius)
    # the CNN is a stand-in (its parity is test_torch_fields.py's): with a
    # random CNN every hypothesis scores a handful of inliers and the argmax
    # among near-ties is rounding noise; ideal queries make it well posed
    imgs = np.broadcast_to(np.arange(N_INF, dtype=np.float32)[:, None, None, None], (N_INF, IMG, IMG, 3)).copy()
    Ks = np.array(s1.K[:N_INF], np.float32)
    Ks[:, 0:2, 2] -= 0.5  # pixel-center convention, as the bench
    cfg = InferenceConfig()
    jnet = QueryMaps()
    Rj, tj = jinf.run_sequence(jnet, jnp.asarray(qmaps), imgs, masks, Ks, verts, feats, cfg=cfg, batch=N_INF,
                               mesh=None)
    # the reference's per-image RANSAC draws: key i of split(PRNGKey(1)),
    # then ops/pnp.py's split + categorical over the confidence mask
    keys = jax.random.split(jax.random.PRNGKey(1), N_INF)
    tnet = TorchQueryMaps(qmaps)
    _, conf_mask, _, _ = tinf.correspondences(tnet, torch.from_numpy(imgs), torch.from_numpy(masks),
                                              torch.from_numpy(Ks), torch.from_numpy(_np(feats)))
    samples = []
    for i in range(N_INF):
        ref = jinf.estimate_pose_single(jnet, jnp.asarray(qmaps), jnp.asarray(imgs[i]), jnp.asarray(masks[i]),
                                        jnp.asarray(Ks[i]), jnp.asarray(verts), jnp.asarray(feats), keys[i])
        np.testing.assert_array_equal(conf_mask[i].numpy(), np.asarray(ref.conf_mask))
        logits = jnp.log(jnp.maximum(jnp.asarray(ref.conf_mask, jnp.float32), 1e-12))
        samples.append(np.asarray(jax.random.categorical(jax.random.split(keys[i], 2)[0], logits,
                                                         shape=(cfg.ransac_iters, 4))))
    Rt, tt = tinf.run_sequence(tnet, imgs, masks, Ks, verts, feats, cfg=cfg, batch=N_INF,
                               samples=np.stack(samples), device="cpu")
    # the single-image entry point is the batch of one
    one = tinf.estimate_pose_single(tnet, torch.from_numpy(imgs[1]), torch.from_numpy(masks[1]),
                                    torch.from_numpy(Ks[1]), torch.from_numpy(_np(verts)),
                                    torch.from_numpy(feats), samples=torch.from_numpy(samples[1][None]))
    np.testing.assert_allclose(one.R[0].numpy(), Rt[1], atol=1e-6)
    return dict(jnet=jnet, qmaps=qmaps, tnet=tnet, imgs=imgs, Ks=Ks, masks=masks, Rj=Rj, tj=tj, Rt=Rt, tt=tt)


def test_inference_poses_match(inference_state, slice_state):
    inf, st = inference_state, slice_state
    assert inf["Rt"].shape == (N_INF, 3, 3) and inf["tt"].shape == (N_INF, 3)
    # identical correspondences and hypotheses; the f32 P3P roots and ten
    # Gauss-Newton steps differ in rounding only
    np.testing.assert_allclose(inf["Rt"], inf["Rj"], atol=1e-3)
    np.testing.assert_allclose(inf["tt"], inf["tj"], atol=1e-3, rtol=1e-3)
    s1 = st["halves"][1]
    verts_real = st["jout"][0][: artifacts.load_keys(artifacts.pose_dir(str(st["root"] / "jax"), 1))[3]]
    R_gt, t_gt = np.array(s1.R_bop[:N_INF]), np.array(s1.t_bop[:N_INF]) * st["scale"]
    add_j = [float(jmetrics.add_metric(jnp.asarray(verts_real), R_gt[i], t_gt[i], inf["Rj"][i], inf["tj"][i]))
             for i in range(N_INF)]
    add_t = tmetrics.add_metric(torch.from_numpy(_np(verts_real)), torch.from_numpy(R_gt),
                                torch.from_numpy(_np(t_gt)), torch.from_numpy(inf["Rt"]), torch.from_numpy(inf["tt"]))
    np.testing.assert_allclose(add_t.numpy(), add_j, rtol=1e-2, atol=1e-4)
    # and the poses are right: median ADD under the 0.1 * diameter bar (16^2
    # query pixels against ~900 keys quantize the correspondences)
    assert float(np.median(add_t.numpy())) < 0.1 * st["diam"] * st["scale"], add_t


def test_registration_from_those_poses(inference_state, slice_state):
    inf, st = inference_state, slice_state
    s1 = st["halves"][1]
    scale = st["scale"]
    n_real = artifacts.load_keys(artifacts.pose_dir(str(st["root"] / "jax"), 1))[3]
    verts_real = _np(st["jout"][0][:n_real])
    R_gt, t_gt = np.asarray(s1.R_bop[:N_INF]), np.asarray(s1.t_bop[:N_INF]) * scale
    sub = verts_real[:: max(n_real // 4000, 1)]
    bj, cj = jreg.verify_consecutive(sub, R_gt, t_gt, inf["Rj"], inf["tj"], mesh=None)
    bt, ct = treg.verify_consecutive(sub, R_gt, t_gt, inf["Rt"], inf["tt"], device="cpu")
    assert bt == bj
    np.testing.assert_allclose(ct, cj, rtol=1e-2, atol=1e-4)
    cad_pts, ok = jsyn.analytic_surface_points(4000, jax.random.PRNGKey(9))
    cad = np.asarray(cad_pts)[np.asarray(ok)] * scale
    lower = cad[cad[:, 2] < 2]
    kw = dict(diameter=st["diam"] * scale, icp_threshold=0.2 * scale, icp_iters=20)
    oj = jreg.register_halves(verts_real, lower, R_gt[bj], t_gt[bj], inf["Rj"][bj], inf["tj"][bj], cad,
                              mesh=None, **kw)
    ot = treg.register_halves(verts_real, lower, R_gt[bt], t_gt[bt], inf["Rt"][bt], inf["tt"][bt], cad, device="cpu",
                              **kw)
    np.testing.assert_allclose(ot["chamfer"], oj["chamfer"], rtol=1e-2)
    assert ot["correct"] == oj["correct"]


def test_reference_reads_port_artifacts(inference_state, slice_state):
    inf, st = inference_state, slice_state
    pose = artifacts.pose_dir(str(st["root"] / "port"), 1)
    assert sorted(os.listdir(pose)) == ["feat1_scaled.npy", "n_keys.npy", "normals_scaled.npy", "vert1_scaled.npy"]
    verts, feats, _, n_real = artifacts.load_keys(pose, trim=False)
    assert verts.shape[0] > n_real > 0
    feats = _unit(feats)
    # the reference's inference on the port's keys: poses as good as on its own
    R, t = jinf.run_sequence(inf["jnet"], jnp.asarray(inf["qmaps"]), inf["imgs"], inf["masks"], inf["Ks"], verts,
                             feats, batch=N_INF, mesh=None)
    assert R.shape == (N_INF, 3, 3) and np.isfinite(R).all() and np.isfinite(t).all()
    s1 = st["halves"][1]
    R_gt, t_gt = np.asarray(s1.R_bop[:N_INF]), np.asarray(s1.t_bop[:N_INF]) * st["scale"]
    adds = [float(jmetrics.add_metric(jnp.asarray(verts[:n_real]), R_gt[i], t_gt[i], R[i], t[i]))
            for i in range(N_INF)]
    assert float(np.median(adds)) < 0.1 * st["diam"] * st["scale"], adds
