"""The port's SurfEmb inference against the JAX package's, on the CPU: border
``grid_sample``, batched P3P, the point-splat z-buffer, the camera and
renderer helpers, hypothesis sampling and scoring (``estimate_pose``),
gradient refinement (``refine_pose``), the single-image and sequence
estimators and the full-frame crop path.

Where the reference draws random numbers the port is handed the same
draws.  ``estimate_pose`` is compared slot for slot on draws moved off the
two causes of divergence, each counted: every inversion uniform goes to the
middle of its f64 cdf bin (the reference's f32 ``cumsum`` moves a draw that
falls within its rounding of a bin edge; the test shows the raw draws move
only there), and each hypothesis whose P3P triple is ill-posed (the two
packages' f32 Grunert roots differ in validity or by more than 1e-3) is
replaced by a well-posed one.  Tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import InferenceConfig as JInferenceConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry.rotations import rotvec_to_matrix
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import grid_sample as jgs
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import pnp as jpnp
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import rasterize as jras
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import inference as jinf
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import pose_est_surf as jpes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import pose_refine as jpr
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import raymarch as jrm
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import renderer as jrend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as tcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import grid_sample as tgs
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp as tpnp
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import rasterize as tras
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference as tinf
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf as tpes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine as tpr
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer as trend

torch.set_num_threads(1)

S = 48          # a 16 x 16 correspondence grid at stride 3
P, PE = 512, 128


def T(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def A(x):
    return np.asarray(x)


def sharp_features(pts):
    """A high-frequency injective descriptor (refinement needs features that
    change quickly on the surface), normalized to norm 3."""
    f = jnp.concatenate([jnp.sin(14.0 * pts), jnp.cos(11.0 * pts), jnp.sin(17.0 * pts[..., ::-1]), 2.0 * pts],
                        axis=-1)
    return 3.0 * f / jnp.linalg.norm(f, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def scene():
    """The reference's analytic view 0 at S px, its surface keys (CAD
    scale), ideal query maps (the keys of each pixel's surface point) and
    mask logits, for the smooth and the sharp descriptor."""
    sc = jsyn.make_scene(n_views=1, image_size=S)
    pts, ok = jsyn.analytic_surface_points(1500, jax.random.PRNGKey(3))
    pts_n = pts[np.asarray(ok)]
    scale = sc.diameter / 1.8
    cam = jcam.camera_from_bop(sc.R_bop, sc.t_bop, sc.K, S)[0]
    z = np.abs(A(sc.t_bop)[:, 2])
    _, weights, bundle = jrend.render_grid_chunked(lambda p, d, m: jsyn.analytic_field(p, d, m), cam, S, 96,
                                                   float(z.min() - 2), float(z.max() + 2), mode="feature",
                                                   threshold_mode=True, threshold=0.5, chunk=S * S)
    pos = jrm.surface_points(bundle.origins, bundle.directions, bundle.lengths, weights)
    valid = (A(sc.sils[0]) > 0.5) & (A(weights.sum(-1)) > 0).reshape(S, S)
    K_inf = A(sc.K[0]).copy()
    K_inf[0:2, 2] -= 0.5
    return dict(
        verts=(A(pts_n) * scale).astype(np.float32),
        normals=A(pts_n / jnp.linalg.norm(pts_n, axis=-1, keepdims=True)).astype(np.float32),
        feats=A(jsyn.analytic_features(pts_n)).astype(np.float32),
        sharp=A(sharp_features(pts_n)).astype(np.float32),
        qmap=A(jsyn.analytic_features(pos)).reshape(S, S, 12).astype(np.float32),
        qsharp=(A(sharp_features(pos)).reshape(S, S, 12) * valid[..., None]).astype(np.float32),
        mask_lgts=(A(sc.sils[0]) * 12.0 - 6.0).astype(np.float32),
        K=K_inf.astype(np.float32), diam=float(sc.diameter * scale),
        R_gt=A(sc.R_bop[0]).astype(np.float32), t_gt=(A(sc.t_bop[0]) * scale).astype(np.float32),
    )


# ------------------------------------------------------------------ the ops


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_border_matches_reference(mode, align_corners):
    """Values equal to 1e-6 (taps past every edge included); the bilinear
    grid's gradient against ``jax.grad`` to 1e-5."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, size=(2, 60, 2)).astype(np.float32)
    kw = dict(mode=mode, align_corners=align_corners, padding_mode="border")
    want = A(jgs.grid_sample(jnp.asarray(img), jnp.asarray(grid), **kw))
    g = T(grid).requires_grad_(True)
    got = tgs.grid_sample(T(img), g, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    if mode == "bilinear":
        w = rng.normal(size=want.shape).astype(np.float32)
        gj = A(jax.grad(lambda x: (jgs.grid_sample(jnp.asarray(img), x, **kw) * w).sum())(jnp.asarray(grid)))
        (gt,) = torch.autograd.grad((got * T(w)).sum(), g)
        np.testing.assert_allclose(gt.numpy(), gj, atol=1e-5)


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return (q * np.linalg.det(q)).astype(np.float32)


def test_solve_p3p_batch_matches_reference():
    """P triples of planted poses, pixels 20+ apart.  Validity equal on 95 %
    of roots or more; a root valid in one package only is a near-double
    root (the real-root test is ill-conditioned there: another valid root
    within 3e-2 of its t) or a spurious one (0.1 or more off the planted
    pose).  Each package finds the planted pose among its valid roots to
    3e-2 on the same triples, but for 5 % (f32 Grunert misses noise-free
    poses by ~2e-2, and on ~13 % of these triples the reference's roots
    miss it altogether; ROADMAP C)."""
    rng = np.random.default_rng(1)
    K = np.float32([[100.0, 0, 24.0], [0, 100.0, 24.0], [0, 0, 1]])
    p3d, p2d, planted = [], [], []
    while len(p3d) < P:
        R, t = _rotation(rng), np.float32([0.05, -0.05, 4.0])
        pts = rng.uniform(-0.6, 0.6, size=(3, 3)).astype(np.float32)
        xc = pts @ R.T + t
        uv = xc[:, :2] / xc[:, 2:] * 100.0 + 24.0
        if np.min([np.linalg.norm(uv[i] - uv[j]) for i, j in ((0, 1), (1, 2), (0, 2))]) > 20:
            p3d.append(pts)
            p2d.append(uv.astype(np.float32))
            planted.append(np.concatenate([R.reshape(-1), t / 4.0]))
    p3d, p2d, planted = np.stack(p3d), np.stack(p2d), np.stack(planted)
    Rj, tj, vj = map(A, jpnp.solve_p3p_batch(jnp.asarray(p3d), jnp.asarray(p2d), jnp.asarray(K)))
    Rt, tt, vt = (x.numpy() for x in tpnp.solve_p3p_batch(T(p3d), T(p2d), T(K)))
    assert Rt.shape == (P, 4, 3, 3) and tt.shape == (P, 4, 3)
    flips = np.argwhere(vt != vj)
    assert len(flips) <= 0.05 * vj.size
    for h, r in flips:
        R_r, t_r = (Rt[h, r], tt[h, r]) if vt[h, r] else (Rj[h, r], tj[h, r])
        near = [np.abs(x[h, k] - t_r).max() for x, v in ((tt, vt), (tj, vj)) for k in range(4) if k != r and v[h, k]]
        off = np.abs(np.concatenate([R_r.reshape(-1), t_r / 4.0]) - planted[h]).max()
        assert min(near, default=np.inf) < 3e-2 * np.abs(t_r).max() or off > 0.1, (h, r)
    found = []
    for R_, t_, v in ((Rj, tj, vj), (Rt, tt, vt)):
        pose = np.concatenate([R_.reshape(P, 4, 9), t_ / 4.0], -1)
        found.append(np.where(v, np.abs(pose - planted[:, None]).max(-1), np.inf).min(1) < 3e-2)
    assert found[0].mean() > 0.8 and (found[0] == found[1]).mean() >= 0.95


def test_render_object_coords_matches_reference(scene):
    """Coordinates and mask equal, at the GT pose and a perturbed one; a
    pixel may differ only where its winner sits at a half-pixel rounding
    or an equal-depth tie (none does here)."""
    for dw, dt in ((np.zeros(3), np.zeros(3)), (np.float32([0.02, -0.015, 0.02]), np.float32([0.1, -0.08, 0.3]))):
        R = A(rotvec_to_matrix(jnp.asarray(dw, jnp.float32))) @ scene["R_gt"]
        t = scene["t_gt"] + dt * scene["diam"] / 3.0
        cj, mj = jras.render_object_coords(jnp.asarray(scene["verts"]), jnp.asarray(R), jnp.asarray(t),
                                           jnp.asarray(scene["K"]), S)
        ct, mt = tras.render_object_coords(T(scene["verts"]), T(R), T(t), T(scene["K"]), S)
        assert 0.05 < float(mt.mean()) < 0.95
        np.testing.assert_array_equal(mt.numpy(), A(mj))
        np.testing.assert_array_equal(ct.numpy(), A(cj))


def test_camera_helpers_match_reference():
    """ndc_to_pixel / project_points (the plain broadcast: the reference
    writes it component-wise only for a TPU miscompile) to 1e-5, crop_K
    and surfemb_crop_M to 1e-6."""
    rng = np.random.default_rng(2)
    xy = rng.uniform(-1, 1, size=(5, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.ndc_to_pixel(T(xy), 64).numpy(), A(jcam.ndc_to_pixel(jnp.asarray(xy), 64)),
                               atol=1e-5)
    R = np.stack([A(rotvec_to_matrix(jnp.asarray(rng.normal(size=3), jnp.float32))) for _ in range(3)])
    t = np.float32([[0.1, 0.2, 4.0], [-0.3, 0.1, 3.5], [0.0, 0.0, 5.0]])
    K = np.broadcast_to(np.float32([[130.0, 0, 31.0], [0, 128.0, 33.0], [0, 0, 1]]), (3, 3, 3)).copy()
    jc = jcam.camera_from_bop(jnp.asarray(R), jnp.asarray(t), jnp.asarray(K), 64)
    tc = tcam.camera_from_bop(T(R), T(t), T(K), 64)
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32) * 0.5
    for sl in (slice(None), 1):
        xj, zj = jcam.project_points(jc[sl], jnp.asarray(pts[sl]))
        xt, zt = tcam.project_points(tc[sl], T(pts[sl]))
        np.testing.assert_allclose(xt.numpy(), A(xj), atol=1e-5)
        np.testing.assert_allclose(zt.numpy(), A(zj), atol=1e-5)
    args = (13.0, 7.0, 60.0, 21.5, 18.0, 120.0, 64)
    np.testing.assert_allclose(tcam.crop_K(T(K), *args).numpy(), A(jcam.crop_K(jnp.asarray(K), *args)), atol=1e-6)
    for box in ((10, 20, 31, 17), (3, 5, 12, 40)):
        for got, want in zip(tcam.surfemb_crop_M(*box, device="cpu"), jcam.surfemb_crop_M(*box)):
            np.testing.assert_allclose(got.numpy(), A(want), atol=1e-6)


def test_masked_ray_indices_and_render_depth():
    """The reference's categorical draw is argmax(logits + Gumbel noise):
    handed the same noise, the port picks the same pixels; drawn from a
    generator, every pixel lies in the silhouette.  render_depth equal."""
    rng = np.random.default_rng(3)
    sil = (rng.uniform(size=(12, 12)) > 0.7).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = A(jrend.masked_ray_indices(jnp.asarray(sil), 40, key))
    gumbel = A(jax.random.gumbel(key, (40, sil.size)))
    np.testing.assert_array_equal(trend.masked_ray_indices(T(sil), 40, gumbel=T(gumbel)).numpy(), want)
    drawn = trend.masked_ray_indices(T(sil), 500, generator=torch.Generator().manual_seed(0)).numpy()
    assert (sil.reshape(-1)[drawn] > 0.5).all() and len(set(drawn.tolist())) > 0.8 * sil.sum()
    lengths = rng.uniform(2, 6, size=(7, 16)).astype(np.float32)
    w = rng.uniform(size=(7, 16)).astype(np.float32)
    jb = jcam.RayBundle(None, None, jnp.asarray(lengths), None)
    tb = tcam.RayBundle(None, None, T(lengths), None)
    np.testing.assert_array_equal(trend.render_depth(tb, T(w)).numpy(), A(jrend.render_depth(jb, jnp.asarray(w))))


# ----------------------------------------------------- hypotheses and scoring


def reference_cdf(mask_lgts, qmap, feats, ds=3, alpha=1.5):
    """The reference's f32 cdf of corr ** alpha (pose_est_surf.py:102-129)."""
    md = jpes._avg_pool(jnp.asarray(mask_lgts), ds)
    n = md.shape[0] * md.shape[1]
    q = jpes._avg_pool(jnp.asarray(qmap), ds).reshape(n, -1)
    logits = jnp.matmul(q, jnp.asarray(feats).T, precision=jax.lax.Precision.HIGHEST)
    corr = jnp.exp(jax.nn.log_softmax(logits, axis=1)) * jax.nn.sigmoid(md).reshape(n)[:, None]
    cdf = jnp.cumsum(corr.reshape(-1) ** alpha)
    return A(cdf / cdf[-1])


def port_distribution(mask_lgts, qmap, feats, ds=3, alpha=1.5):
    """The port's (pooled corr_log, f64 cdf, mask terms, grid side)."""
    mlp, nmlp, mp = tpes.mask_terms(T(mask_lgts), ds)
    res = mask_lgts.shape[0] // ds
    q = tpes._avg_pool(T(qmap), ds).reshape(res * res, -1)
    corr_log, cdf = tpes.correspondence_distribution(q, T(feats), mp, alpha)
    return tpes._max_pool_3x3_keys(corr_log, res), cdf, (mlp, nmlp), res


def test_cdf_draws_move_only_at_bin_edges(scene):
    """On the reference's own uniforms the port's f64 cdf and the
    reference's f32 cdf pick the same flat index, except where u lies
    within 1e-6 of the edge of the port's bin (the f32 cdf's rounding);
    the port's cdf is monotone and ends at 1."""
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    u = A(jax.random.uniform(key, (2000, 4))).reshape(-1)
    cdf_j = reference_cdf(scene["mask_lgts"], scene["qmap"], scene["feats"])
    _, cdf_t, _, _ = port_distribution(scene["mask_lgts"], scene["qmap"], scene["feats"])
    cdf_t = cdf_t.view(-1).numpy()
    assert cdf_t[-1] == 1.0 and (np.diff(cdf_t) >= 0).all()
    got = tpes.inverse_cdf(torch.from_numpy(cdf_t), torch.from_numpy(u)).numpy()
    want = np.searchsorted(cdf_j, u)
    moved = got != want
    lo = np.where(got > 0, cdf_t[np.maximum(got - 1, 0)], 0.0)
    edge = np.minimum(np.abs(u - lo), np.abs(cdf_t[got] - u))
    assert (edge[moved] < 1e-6).all(), edge[moved]
    assert moved.sum() <= 0.01 * u.size


def well_posed_draws(scene, key, max_poses, tol=1e-3, reference_p3p=jpnp.solve_p3p_batch):
    """The reference's draws of ``key`` (inversion and root-pick uniforms),
    each inversion uniform moved to the middle of its f64 cdf bin, and each
    hypothesis whose triple is ill-posed (the packages' roots differ in
    validity or by more than ``tol``), or has a draw in a bin too narrow for
    the reference's f32 cdf, replaced by a well-posed one; the roots are
    ``reference_p3p``'s, eager unless the caller compiles it as its
    reference does.  Returns (u, pick, number replaced)."""
    k_samp, k_sol = jax.random.split(key)
    u = A(jax.random.uniform(k_samp, (max_poses, 4))).astype(np.float64)
    pick = A(jax.random.uniform(k_sol, (max_poses, 4)))
    _, cdf_t, _, res = port_distribution(scene["mask_lgts"], scene["qmap"], scene["feats"])
    cdf_t = cdf_t.view(-1).numpy()
    idx = np.searchsorted(cdf_t, u)
    lo = np.where(idx > 0, cdf_t[np.maximum(idx - 1, 0)], 0.0)
    u = ((lo + cdf_t[idx]) / 2).astype(np.float32)
    idx = np.searchsorted(cdf_t, u.astype(np.float64))
    # draws in a bin narrower than the f32 cdf's rounding move all the same
    same_bin = (np.searchsorted(reference_cdf(scene["mask_lgts"], scene["qmap"], scene["feats"]), u) == idx).all(1)
    m = scene["verts"].shape[0]
    p3, p2 = idx % m, idx // m
    p2d = np.stack([p2 % res, p2 // res], -1).astype(np.float32)
    Kd = A(jcam.downsample_K(jnp.asarray(scene["K"]), 3))
    Rj, tj, vj = map(A, reference_p3p(jnp.asarray(scene["verts"][p3[:, :3]]), jnp.asarray(p2d[:, :3]),
                                      jnp.asarray(Kd)))
    Rt, tt, vt = (x.numpy() for x in tpnp.solve_p3p_batch(T(scene["verts"][p3[:, :3]]), T(p2d[:, :3]), T(Kd)))
    t_max = np.nanmax(np.where(vj[..., None], np.abs(tj), 0))
    good = (same_bin & (vj == vt).all(1)
            & (np.where(vj[..., None, None], np.abs(Rj - Rt), 0).max((1, 2, 3)) < tol)
            & (np.where(vj[..., None], np.abs(tj - tt), 0).max((1, 2)) < tol * t_max))
    fill = np.flatnonzero(good)
    rep = np.where(good, np.arange(max_poses), fill[np.arange(max_poses) % len(fill)])
    return u[rep], pick[rep], int((~good).sum())


class _Uniforms:
    """``jax.random.uniform`` replaced: its first call returns ``u``, the
    second ``pick`` (the order of the reference's draws)."""

    def __init__(self, monkeypatch, u, pick):
        self.out = [jnp.asarray(u), jnp.asarray(pick)]
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **kw: self.out.pop(0))


def _compare_hypotheses(got, want, score_atol):
    """Slot for slot: validity equal; R to 1e-3 and t to 1e-3 of its scale on
    valid slots (f32 Grunert); the scores to ``score_atol`` there."""
    vj = A(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), vj)
    assert vj.sum() >= 10
    np.testing.assert_allclose(got.R.numpy()[vj], A(want.R)[vj], atol=1e-3)
    t_j = A(want.t)[vj]
    np.testing.assert_allclose(got.t.numpy()[vj], t_j, atol=1e-3 * np.abs(t_j).max())
    for f in ("pose_scores", "mask_scores", "coord_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy()[vj], A(getattr(want, f))[vj], atol=score_atol, err_msg=f)
    np.testing.assert_array_equal(np.isfinite(got.pose_scores.numpy()), np.isfinite(A(want.pose_scores)))


def test_estimate_pose_matches_reference_slot_for_slot(scene, monkeypatch):
    """max_poses 512, 128 evaluations.  Scores to 1e-2: the poses differ by
    up to 1e-3 (f32 P3P), which moves a few reprojected points across a
    pixel's rounding edge and so changes a pixel's winner (the scoring
    alone on the reference's own poses is held tighter below)."""
    u, pick, replaced = well_posed_draws(scene, jax.random.PRNGKey(0), P)
    assert replaced < P // 3
    args = [scene[k] for k in ("mask_lgts", "qmap", "verts", "normals", "feats")]
    got = tpes.estimate_pose(*map(T, args), scene["diam"], T(scene["K"]), max_poses=P, max_pose_evaluations=PE,
                             draws=tpes.HypothesisDraws(T(u), T(pick)))
    _Uniforms(monkeypatch, u, pick)
    want = jpes.estimate_pose.__wrapped__(*map(jnp.asarray, args), scene["diam"], jnp.asarray(scene["K"]),
                                          jax.random.PRNGKey(0), max_poses=P, max_pose_evaluations=PE)
    _compare_hypotheses(got, want, 1e-2)


def test_score_poses_on_the_reference_poses(scene):
    """The port's scoring of the reference's own hypotheses (its R, t) gives
    the reference's mask and coord scores to 1e-5, pose for pose."""
    args = [jnp.asarray(scene[k]) for k in ("mask_lgts", "qmap", "verts", "normals", "feats")]
    want = jpes.estimate_pose(*args, scene["diam"], jnp.asarray(scene["K"]), jax.random.PRNGKey(2),
                              max_poses=P, max_pose_evaluations=PE)
    corr_log, _, (mlp, nmlp), res = port_distribution(scene["mask_lgts"], scene["qmap"], scene["feats"])
    Kd = tcam.downsample_K(T(scene["K"]), 3)
    ms, cs = tpes.score_poses(T(want.R), T(want.t), Kd, T(scene["verts"]), corr_log, mlp, nmlp, res)
    fin = np.isfinite(A(want.coord_scores))
    assert fin.sum() > PE // 2
    np.testing.assert_allclose(ms.numpy(), A(want.mask_scores), atol=1e-5)
    np.testing.assert_array_equal(np.isfinite(cs.numpy()), fin)
    np.testing.assert_allclose(cs.numpy()[fin], A(want.coord_scores)[fin], atol=1e-5)


# --------------------------------------------------------------- refinement


@pytest.mark.parametrize("kw", [dict(n_steps=6), dict(n_steps=6, translation_only=True),
                                dict(n_steps=5, lr=1e-3), dict(n_steps=5, lr=1e-3, translation_only=True)],
                         ids=["bfgs", "bfgs-t", "descent", "descent-t"])
def test_refine_pose_matches_reference(scene, kw):
    """From a perturbed GT pose on the sharp descriptor, with the reference's
    denominator permutation handed in: R and t to 1e-5, the objective to
    1e-5 relative (f32 sums in another order); the pose moved."""
    R0 = A(rotvec_to_matrix(jnp.asarray([0.02, -0.015, 0.02]))) @ scene["R_gt"]
    t0 = scene["t_gt"] + np.float32([0.1, -0.08, 0.3]) * scene["diam"] / 3.0
    key = jax.random.PRNGKey(0)
    sel = A(jax.random.permutation(key, scene["verts"].shape[0]))
    ref = jpr.refine_pose.__wrapped__ if kw.get("lr") else jpr.refine_pose  # lr > 0 does not trace
    Rj, tj, fj = ref(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(scene["qsharp"]), jnp.asarray(scene["K"]),
                     jnp.asarray(scene["verts"]), jnp.asarray(scene["sharp"]), key, **kw)
    Rt, tt, ft = tpr.refine_pose(T(R0), T(t0), T(scene["qsharp"]), T(scene["K"]), T(scene["verts"]),
                                 T(scene["sharp"]), sel=torch.from_numpy(sel), **kw)
    np.testing.assert_allclose(Rt.numpy(), A(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), A(tj), atol=1e-5 * np.abs(t0).max())
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-5)
    assert np.abs(A(tj) - t0).max() > 1e-3 * np.abs(t0).max()
    if kw.get("translation_only"):
        np.testing.assert_array_equal(Rt.numpy(), R0)


# ----------------------------------------------------- the image estimators


class _JaxMaps:
    """A CNN stand-in of the reference: the ideal query map and mask logits."""

    def __init__(self, maps):
        self.maps = jnp.asarray(maps)

    def apply(self, params, images):
        return jnp.broadcast_to(self.maps, (images.shape[0],) + self.maps.shape)


class _TorchMaps(torch.nn.Module):
    """The port's stand-in: one map per image of the batch (by its first
    pixel's value, so a sequence can show each image its own map)."""

    def __init__(self, maps):
        super().__init__()
        self.maps = T(maps)
        self.anchor = torch.nn.Parameter(torch.zeros(0), requires_grad=False)

    def forward(self, images):
        return self.maps[images[:, 0, 0, 0].long()]


SMALL = dict(max_poses=P, max_pose_evaluations=96)


def test_estimate_pose_surfemb_matches_reference(scene, monkeypatch):
    """The whole single-image path (CNN -> hypotheses -> best -> 5 BFGS
    steps), the reference handed the well-posed draws of its key's split and
    its refiner's permutation.  Unrefined: R to 1e-3, t to 1e-3 of its
    scale, the best score to 1e-2 (as the slot-for-slot test; this key's
    best hypothesis leads the next by 0.044).  Refined: the port's
    refinement of the reference's own best pose gives the reference's
    refined pose to 1e-4 (from the port's own best, 1e-3 apart, five BFGS
    steps on the smooth descriptor move the pose by up to 0.4: the line
    search branches apart)."""
    maps = np.concatenate([scene["qmap"], scene["mask_lgts"][..., None]], -1)
    key = jax.random.PRNGKey(7)
    k_est, k_ref = jax.random.split(key)
    u, pick, _ = well_posed_draws(scene, k_est, SMALL["max_poses"])
    sel = A(jax.random.permutation(k_ref, scene["verts"].shape[0]))
    uniforms = _Uniforms(monkeypatch, u, pick)
    uniforms.out *= 2
    # op by op, as the draws were checked against (compiled, XLA computes
    # the cdf's f32 cumsum in another order, which moves edge draws again)
    monkeypatch.setattr(jpes, "estimate_pose", jpes.estimate_pose.__wrapped__)
    image = np.zeros((S, S, 3), np.float32)
    keys_j = [jnp.asarray(scene[k]) for k in ("verts", "normals", "feats")]
    keys_t = [T(scene[k]) for k in ("verts", "normals", "feats")]
    draws = tinf.SurfEmbDraws(T(u), T(pick), torch.from_numpy(sel))
    out = {}
    for refine in (False, True):
        out["j", refine] = jinf.estimate_pose_surfemb(
            _JaxMaps(maps), None, jnp.asarray(image), jnp.asarray(scene["K"]), *keys_j, scene["diam"], key,
            cfg=JInferenceConfig(**SMALL), refine=refine, refine_steps=5)
        out["t", refine] = tinf.estimate_pose_surfemb(_TorchMaps(maps[None]), T(image), T(scene["K"]), *keys_t,
                                                      scene["diam"], cfg=InferenceConfig(**SMALL), draws=draws,
                                                      refine=refine, refine_steps=5)
    (Rj, tj, sj), (Rt, tt, st) = out["j", False], out["t", False]
    np.testing.assert_allclose(Rt.numpy(), A(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), A(tj), atol=1e-3 * np.abs(A(tj)).max())
    assert abs(st - float(sj)) < 1e-2 and np.isfinite(st)
    assert out["t", True][2] == st and out["j", True][2] == sj
    Rr, tr, _ = tpr.refine_pose(T(Rj), T(tj), T(maps[..., :12]), T(scene["K"]), T(scene["verts"]), T(scene["feats"]),
                                n_steps=5, sel=torch.from_numpy(sel))
    np.testing.assert_allclose(Rr.numpy(), A(out["j", True][0]), atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), A(out["j", True][1]), atol=1e-4 * np.abs(A(tj)).max())
    assert np.isfinite(out["t", True][0].numpy()).all() and np.isfinite(out["t", True][1].numpy()).all()


def test_run_sequence_surfemb_is_the_per_image_calls(scene):
    """A sequence of 3 images (each its own map) equals the per-image calls,
    bit for bit: with the draws handed in, and with one generator drawn by
    each image in turn."""
    maps = np.concatenate([scene["qmap"], scene["mask_lgts"][..., None]], -1)
    shifted = np.roll(maps, 3, axis=1)
    net = _TorchMaps(np.stack([maps, shifted, maps]))
    images = np.stack([np.full((S, S, 3), i, np.float32) for i in range(3)])
    Ks = np.stack([scene["K"]] * 3)
    cfg = InferenceConfig(max_poses=256, max_pose_evaluations=64)
    keys = [T(scene[k]) for k in ("verts", "normals", "feats")]
    g = torch.Generator().manual_seed(5)
    draws = [tinf.SurfEmbDraws(torch.rand((256, 4), generator=g), torch.rand((256, 4), generator=g),
                               torch.randperm(scene["verts"].shape[0], generator=g)) for _ in range(3)]
    R, t, s = tinf.run_sequence_surfemb(net, images, Ks, *[k.numpy() for k in keys], scene["diam"], cfg=cfg,
                                        refine_steps=3, draws=draws, device="cpu")
    assert R.shape == (3, 3, 3) and t.shape == (3, 3) and s.shape == (3,) and np.isfinite(s).all()
    gen = torch.Generator().manual_seed(1)
    R2, t2, s2 = tinf.run_sequence_surfemb(net, images, Ks, *keys, scene["diam"], cfg=cfg, refine_steps=3,
                                           seed=1, device="cpu")
    for i in range(3):
        Ri, ti, si = tinf.estimate_pose_surfemb(net, T(images[i]), T(Ks[i]), *keys, scene["diam"], cfg=cfg,
                                                refine_steps=3, draws=draws[i])
        np.testing.assert_array_equal(R[i], Ri.numpy())
        np.testing.assert_array_equal(t[i], ti.numpy())
        assert s[i] == np.float32(si)
        Ri, ti, si = tinf.estimate_pose_surfemb(net, T(images[i]), T(Ks[i]), *keys, scene["diam"], cfg=cfg,
                                                refine_steps=3, generator=gen)
        np.testing.assert_array_equal(R2[i], Ri.numpy())
        np.testing.assert_array_equal(t2[i], ti.numpy())


# ---------------------------------------------------------- the full frame


def _raw_frame():
    """A 90 x 120 frame: a textured ellipse (its visibility mask) off-centre
    on noise, and full-frame intrinsics."""
    rng = np.random.default_rng(9)
    H, W = 90, 120
    yy, xx = np.mgrid[:H, :W]
    mask = (((xx - 78) / 25.0) ** 2 + ((yy - 38) / 18.0) ** 2 <= 1).astype(np.float32)
    frame = rng.uniform(size=(H, W, 3)).astype(np.float32)
    tex = 0.5 + 0.5 * np.sin(np.stack([0.3 * xx, 0.4 * yy, 0.2 * (xx + yy)], -1))
    frame = np.where(mask[..., None] > 0, tex, frame).astype(np.float32)
    K = np.float32([[150.0, 0, 61.0], [0, 152.0, 44.5], [0, 0, 1]])
    return frame, mask, K


def test_surfemb_crop_matches_reference():
    """Crop to 1e-5, its mask equal, camMat to 1e-5 relative, at two crop
    sizes: the frame shrinks and shifts into the crop."""
    frame, mask, K = _raw_frame()
    for crop_res in (48, 64):
        cj, mj, Kj = jinf.surfemb_crop(frame, mask, K, crop_res=crop_res)
        ct, mt, Kt = tinf.surfemb_crop(frame, mask, K, crop_res=crop_res, device="cpu")
        np.testing.assert_allclose(ct.numpy(), A(cj), atol=1e-5)
        np.testing.assert_array_equal(mt.numpy(), A(mj))
        np.testing.assert_allclose(Kt.numpy(), A(Kj), rtol=1e-5, atol=1e-5)
        assert 0.2 < float(mt.mean()) < 0.9
    with pytest.raises(ValueError, match="empty mask"):
        tinf.surfemb_crop(frame, np.zeros_like(mask), K, device="cpu")


_MEAN, _STD = np.float32([0.485, 0.456, 0.406]), np.float32([0.229, 0.224, 0.225])


def _position_features(r, g, xp):
    """Fourier features of a frame position (r = x / W, g = y / H): the dot
    product of two is largest where the positions meet."""
    k = xp.asarray(2 * np.pi * np.arange(1, 4, dtype=np.float32))
    cat = torch.cat if xp is torch else xp.concatenate
    return cat([xp.cos(k * r[..., None]), xp.sin(k * r[..., None]), xp.cos(k * g[..., None]),
                           xp.sin(k * g[..., None])], -1)


def test_estimate_pose_full_frame_matches_reference():
    """A raw 120 x 90 frame whose colours encode each pixel's position, a
    CNN stand-in mapping (de-normalized) colour to position features, and
    600 keys: the features of where each object point projects under a
    planted pose.  The crop's correspondences and confidence mask equal the
    reference's; with its RANSAC draws handed in, the pose is the
    reference's to 1e-4 (a well-posed fit), and near the planted pose."""
    rng = np.random.default_rng(10)
    H, W = 90, 120
    K = np.float32([[150.0, 0, 61.0], [0, 152.0, 44.5], [0, 0, 1]])
    R = A(rotvec_to_matrix(jnp.asarray([0.3, -0.2, 0.1], jnp.float32)))
    t = np.float32([0.15, -0.1, 3.0])
    verts = rng.normal(size=(600, 3)).astype(np.float32)
    verts = 0.5 * verts / np.linalg.norm(verts, axis=-1, keepdims=True) * rng.uniform(size=(600, 1)) ** (1 / 3)
    xc = verts @ R.T + t
    uv = xc[:, :2] / xc[:, 2:] * K[[0, 1], [0, 1]] + K[:2, 2]
    yy, xx = np.mgrid[:H, :W]
    frame = np.stack([xx / W, yy / H, np.full((H, W), 0.5)], -1).astype(np.float32)
    near = np.min((xx.reshape(-1, 1) - uv[:, 0]) ** 2 + (yy.reshape(-1, 1) - uv[:, 1]) ** 2, axis=1) <= 4.0
    mask = near.reshape(H, W).astype(np.float32)
    feats = _position_features(uv[:, 0] / W, uv[:, 1] / H, np).astype(np.float32)

    class JNet:
        def apply(self, params, x):
            c = x * _STD + _MEAN
            return jnp.concatenate([_position_features(c[..., 0], c[..., 1], jnp), jnp.zeros(c.shape[:-1] + (1,))],
                                   -1)

    class TNet(torch.nn.Module):
        def forward(self, x):
            c = x * T(_STD) + T(_MEAN)
            return torch.cat([_position_features(c[..., 0], c[..., 1], torch), torch.zeros(c.shape[:-1] + (1,))], -1)

    cfg = InferenceConfig(crop_res=96)
    key = jax.random.PRNGKey(11)
    want = jinf.estimate_pose_full_frame(JNet(), None, frame, mask, K, jnp.asarray(verts), jnp.asarray(feats), key,
                                         cfg=JInferenceConfig(crop_res=96))
    logits = jnp.log(jnp.maximum(jnp.asarray(want.conf_mask, jnp.float32), 1e-12))
    samples = A(jax.random.categorical(jax.random.split(key, 2)[0], logits, shape=(cfg.ransac_iters, 4)))
    got = tinf.estimate_pose_full_frame(TNet(), frame, mask, K, T(verts), T(feats), cfg=cfg,
                                        samples=torch.from_numpy(samples[None]), device="cpu")
    np.testing.assert_array_equal(got.conf_mask[0].numpy(), A(want.conf_mask))
    assert bool(got.success[0]) and bool(want.success)
    np.testing.assert_allclose(got.R[0].numpy(), A(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t[0].numpy(), A(want.t), atol=1e-4 * np.abs(t).max())
    assert np.abs(got.t[0].numpy() - t).max() < 0.05 * np.abs(t).max()
