"""The correspondence stage, the port against the JAX reference on the CPU:
the new ray and point-cloud ops, ``generate_cors`` end to end on a planted
field (an f32 field, and a tiny bf16 ``fused_kernel=True`` one, where the
reference runs K1 in interpret mode and the port K1's plain version), and
``build_negatives`` on the reference's own draws.

Which neighbour formula each side uses: the reference's ``knn``,
``radius_outlier_mask`` and its CPU ``nn_query`` square distances as
``|a|^2 + |b|^2 - 2 a.b``; the port's ``knn`` and ``radius_outlier_mask``
do too, while its ``nn_query`` (K2's plain version, the mesh filters) takes
exact differences.  A ray or point may flip only where the cause sits at
its threshold: a density within the field's tolerance of the pass's
threshold, a mesh distance within 1e-5 of the filter's, a squared
neighbour distance within 1e-6 of radius^2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import CorsConfig, FieldConfig, PoseTrainConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import pointcloud as jpc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import artifacts as jart
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import generate_cors as jgc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import raymarch as jrm
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import renderer as jrend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import pose_trainer as jpt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import config as tconfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as tcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as tfk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as tpc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import generate_cors as tgc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch as trm
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer as trend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer as tpt

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(cfg):
    return getattr(tconfig, type(cfg).__name__)(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


# ------------------------------------------------------------------ ray ops


def test_back_weights_matches_reference():
    rng = np.random.default_rng(0)
    dens = rng.uniform(size=(6, 17)).astype(np.float32)
    dens[:, ::4] = 0.0
    dens[1] = 0.0
    for mode in (False, True):
        want = np.asarray(jrm.back_weights(jnp.asarray(dens), threshold_mode=mode))
        got = trm.back_weights(_t(dens), threshold_mode=mode).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the peak is on the last crossing: the last sample above the threshold
    w = trm.back_weights(_t(dens), threshold_mode=True).numpy()
    last = np.array([np.flatnonzero(r > 0.05)[-1] if (r > 0.05).any() else -1 for r in dens])
    hit = last >= 0
    assert (w[hit].argmax(-1) == last[hit]).all() and (w[~hit] == 0).all()


@pytest.fixture(scope="module")
def scene():
    return jsyn.make_scene(n_views=4, image_size=40, key=jax.random.PRNGKey(0))


def test_rays_and_back_rays_match_reference(scene):
    S, P = 40, 24
    jc = jcam.camera_from_bop(scene.R_bop, scene.t_bop, scene.K, S)[1]
    tc = tcam.camera_from_bop(*(_t(x) for x in (scene.R_bop, scene.t_bop, scene.K)), S)[1]
    pix = np.random.default_rng(1).choice(S * S, 37, replace=False)
    want = jcam.rays_at_pixels(jc, jnp.asarray(pix), S, P, 2.5, 6.5)
    got = tcam.rays_at_pixels(tc, torch.as_tensor(pix), S, P, 2.5, 6.5)
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=2e-7, err_msg=f)
    # depths within an ulp of the reference's linspace (XLA contracts its
    # formula into an FMA, which torch does not)
    np.testing.assert_allclose(got.lengths[0].numpy(), np.asarray(jnp.linspace(2.5, 6.5, P)), rtol=1.2e-7, atol=0)
    hits = np.random.default_rng(2).normal(size=(37, 3)).astype(np.float32) * 0.3
    want_b = jrend.back_ray_bundle(want, jnp.asarray(hits), div=3.0)
    got_b = trend.back_ray_bundle(got, _t(hits), div=3.0)
    for f in want_b._fields:
        np.testing.assert_allclose(getattr(got_b, f).numpy(), np.asarray(getattr(want_b, f)), atol=1e-6, err_msg=f)


def test_render_rays_chunked_matches_reference(scene):
    """A ragged last chunk (37 rays in chunks of 16) against the reference's
    padded chunks, on an analytic density."""
    S, P = 40, 24
    jc = jcam.camera_from_bop(scene.R_bop, scene.t_bop, scene.K, S)[0]
    tc = tcam.camera_from_bop(*(_t(x) for x in (scene.R_bop, scene.t_bop, scene.K)), S)[0]
    pix = np.random.default_rng(3).choice(S * S, 37, replace=False)

    def jfn(pts, dirs, mode):
        d = jax.nn.sigmoid(10.0 * (0.5 - jnp.linalg.norm(pts, axis=-1, keepdims=True)))
        return d, jnp.concatenate([d, pts], -1)

    def tfn(pts, dirs, mode):
        d = torch.sigmoid(10.0 * (0.5 - torch.linalg.vector_norm(pts, dim=-1, keepdim=True)))
        return d, torch.cat([d, pts], -1)

    for thr in (True, False):
        want = jrend.render_rays_chunked(jfn, jcam.rays_at_pixels(jc, jnp.asarray(pix), S, P, 2.5, 6.5),
                                         threshold_mode=thr, chunk=16)
        got = trend.render_rays_chunked(tfn, tcam.rays_at_pixels(tc, torch.as_tensor(pix), S, P, 2.5, 6.5),
                                        threshold_mode=thr, chunk=16)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)


# -------------------------------------------------------- point-cloud ops


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 64 references for 50-400 queries: several chunks, a ragged
    last one, some shorter than k."""
    monkeypatch.setattr(tpc, "_CHUNK_ELEMS", 64 * 400)


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return (0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True) + 0.01 * rng.normal(size=(n, 3))).astype(np.float32)


def test_knn_matches_reference(small_chunks):
    """Squared distances to f32 rounding; neighbour sets equal but where the
    k-th and (k+1)-th squared distances tie within 1e-6 (the order within a
    set is not compared: torch.topk orders ties as it likes)."""
    q, ref = _cloud(50, 0), _cloud(300, 1)
    mask = np.random.default_rng(2).uniform(size=300) > 0.2
    for k, m in ((8, None), (70, mask)):
        dj, ij = jpc.knn(jnp.asarray(q), jnp.asarray(ref), k, ref_mask=None if m is None else jnp.asarray(m))
        dt, it = tpc.knn(_t(q), _t(ref), k, ref_mask=None if m is None else _t(m))
        np.testing.assert_allclose(dt.numpy() ** 2, np.asarray(dj) ** 2, atol=1e-6)
        d2 = ((q[:, None] - ref[None]) ** 2).sum(-1)
        if m is not None:
            d2 = np.where(m[None], d2, np.inf)
        kth = np.sort(d2, 1)[:, k - 1: k + 1]
        for row in range(q.shape[0]):
            if kth[row, 1] - kth[row, 0] > 1e-6:
                assert set(it[row].tolist()) == set(np.asarray(ij[row]).tolist()), row


def test_radius_outlier_mask_matches_reference(small_chunks):
    pts = _cloud(400, 3)
    valid = np.random.default_rng(4).uniform(size=400) > 0.1
    r = 0.12
    want = np.asarray(jpc.radius_outlier_mask(jnp.asarray(pts), 5, r, mask=jnp.asarray(valid)))
    got = tpc.radius_outlier_mask(_t(pts), 5, r, mask=_t(valid)).numpy()
    assert got.sum() > 50 and (~got).sum() > 10
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    near = (np.abs(d2 - r * r) < 1e-6).any(1)
    assert ((got != want) <= near).all()


def test_normals_and_subsample_match_reference():
    """FPS indices equal; normals up to sign where the two smallest
    eigenvalues of the neighbourhood covariance are apart (eigh's smallest
    eigenvector is ill-conditioned where they are close), and oriented the
    same wherever the outward dot is not near 0."""
    pts = _cloud(600, 5)
    k = 24
    nj = np.asarray(jpc.estimate_normals(jnp.asarray(pts), k=k))
    nt = tpc.estimate_normals(_t(pts), k=k).numpy()
    _, idx = tpc.knn(_t(pts), _t(pts), k)
    nb = pts[idx.numpy()]
    x = nb - nb.mean(1, keepdims=True)
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", x, x) / k)
    apart = (lam[:, 1] - lam[:, 0]) > 1e-2 * lam[:, 2]
    assert apart.mean() > 0.9
    np.testing.assert_allclose(np.abs((nj * nt).sum(-1))[apart], 1.0, atol=1e-4)
    sj, nsj, ij = jpc.subsample_surface(jnp.asarray(pts), 150, 32)
    st, nst, it = tpc.subsample_surface(_t(pts), 150, 32)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    outward = np.abs((nst.numpy() * (st.numpy() - st.numpy().mean(0))).sum(-1)) > 1e-3
    np.testing.assert_allclose((nst.numpy() * np.asarray(nsj)).sum(-1)[outward], 1.0, atol=1e-3)


# ---------------------------------------------------------- generate_cors


def planted(cfg, seed=3):
    """The planted shell, moved off the grid's symmetries by a low-frequency
    tilt (so FPS meets no exact ties)."""
    p = convert.planted_field_params(_port(cfg), seed=0)
    rng = np.random.default_rng(seed)
    k, H = p["params"]["trunk1"]["kernel"], cfg.n_harmonic_functions
    for d in range(3):
        k[d * H + 1, 0] = rng.uniform(0.3, 0.6)
        k[d * H + 2, 0] = rng.uniform(-0.3, 0.3)
    return p


# (name, field, S, grid, points a ray, views, density tolerance of the cause)
CASES = {
    # flax and the port's eager density agree to f32 rounding
    "f32": (FieldConfig(n_harmonic_functions=8, n_hidden=48, compute_dtype="float32"), 40, 32, 64, 4, 1e-5),
    # the reference's K1 in interpret mode against K1's plain version: the
    # same roundings, f32 sums in another order (the bf16 rounding of a
    # trunk output may flip, ~1e-2 at most)
    "bf16_kernel": (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", fused_kernel=True),
                    24, 24, 32, 2, 2e-2),
}


def _cors_cfg(S, P):
    return CorsConfig(render_size=S, grid_pts_per_ray=P, density_threshold=0.2, mesh_filter_dist=0.15,
                      outlier_nb_points=4, outlier_radius=0.2, n_subsurface=100, normals_k=32)


@pytest.fixture(scope="module", params=sorted(CASES))
def cors_pair(request, tmp_path_factory):
    name = request.param
    cfg, S, G, P, V, tol = CASES[name]
    sc = jsyn.make_scene(n_views=V, image_size=S, key=jax.random.PRNGKey(0))
    p = planted(cfg)
    cc = _cors_cfg(S, P)
    root = tmp_path_factory.mktemp(f"cors_{name}")
    jf = jfields.NerfField(cfg)
    jdir = jgc.generate_cors(jf, jax.tree.map(jnp.asarray, p), sc.R_bop, sc.t_bop, sc.K, sc.sils, str(root / "jax"),
                             1, cc, grid_res=G, mesh=None)
    tf = tfields.NerfField(_port(cfg))
    tf.load_state_dict(convert.params_from_jax(p))
    args = tuple(np.array(x) for x in (sc.R_bop, sc.t_bop, sc.K, sc.sils))
    tdir = tgc.generate_cors(tf, *args, str(root / "port"), 1, _port(cc), grid_res=G, device="cpu")
    return dict(name=name, cfg=cfg, S=S, G=G, P=P, V=V, tol=tol, cc=cc, field=tf, args=args, params=p,
                jdir=jdir, tdir=tdir, root=root)


def _pixels(xys, S):
    col = np.rint((1.0 - xys[:, 0]) * S / 2.0 - 0.5).astype(np.int64)
    row = np.rint((1.0 - xys[:, 1]) * S / 2.0 - 0.5).astype(np.int64)
    return row * S + col


def _near_threshold(c, view: int, pix: np.ndarray) -> np.ndarray:
    """Per pixel of view ``view``: does a cause of a flip sit at its
    threshold (a front or back sample's density within the case's
    tolerance of 0.2 / 0.05, a front or back hit within 1e-5 of the mesh
    filter's distance)?"""
    R, t, K, _ = c["args"]
    S, P, cc = c["S"], c["P"], c["cc"]
    z = np.abs(t[:, 2])
    lo, hi = float(z.min() - 2.0), float(z.max() + 2.0)
    cam = tcam.camera_from_bop(_t(R), _t(t), _t(K), S)[view]
    a1 = _t(jart.load_array(c["tdir"], "a1.npy"))
    pix_t = torch.as_tensor(pix)
    out = tgc.view_surface_hits(c["field"], cam, pix_t, a1, S, P, lo, hi, cc.density_threshold,
                                cc.mesh_filter_dist, cc.back_len_div)
    fn = tfk.density_eval_fn(c["field"])
    front = tcam.rays_at_pixels(cam, pix_t, S, P, lo, hi)
    back = trend.back_ray_bundle(front, out["pos_vec"], cc.back_len_div)
    with torch.no_grad():
        df = fn(tcam.ray_points(front))[..., 0]
        db = fn(tcam.ray_points(back))[..., 0]
    near = ((df - cc.density_threshold).abs() < c["tol"]).any(-1) | ((db - 0.05).abs() < c["tol"]).any(-1)
    for hits in (out["pos_vec"], out["back_vec"]):
        d, _ = tpc.nn_query(hits, a1)
        near |= (d - cc.mesh_filter_dist).abs() < 1e-5
    return near.numpy()


def test_generate_cors_surface_matches_reference(cors_pair):
    c = cors_pair
    for name, atol in (("a1.npy", 1e-5 if c["name"] == "f32" else 2e-3), ("subvert1.npy", None),
                       ("subnormal1.npy", None)):
        a, b = jart.load_array(c["jdir"], name), jart.load_array(c["tdir"], name)
        assert a.shape == b.shape and a.shape[0] >= 100, name
        if atol is not None:
            np.testing.assert_allclose(b, a, atol=atol)
    # the subsample: FPS on nearly equal clouds picks the same points
    # (positions to the clouds' agreement), normals where not near a tie
    sj, st = jart.load_array(c["jdir"], "subvert1.npy"), jart.load_array(c["tdir"], "subvert1.npy")
    np.testing.assert_allclose(st, sj, atol=1e-5 if c["name"] == "f32" else 2e-3)
    nj, nt = jart.load_array(c["jdir"], "subnormal1.npy"), jart.load_array(c["tdir"], "subnormal1.npy")
    assert ((nj * nt).sum(-1) > 0.99).mean() > 0.95


def test_generate_cors_views_match_reference(cors_pair):
    """Per view: the rays kept by both sides have the same front and back
    hits; a ray kept by one side only, or whose hits moved, has a cause at
    its threshold (``_near_threshold``)."""
    c = cors_pair
    S = c["S"]
    kept = 0
    for v in range(c["V"]):
        xj, pj, bxj, bj = jart.load_view_rays(c["jdir"], S, v)
        xt, pt, bxt, bt = jart.load_view_rays(c["tdir"], S, v)
        assert pt.shape[1] == 3 and bt.shape[1] == 3 and xt.shape == (pt.shape[0], 2)
        for (xa, ha), (xb, hb) in (((xj, pj), (xt, pt)), ((bxj, bj), (bxt, bt))):
            a, b = dict(zip(_pixels(xa, S), ha)), dict(zip(_pixels(xb, S), hb))
            moved = [p for p in set(a) & set(b) if np.abs(a[p] - b[p]).max() > 1e-5]
            flips = sorted((set(a) ^ set(b)) | set(moved))
            if flips:
                assert _near_threshold(c, v, np.asarray(flips)).all(), (v, flips)
            kept += len(set(a) & set(b))
    assert kept > 100


@pytest.mark.parametrize("cors_pair", ["f32"], indirect=True)
def test_generate_cors_resumes_missing_views(cors_pair):
    """A view whose files are gone is redone alone, bit-identical; the
    others are not rewritten."""
    c = cors_pair
    S, tdir = c["S"], c["tdir"]
    orig = jart.load_view_rays(tdir, S, 2)
    for sub in ("sampledRayxys", "posVec", "sampledRayBackxys", "posVecBack"):
        os.remove(os.path.join(tdir, f"{S}_{sub}", "2.npy"))
    stamp = os.path.getmtime(os.path.join(tdir, f"{S}_posVec", "1.npy"))
    tgc.generate_cors(c["field"], *c["args"], str(c["root"] / "port"), 1, _port(c["cc"]), grid_res=c["G"],
                      device="cpu")
    for a, b in zip(orig, jart.load_view_rays(tdir, S, 2)):
        np.testing.assert_array_equal(a, b)
    assert os.path.getmtime(os.path.join(tdir, f"{S}_posVec", "1.npy")) == stamp


# ----------------------------------------------------------- negatives


@pytest.mark.parametrize("cors_pair", ["f32"], indirect=True)
def test_build_negatives_with_replayed_draws(cors_pair):
    """The reference's surface-sampling draws (seed 0) replayed: FPS,
    bound and mesh filters give the same negatives, but for points whose
    mesh distance is within 1e-5 of ``neg_mesh_dist`` (the reference's
    filter squares distances the expanded way, the port's takes exact
    differences)."""
    c = cors_pair
    R, t, K, sils = c["args"]
    S, V, n_rays, n_pts, n_loops = c["S"], c["V"], 30, 128, 2
    cfg = PoseTrainConfig(n_neg=150, neg_mesh_dist=0.06)
    a1 = jart.load_array(c["tdir"], "a1.npy")
    want = jpt.build_negatives(jfields.NerfField(c["cfg"]), jax.tree.map(jnp.asarray, c["params"]), R, t, K, sils,
                               a1, cfg, image_size=S, rays_per_image=n_rays, n_loops=n_loops, threshold=0.2, seed=0)
    key = jax.random.PRNGKey(0)
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
    got = tpt.build_negatives(c["field"], R, t, K, sils, a1, _port(cfg), image_size=S, rays_per_image=n_rays,
                              n_loops=n_loops, threshold=0.2, draws=draws, device="cpu").numpy()
    assert got.shape[0] > 20
    d_want = np.sqrt(((want[:, None] - a1[None]) ** 2).sum(-1)).min(1)
    d_got = np.sqrt(((got[:, None] - a1[None]) ** 2).sum(-1)).min(1)
    near = lambda d: np.abs(d - cfg.neg_mesh_dist) < 1e-5  # noqa: E731
    common = min(got.shape[0], want.shape[0])
    if got.shape[0] == want.shape[0]:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert near(np.concatenate([d_want, d_got])).any() and abs(got.shape[0] - want.shape[0]) <= 2, common
