"""Ray generation, image sampling, importance resampling and the coarse /
fine renderer of NeRF training: the port against the JAX reference on the
same inputs, with the reference's ``jax.random`` draws handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import grid_sample as jgs
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import raymarch as jrm
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import renderer as jrend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as tcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import grid_sample as tgs
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch as trm
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer as trend

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def scene():
    s = jsyn.make_scene(n_views=3, image_size=24, key=jax.random.PRNGKey(0))
    jc = jcam.camera_from_bop(s.R_bop, s.t_bop, s.K, 24)
    tc = tcam.camera_from_bop(_t(s.R_bop), _t(s.t_bop), _t(s.K), 24)
    return s, jc, tc


@pytest.mark.parametrize("lo,hi,n", [(2.0, 6.0, 8), (1.7, 6.3, 8), (0.8123, 7.91, 64), (2.0141, 6.0141, 64)])
def test_depth_edges_match_reference_linspace(lo, hi, n):
    ours = tcam.depth_edges(lo, hi, n, device="cpu").numpy()
    # inside the jitted train step the edges are constants that XLA folds
    # with the formula start * (1 - i/n) + stop * i/n: bit-identical
    folded = np.asarray(jax.jit(lambda: jnp.linspace(lo, hi, n + 1).astype(jnp.float32))())
    np.testing.assert_array_equal(ours, folded)
    # eager jnp.linspace is compiled with that sum fused into an FMA: at
    # most one ulp away on some edges
    eager = np.asarray(jnp.linspace(lo, hi, n + 1).astype(jnp.float32))
    ulp = np.spacing(np.abs(eager).astype(np.float32))
    assert np.all(np.abs(ours - eager) <= ulp)


def test_monte_carlo_rays_with_reference_draws(scene):
    _, jc, tc = scene
    key = jax.random.PRNGKey(3)
    n_rays, n_pts, lo, hi = 40, 8, 2.0, 6.0
    jb = jax.jit(lambda k: jcam.monte_carlo_rays(jc, n_rays, n_pts, lo, hi, k))(key)
    # the draws of monte_carlo_rays: split(key) -> (k_xy, k_z)
    k_xy, k_z = jax.random.split(key)
    xys = jax.random.uniform(k_xy, (3, n_rays, 2), minval=-1.0, maxval=1.0)
    u = jax.random.uniform(k_z, (3, n_rays, n_pts))
    tb = tcam.monte_carlo_rays(tc, n_rays, n_pts, lo, hi, xys=_t(xys), u=_t(u))
    np.testing.assert_array_equal(tb.xys.numpy(), np.asarray(jb.xys))
    # f32 camera products summed in another order
    np.testing.assert_allclose(tb.origins.numpy(), np.asarray(jb.origins), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.directions.numpy(), np.asarray(jb.directions), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.lengths.numpy(), np.asarray(jb.lengths), rtol=1e-6)
    assert tb.lengths.shape == (3, n_rays, n_pts)
    # strata: each depth inside its own bin
    edges = tcam.depth_edges(lo, hi, n_pts, device="cpu")
    assert bool(((tb.lengths >= edges[:-1]) & (tb.lengths <= edges[1:])).all())


@pytest.mark.parametrize("mode,align_corners", [("nearest", True), ("nearest", False), ("bilinear", True),
                                                ("bilinear", False)])
def test_grid_sample_matches_reference(mode, align_corners):
    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(2, 5, 7, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 50, 2)).astype(np.float32)
    # exact half-pixel ties with align_corners (x: (g + 1) * 0.5 * 6 = k + 0.5;
    # y: * 4) round to even
    grid[:, :6, 0] = (np.arange(6) + 0.5) / 3.0 - 1.0
    grid[:, :6, 1] = np.array([-0.25, 0.25, 0.75, -0.75, -0.25, 0.25], np.float32)
    ours = tgs.grid_sample(_t(imgs), _t(grid), mode=mode, align_corners=align_corners).numpy()
    ref = np.asarray(jgs.grid_sample(jnp.asarray(imgs), jnp.asarray(grid), mode=mode, align_corners=align_corners))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 if mode == "bilinear" else 0)


def test_sample_images_at_mc_locs(scene):
    s, _, _ = scene
    xys = jax.random.uniform(jax.random.PRNGKey(4), (3, 60, 2), minval=-1.0, maxval=1.0)
    ref = np.asarray(jgs.sample_images_at_mc_locs(jnp.asarray(s.images), xys))
    ours = tgs.sample_images_at_mc_locs(_t(s.images), _t(xys)).numpy()
    np.testing.assert_array_equal(ours, ref)
    ref_s = np.asarray(jgs.sample_images_at_mc_locs(jnp.asarray(s.sils)[..., None], xys))
    ours_s = tgs.sample_images_at_mc_locs(_t(s.sils)[..., None], _t(xys)).numpy()
    np.testing.assert_array_equal(ours_s, ref_s)


def _weights(rng, n, p):
    w = rng.uniform(size=(n, p)).astype(np.float32) ** 4
    w[:3] = 0.0                              # all-zero rows: the eps keeps the pdf uniform
    return w


def _close_to_conditioning(ours, ref, bins, w, u):
    """Samples agree up to the inversion's conditioning: z = bin_b + width *
    (u - cdf_b) / mass moves by width * dcdf / mass when the cdf moves by
    dcdf, and the two cumsums add in another order (dcdf <= 16 f32 ulps of
    1, 2e-6).  In a segment of tiny mass a sample may sit anywhere in its
    bin, never outside it."""
    ww = w.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros_like(ww[:, :1]), np.cumsum(ww / ww.sum(-1, keepdims=True), -1)], -1)
    idx = np.clip(np.array([np.searchsorted(c, uu, side="right") for c, uu in zip(cdf, u)]), 1, cdf.shape[1] - 1)
    mass = np.take_along_axis(cdf, idx, -1) - np.take_along_axis(cdf, idx - 1, -1)
    width = np.take_along_axis(bins, idx, -1) - np.take_along_axis(bins, idx - 1, -1)
    bound = 1e-5 + width * np.minimum(1.0, 2e-6 / mass)
    assert np.all(np.abs(ours - ref) <= bound), np.max(np.abs(ours - ref) / bound)
    assert np.median(np.abs(ours - ref)) < 1e-6


def test_sample_pdf_and_importance_resample_match_reference():
    rng = np.random.default_rng(5)
    n, P, Pf = 30, 16, 24
    lengths = np.sort(rng.uniform(2.0, 6.0, size=(n, P)), -1).astype(np.float32)
    w = _weights(rng, n, P)
    key = jax.random.PRNGKey(6)
    u = jax.random.uniform(key, (n, Pf), maxval=1.0 - 1e-6)
    bins = 0.5 * (lengths[:, 1:] + lengths[:, :-1])
    ref = np.asarray(jrm.sample_pdf(jnp.asarray(bins), jnp.asarray(w[:, 1:-1]), Pf, key))
    ours = trm.sample_pdf(_t(bins), _t(w[:, 1:-1]), Pf, u=_t(u)).numpy()
    _close_to_conditioning(ours, ref, bins, w[:, 1:-1], np.asarray(u))
    ref_z = np.asarray(jrm.importance_resample(jnp.asarray(lengths), jnp.asarray(w), Pf, key))
    ours_z = trm.importance_resample(_t(lengths), _t(w), Pf, u=_t(u)).numpy()
    assert ours_z.shape == (n, P + Pf)
    assert np.all(np.diff(ours_z, axis=-1) >= 0)
    # the inputs pass through; the sorted union matches where the samples do
    np.testing.assert_allclose(np.sort(np.concatenate([lengths, ours], -1), -1), ours_z, rtol=0, atol=0)
    np.testing.assert_allclose(np.sort(np.concatenate([lengths, ref], -1), -1), ref_z, rtol=0, atol=0)


def test_huber_matches_reference():
    rng = np.random.default_rng(7)
    x, y = (rng.normal(size=(4, 9)).astype(np.float32) for _ in range(2))
    for s in (0.1, 0.5):
        np.testing.assert_allclose(trm.huber(_t(x), _t(y), s).numpy(),
                                   np.asarray(jrm.huber(jnp.asarray(x), jnp.asarray(y), s)), rtol=1e-6, atol=1e-7)


def test_render_coarse_fine_with_reference_draws(scene):
    _, jc, tc = scene
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16")
    jf = jfields.NerfField(cfg)
    pc, pf = (jfields.init_field(jf, jax.random.PRNGKey(k)) for k in (1, 2))
    tfc, tff = tfields.NerfField(cfg), tfields.NerfField(cfg)
    tfc.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, pc)))
    tff.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, pf)))
    key = jax.random.PRNGKey(8)
    n_rays, Pc, Pf = 16, 8, 12
    cam_j, cam_t = jc[0], tc[0]
    ref_c, ref_f, ref_xy = jrend.render_coarse_fine(
        lambda x, d, m: jf.apply(pc, x, d, m), lambda x, d, m: jf.apply(pf, x, d, m), cam_j, key, n_rays, Pc, Pf,
        2.0, 6.0)
    # the renderer's draws: split(key) -> (k_rays, k_pdf); k_rays -> (k_xy, k_z)
    k_rays, k_pdf = jax.random.split(key)
    k_xy, k_z = jax.random.split(k_rays)
    draws = (jax.random.uniform(k_xy, (n_rays, 2), minval=-1.0, maxval=1.0),
             jax.random.uniform(k_z, (n_rays, Pc)), jax.random.uniform(k_pdf, (n_rays, Pf), maxval=1.0 - 1e-6))
    with torch.no_grad():
        c, f, xy = trend.render_coarse_fine(tfc, tff, cam_t, n_rays, Pc, Pf, 2.0, 6.0,
                                            draws=tuple(_t(x) for x in draws))
    np.testing.assert_array_equal(xy.numpy(), np.asarray(ref_xy))
    assert c.shape == f.shape == (n_rays, 4)
    # both are the field's own (flax-numerics) colour path on the same depths
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(ref_f), atol=1e-4)
