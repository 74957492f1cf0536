"""Port parity: rotations, cameras, raymarch and the synthetic scene against
the JAX reference on the same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import rotations as jrot
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import raymarch as jrm
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic as tsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as tcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import rotations as trot
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch as trm

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _rotations(rng, n):
    rv = rng.normal(size=(n, 3)).astype(np.float32)
    return np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rv))), rv


def test_rotvec_and_pose_algebra(rng):
    R1, rv = _rotations(rng, 5)
    R2, _ = _rotations(rng, 5)
    t1, t2 = rng.normal(size=(2, 5, 3)).astype(np.float32)
    # rotvec_to_matrix, including the Taylor branch at zero (atol 1e-6: f32)
    rv[0] = 0.0
    close(trot.rotvec_to_matrix(T(rv)), jrot.rotvec_to_matrix(jnp.asarray(rv)), 1e-6)
    for fj, ft in ((jrot.invert_pose, trot.invert_pose),):
        for a, b in zip(ft(T(R1), T(t1)), fj(jnp.asarray(R1), jnp.asarray(t1))):
            close(a, b, 1e-6)
    for a, b in zip(trot.relative_pose_se3(T(R1), T(t1), T(R2), T(t2)),
                    jrot.relative_pose_se3(*map(jnp.asarray, (R1, t1, R2, t2)))):
        close(a, b, 1e-5)


def test_kabsch_weighted(rng):
    src = rng.normal(size=(50, 3)).astype(np.float32)
    R, _ = _rotations(rng, 1)
    dst = src @ R[0].T + np.float32([0.3, -1.0, 2.0]) + 0.01 * rng.normal(size=(50, 3)).astype(np.float32)
    w = (rng.uniform(size=50) > 0.3).astype(np.float32)
    Rt, tt = trot.kabsch(T(src), T(dst), T(w))
    Rj, tj = jrot.kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    close(Rt, Rj, 1e-5)   # f32 SVD of a well-conditioned 3x3
    close(tt, tj, 1e-5)
    # batched form equals the per-item form
    Rb, tb = trot.kabsch(T(np.stack([src, dst])), T(np.stack([dst, src])))
    close(Rb[1], trot.kabsch(T(dst), T(src))[0], 1e-6)


def test_cameras_match(rng):
    n, S = 3, 24
    R_bop, t_bop = jsyn.random_bop_poses(n, jax.random.PRNGKey(3))
    K = np.tile(np.float32([[50.0, 0, 12.5], [0, 52.0, 11.0], [0, 0, 1]]), (n, 1, 1))
    cj = jcam.camera_from_bop(R_bop, t_bop, jnp.asarray(K), S)
    ct = tcam.camera_from_bop(T(R_bop), T(t_bop), T(K), S)
    for a, b in zip(ct[:4], cj[:4]):
        close(a, b, 0.0)
    close(tcam.camera_center(ct), jcam.camera_center(cj), 1e-6)
    xy = rng.uniform(0, S, size=(n, 7, 2)).astype(np.float32)
    close(tcam.pixel_to_ndc(T(xy), S), jcam.pixel_to_ndc(jnp.asarray(xy), S), 0.0)
    xys = rng.uniform(-1, 1, size=(n, 7, 2)).astype(np.float32)
    # the plain broadcast vs the reference's per-component form: f32-identical ops
    close(tcam.ndc_directions(ct, T(xys)), jcam.ndc_directions(cj, jnp.asarray(xys)), 1e-6)
    bt = tcam.grid_rays(ct, S, 9, 2.0, 6.0)
    bj = jcam.grid_rays(cj, S, 9, 2.0, 6.0)
    for a, b in zip(bt, bj):
        close(a, b, 1e-6)
    close(tcam.ray_points(bt), jcam.ray_points(bj), 1e-5)
    close(tcam.downsample_K(T(K[0]), 3), jcam.downsample_K(jnp.asarray(K[0]), 3), 1e-6)


def test_raymarch_match(rng):
    dens = rng.uniform(size=(4, 6, 20)).astype(np.float32)
    feats = rng.uniform(size=(4, 6, 20, 3)).astype(np.float32)
    for tm in (False, True):
        (it, wt), (ij, wj) = (trm.composite(T(dens), T(feats), threshold_mode=tm, threshold=0.4),
                              jrm.composite(jnp.asarray(dens), jnp.asarray(feats), threshold_mode=tm,
                                            threshold=0.4))
        close(it, ij, 1e-6)
        close(wt, wj, 1e-6)
    close(trm.threshold_densities(T(dens), 0.3), jrm.threshold_densities(jnp.asarray(dens), 0.3), 0.0)
    close(trm.ea_weights(T(dens)), jrm.ea_weights(jnp.asarray(dens)), 1e-6)
    o, d = rng.normal(size=(2, 4, 6, 3)).astype(np.float32)
    lengths = np.sort(rng.uniform(2, 6, size=(4, 6, 20)).astype(np.float32), -1)
    w = np.asarray(jrm.ea_weights(jnp.asarray(dens)))
    close(trm.surface_points(T(o), T(d), T(lengths), T(w)),
          jrm.surface_points(*map(jnp.asarray, (o, d, lengths, w))), 1e-5)


def test_synthetic_scene_match():
    pts = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32) * 0.6
    close(tsyn.analytic_density(T(pts)), jsyn.analytic_density(jnp.asarray(pts)), 1e-6)
    close(tsyn.analytic_color(T(pts)), jsyn.analytic_color(jnp.asarray(pts)), 1e-6)
    # random_bop_poses with the reference's uniform draws passed in
    key = jax.random.PRNGKey(5)
    ks = jax.random.split(key, 3)
    u = np.stack([np.asarray(jax.random.uniform(k, (4,))) for k in ks])
    Rj, tj = jsyn.random_bop_poses(4, key)
    Rt, tt = tsyn.random_bop_poses(4, uniforms=u, device="cpu")
    close(Rt, Rj, 2e-6)   # minval/maxval scaling rounds once in either order
    close(tt, tj, 1e-5)
    # analytic_surface_points with the reference's draws passed in
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    which = np.asarray(jax.random.randint(k1, (300,), 0, 4))
    dirs = np.asarray(jax.random.normal(k2, (300, 3)))
    pj, okj = jsyn.analytic_surface_points(300, jax.random.PRNGKey(9))
    pt, okt = tsyn.analytic_surface_points(300, which=which, dirs=dirs, device="cpu")
    close(pt, pj, 1e-6)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    # the rendered scene from the same poses
    sj = jsyn.make_scene(n_views=3, image_size=24, key=jax.random.PRNGKey(2))
    st = tsyn.make_scene(image_size=24, poses=(np.asarray(sj.R_bop), np.asarray(sj.t_bop)), device="cpu")
    close(st.K, sj.K, 0.0)
    close(st.images, sj.images, 1e-4)   # 96-sample cumprod composite, f32 order
    assert (st.sils.numpy() != np.asarray(sj.sils)).mean() < 1e-3
    assert st.diameter == sj.diameter
