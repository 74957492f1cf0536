"""Port parity: P3P, RANSAC with the reference's hypothesis draws injected,
Gauss-Newton refinement, ADD, ICP, consecutive verification and the
two-half registration (CPU; the JAX side runs without a mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import rotations as jrot
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import metrics as jmetrics
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import pnp as jpnp
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import registration as jreg
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics as tmetrics
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp as tpnp
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import polynomial as tpoly
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import registration as treg

torch.set_num_threads(1)

K = np.float32([[120.0, 0, 37.0], [0, 118.0, 36.0], [0, 0, 1]])


def T(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _pose(rng, z=4.0):
    rv = rng.normal(size=3).astype(np.float32)
    R = np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rv)))
    t = np.float32([0.1, -0.2, z]) + 0.1 * rng.normal(size=3).astype(np.float32)
    return R, t


def _scene(rng, n=200, outliers=0.3, noise=0.3):
    R, t = _pose(rng)
    p3d = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    xc = p3d @ R.T + t
    p2d = (xc[:, :2] / xc[:, 2:] * [K[0, 0], K[1, 1]] + K[:2, 2]).astype(np.float32)
    p2d += noise * rng.normal(size=p2d.shape).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    p2d[bad] = rng.uniform(0, 72, size=(int(bad.sum()), 2)).astype(np.float32)
    return R, t, p3d, p2d


def test_p3p_matches_reference(rng):
    for _ in range(4):
        R, t, p3d, p2d = _scene(rng, n=3, outliers=0.0, noise=0.0)
        f = np.asarray(jpnp.bearings(jnp.asarray(p2d), jnp.asarray(K)))
        np.testing.assert_allclose(tpnp.bearings(T(p2d), T(K)).numpy(), f, atol=1e-6)
        Rj, tj, vj = map(np.asarray, jpnp.p3p_grunert(jnp.asarray(p3d), jnp.asarray(f)))
        Rt, tt, vt = (x.numpy() for x in tpnp.p3p_grunert(T(p3d)[None], T(f)[None]))
        np.testing.assert_array_equal(vt[0], vj)
        # Grunert's quartic in f32 is ill-conditioned: on these noise-free
        # draws both versions miss the planted pose by up to 2e-2, each in its
        # own rounding; they agree within 1e-2
        np.testing.assert_allclose(Rt[0][vj], Rj[vj], atol=1e-2)
        np.testing.assert_allclose(tt[0][vj], tj[vj], atol=1e-2, rtol=1e-2)


def _injected_draws(rng, n_hyp=64):
    """Two scenes, their weights, the reference's own draws (ops/pnp.py:
    split key, categorical) and the reference's RANSAC on them."""
    scenes = [_scene(rng) for _ in range(2)]
    p3d = np.stack([s[2] for s in scenes])
    p2d = np.stack([s[3] for s in scenes])
    w = (rng.uniform(size=p3d.shape[:2]) > 0.1).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    samples, ref = [], []
    for b in range(2):
        res = jpnp.ransac_pnp(jnp.asarray(p3d[b]), jnp.asarray(p2d[b]), jnp.asarray(K), keys[b],
                              weights=jnp.asarray(w[b]), n_hyp=n_hyp)
        ref.append(res)
        # the reference's own draw (ops/pnp.py: split key, categorical)
        logits = jnp.log(jnp.maximum(jnp.asarray(w[b]), 1e-12))
        samples.append(np.asarray(jax.random.categorical(jax.random.split(keys[b], 2)[0], logits,
                                                         shape=(n_hyp, 4))))
    return scenes, p3d, p2d, w, np.stack(samples), ref


def test_ransac_with_injected_draws(rng):
    n_hyp = 64
    scenes, p3d, p2d, w, samples, ref = _injected_draws(rng, n_hyp)
    Ks = np.stack([K, K])
    out = tpnp.ransac_pnp(T(p3d), T(p2d), T(Ks), weights=T(w), n_hyp=n_hyp, samples=torch.from_numpy(samples))
    for b in range(2):
        np.testing.assert_array_equal(out.inliers[b].numpy(), np.asarray(ref[b].inliers))
        assert bool(out.success[b]) == bool(ref[b].success)
        # ten f32 Gauss-Newton steps on ~130 inliers
        np.testing.assert_allclose(out.R[b].numpy(), np.asarray(ref[b].R), atol=1e-4)
        np.testing.assert_allclose(out.t[b].numpy(), np.asarray(ref[b].t), atol=1e-3)
        # and it found the planted pose
        np.testing.assert_allclose(out.R[b].numpy(), scenes[b][0], atol=2e-2)
    # drawn from a generator, the batch still recovers the poses
    g = torch.Generator().manual_seed(0)
    out2 = tpnp.ransac_pnp(T(p3d), T(p2d), T(Ks), weights=T(w), n_hyp=n_hyp, generator=g)
    for b in range(2):
        np.testing.assert_allclose(out2.R[b].numpy(), scenes[b][0], atol=2e-2)


def _durand_kerner_host_roots(coeffs, n_iters=40):
    """``durand_kerner`` as it was written before its starting roots were
    cached on the device: built from a host list on every call."""
    c = coeffs.to(torch.complex64)
    lead = c[..., 0:1]
    c = c / torch.where(lead.abs() < 1e-30, torch.full_like(lead, 1e-30), lead)
    D = c.shape[-1] - 1
    w = [1.0 + 0.0j]
    for _ in range(D - 1):
        w.append(w[-1] * (0.4 + 0.9j))
    roots = torch.tensor(w, dtype=torch.complex64, device=c.device).expand(c.shape[:-1] + (D,))
    eye = torch.eye(D, dtype=torch.bool, device=c.device)
    one = torch.ones((), dtype=torch.complex64, device=c.device)
    tiny = torch.full((), 1e-20, dtype=torch.complex64, device=c.device)
    for _ in range(n_iters):
        p = c[..., 0:1].expand(roots.shape)
        for i in range(1, D + 1):
            p = p * roots + c[..., i : i + 1]
        diff = roots[..., :, None] - roots[..., None, :]
        denom = torch.where(eye, one, diff).prod(-1)
        denom = torch.where(denom.abs() < 1e-20, tiny, denom)
        roots = roots - p / denom
    return roots


def _checked_solve_ex(A, B, *, check_errors=False):
    """``linalg.solve`` (with its host-side check) in ``solve_ex``'s form."""
    return torch.return_types.linalg_solve_ex((torch.linalg.solve(A, B), torch.zeros(A.shape[:-2], dtype=torch.int32)))


def test_ransac_arithmetic_unchanged_by_graph_safe_forms(rng, monkeypatch):
    """The cached Durand-Kerner starting roots and ``solve_ex`` without its
    check give the injected-draws case bit for bit what the host-built
    roots and the checked ``solve`` gave."""
    n_hyp = 64
    _, p3d, p2d, w, samples, _ = _injected_draws(rng, n_hyp)
    args = (T(p3d), T(p2d), T(np.stack([K, K])))
    kw = dict(weights=T(w), n_hyp=n_hyp, samples=torch.from_numpy(samples))
    now = tpnp.ransac_pnp(*args, **kw)
    monkeypatch.setattr(tpnp, "durand_kerner", _durand_kerner_host_roots)
    monkeypatch.setattr(torch.linalg, "solve_ex", _checked_solve_ex)
    before = tpnp.ransac_pnp(*args, **kw)
    for a, b in zip(now, before):
        assert torch.equal(a, b)
    assert int(now.n_inliers.min()) > 0


def test_durand_kerner_roots_unchanged_by_cached_start(rng):
    coeffs = torch.from_numpy(rng.normal(size=(64, 5)).astype(np.float32))
    for n_iters in (40, 50):
        assert torch.equal(tpoly.durand_kerner(coeffs, n_iters), _durand_kerner_host_roots(coeffs, n_iters))


def test_ransac_on_cpu_runs_eagerly(rng, monkeypatch):
    """No CUDA graph on the CPU: the counter of graph captures, replays and
    eager CUDA calls stays at zero."""
    monkeypatch.setattr(tpnp, "GRAPH_COUNT", dict.fromkeys(tpnp.GRAPH_COUNT, 0))
    _, _, p3d, p2d = _scene(rng)
    out = tpnp.ransac_pnp(T(p3d)[None], T(p2d), T(K)[None], n_hyp=32, generator=torch.Generator().manual_seed(3))
    assert out.R.shape == (1, 3, 3)
    assert tpnp.GRAPH_COUNT == {"captures": 0, "replays": 0, "eager": 0}
    assert not tpnp._GRAPHS


def test_add_metric_matches(rng):
    verts = rng.normal(size=(100, 3)).astype(np.float32)
    (R1, t1), (R2, t2) = _pose(rng), _pose(rng)
    a = float(jmetrics.add_metric(*map(jnp.asarray, (verts, R1, t1, R2, t2))))
    b = tmetrics.add_metric(T(verts), T(np.stack([R1, R1])), T(np.stack([t1, t1])),
                            T(np.stack([R2, R1])), T(np.stack([t2, t1])))
    np.testing.assert_allclose(float(b[0]), a, rtol=1e-6)
    assert float(b[1]) == 0.0


def _clouds(rng):
    lower = rng.normal(size=(400, 3)).astype(np.float32) * [0.5, 0.4, 0.3]
    upper = lower[::2] + 0.002 * rng.normal(size=(200, 3)).astype(np.float32)
    return upper.astype(np.float32), lower.astype(np.float32)


def test_icp_matches_reference(rng):
    upper, lower = _clouds(rng)
    R0 = np.asarray(jrot.rotvec_to_matrix(jnp.float32([0.05, -0.03, 0.04])))
    t0 = np.float32([0.02, 0.01, -0.02])
    rj = jreg.icp_point_to_point(jnp.asarray(upper), jnp.asarray(lower), jnp.asarray(R0), jnp.asarray(t0),
                                 0.2, max_iters=15)
    rt = treg.icp_point_to_point(T(upper), T(lower), T(R0), T(t0), 0.2, max_iters=15)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-5)
    np.testing.assert_allclose(float(rt.inlier_rmse), float(rj.inlier_rmse), atol=1e-6)
    np.testing.assert_allclose(float(rt.fitness), float(rj.fitness), atol=1e-6)


def test_register_and_verify_match(rng):
    upper, lower = _clouds(rng)
    cad = np.concatenate([lower, upper + 0.001]).astype(np.float32)
    poses = [_pose(rng) for _ in range(4)]
    Rg = np.stack([p[0] for p in poses])
    tg = np.stack([p[1] for p in poses])
    Rp = np.stack([np.asarray(jrot.rotvec_to_matrix(jnp.asarray(0.03 * rng.normal(size=3).astype(np.float32))))
                   @ r for r in Rg])
    tp = tg + 0.01
    bj, cj = jreg.verify_consecutive(upper, Rg, tg, Rp, tp, mesh=None)
    bt, ct = treg.verify_consecutive(upper, Rg, tg, Rp, tp, device="cpu")
    assert bt == bj
    np.testing.assert_allclose(ct, cj, rtol=1e-5)
    kw = dict(diameter=1.5, icp_threshold=0.2, icp_iters=10)
    oj = jreg.register_halves(upper, lower, Rg[1], tg[1], Rp[1], tp[1], cad, mesh=None, **kw)
    ot = treg.register_halves(upper, lower, Rg[1], tg[1], Rp[1], tp[1], cad, device="cpu", **kw)
    np.testing.assert_allclose(ot["R"], oj["R"], atol=1e-5)
    np.testing.assert_allclose(ot["t"], oj["t"], atol=1e-5)
    # the reference NN on CPU expands |a|^2 + |b|^2 - 2ab: ~1e-7 absolute
    np.testing.assert_allclose(ot["chamfer"], oj["chamfer"], atol=1e-6)
    assert ot["correct"] == oj["correct"]
    np.testing.assert_allclose(ot["merged"], oj["merged"], atol=1e-5)
