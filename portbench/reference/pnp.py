"""Plain PyTorch fixed-budget RANSAC-P3P in the precision of its inputs
(inference.py 215-294 of the published code, which calls OpenCV's
solvePnPRansac; here in batched form): per hypothesis four
correspondences, Grunert's P3P on three (quartic roots by Durand-Kerner),
the fourth picks the root, inliers within ``reproj_err`` pixels; the best
hypothesis is refined by Gauss-Newton on its inliers and kept if that did
not diverge.  OpenCV column convention:
x_cam = R x + t, u = fx X / Z + cx."""

from __future__ import annotations

import torch


def hat(w):
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def rotvec_to_matrix(r):
    th2 = (r * r).sum(-1, keepdim=True)[..., None]
    K = hat(r)
    small = th2 < 1e-12
    safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe)
    return torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape) + a * K + b * (K @ K)


def kabsch(src, dst):
    """(R, t) minimizing ||R src + t - dst||^2 over (..., N, 3) points."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = w / w.sum(-1, keepdim=True)
    mu_s, mu_d = (src * w[..., None]).sum(-2), (dst * w[..., None]).sum(-2)
    Hm = ((src - mu_s[..., None, :]) * w[..., None]).transpose(-1, -2) @ (dst - mu_d[..., None, :])
    U, _, Vt = torch.linalg.svd(Hm)
    V = Vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = V @ D @ U.transpose(-1, -2)
    return R, mu_d - (R @ mu_s[..., None])[..., 0]


def quartic_roots(coeffs, n_iters: int = 50):
    """Roots (..., 4) of a quartic, highest degree first: complex128 for
    float64 coefficients, else complex64."""
    ctype = torch.complex128 if coeffs.dtype == torch.float64 else torch.complex64
    c = coeffs.to(ctype)
    lead = c[..., 0:1]
    c = c / torch.where(lead.abs() < 1e-30, torch.full_like(lead, 1e-30), lead)
    D = c.shape[-1] - 1
    w = [1.0 + 0.0j]
    for _ in range(D - 1):
        w.append(w[-1] * (0.4 + 0.9j))
    roots = torch.tensor(w, dtype=ctype, device=c.device).expand(c.shape[:-1] + (D,))
    eye = torch.eye(D, dtype=torch.bool, device=c.device)
    one = torch.ones((), dtype=ctype, device=c.device)
    tiny = torch.full((), 1e-20, dtype=ctype, device=c.device)
    for _ in range(n_iters):
        p = c[..., 0:1].expand(roots.shape)
        for i in range(1, D + 1):
            p = p * roots + c[..., i:i + 1]
        den = torch.where(eye, one, roots[..., :, None] - roots[..., None, :]).prod(-1)
        roots = roots - p / torch.where(den.abs() < 1e-20, tiny, den)
    return roots


def _mul(a, b):
    out = [0.0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = out[i + j] + x * y
    return out


def p3p(P, f):
    """Grunert's P3P: world points P (..., 3, 3), unit bearings f (..., 3,
    3) -> R (..., 4, 3, 3), t (..., 4, 3), valid (..., 4)."""
    P1, P2, P3 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    aa, bb, cc = ((P2 - P3) ** 2).sum(-1), ((P1 - P3) ** 2).sum(-1), ((P1 - P2) ** 2).sum(-1)
    p, q, r = 2.0 * (f2 * f3).sum(-1), 2.0 * (f1 * f3).sum(-1), 2.0 * (f1 * f2).sum(-1)
    m, n = aa / bb.clamp_min(1e-12), cc / bb.clamp_min(1e-12)
    n2, n1, n0, d1, d0 = 1.0 - m + n, (m - n) * q, -(1.0 + m - n), p, -r
    N_, D_ = [n2, n1, n0], [d1, d0]
    NN, ND, DD = _mul(N_, N_), _mul(N_, D_), _mul(D_, D_)
    GDD = _mul([-n, n * q, 1.0 - n], DD)
    pad = lambda c: [0.0] * (5 - len(c)) + list(c)  # noqa: E731
    NN, ND, GDD = pad(NN), pad(ND), pad(GDD)
    coeffs = torch.stack([torch.as_tensor(NN[k] - r * ND[k] + GDD[k]).expand_as(r) for k in range(5)], -1)
    lead_ok = coeffs[..., 0].abs() > 1e-10
    roots = quartic_roots(coeffs)
    v = roots.real
    is_real = roots.imag.abs() < 5e-3 * (1.0 + roots.real.abs())
    n2, n1, n0, d1, d0, q, bb = (x[..., None] for x in (n2, n1, n0, d1, d0, q, bb))
    du = d1 * v + d0
    u = (n2 * v * v + n1 * v + n0) / torch.where(du.abs() < 1e-9, torch.full_like(du, 1e-9), du)
    s1 = torch.sqrt((bb / (1.0 + v * v - q * v).clamp_min(1e-12)).clamp_min(0.0))
    s2, s3 = u * s1, v * s1
    valid = is_real & (v > 1e-6) & (u > 1e-6) & (s1 > 1e-9) & lead_ok[..., None]
    X = torch.stack([s1[..., None] * f1[..., None, :], s2[..., None] * f2[..., None, :],
                     s3[..., None] * f3[..., None, :]], -2)
    finite = torch.isfinite(X).all(-1).all(-1)
    X = torch.where(finite[..., None, None], X, torch.zeros_like(X))
    R, t = kabsch(P[..., None, :, :].expand(X.shape), X)
    return R, t, valid & finite


def bearings(p2d, K):
    x = (p2d[..., 0] - K[..., 0, 2, None]) / K[..., 0, 0, None]
    y = (p2d[..., 1] - K[..., 1, 2, None]) / K[..., 1, 1, None]
    v = torch.stack([x, y, torch.ones_like(x)], -1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def reproject(R, t, K, pts):
    xc = pts @ R.transpose(-1, -2) + t[..., None, :]
    z = xc[..., 2]
    return torch.stack([K[..., 0, 0, None] * xc[..., 0] / z + K[..., 0, 2, None],
                        K[..., 1, 1, None] * xc[..., 1] / z + K[..., 1, 2, None]], -1), z


def take(x, idx):
    B = x.shape[0]
    out = x.gather(1, idx.reshape(B, -1)[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def refine(R0, t0, inliers, p3d, p2d, K, iters: int = 10):
    """Gauss-Newton on the reprojection error of the ``inliers`` (..., N)
    from (R0, t0) (..., 3, 3), (..., 3); the refined pose where its summed
    error over the inliers is not above the start's, else the start.
    p3d (..., N, 3), p2d (..., N, 2), K (..., 3, 3), all broadcast."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    w = inliers.to(p3d.dtype)
    eye6 = 1e-6 * torch.eye(6, dtype=p3d.dtype, device=p3d.device)
    Rk, tk = R0, t0
    for _ in range(iters):
        uvk, _ = reproject(Rk, tk, K, p3d)
        res = (uvk - p2d) * w[..., None]
        xc = p3d @ Rk.transpose(-1, -2) + tk[..., None, :]
        X, Y, Z = xc[..., 0], xc[..., 1], xc[..., 2]
        iZ = 1.0 / Z.clamp_min(1e-9)
        o = torch.zeros_like(Z)
        J_uv = torch.stack([torch.stack([fx * iZ, o, -fx * X * iZ * iZ], -1),
                            torch.stack([o, fy * iZ, -fy * Y * iZ * iZ], -1)], -2)
        J = torch.cat([J_uv @ -hat(xc), J_uv], -1) * w[..., None, None]
        JtJ = torch.einsum("...nik,...nil->...kl", J, J) + eye6
        delta = -torch.linalg.solve(JtJ, torch.einsum("...nik,...ni->...k", J, res))
        dR = rotvec_to_matrix(delta[..., :3])
        Rk, tk = dR @ Rk, (dR @ tk[..., None])[..., 0] + delta[..., 3:]
    zero = torch.zeros((), dtype=p3d.dtype, device=p3d.device)
    e0 = torch.where(inliers, torch.linalg.vector_norm(reproject(R0, t0, K, p3d)[0] - p2d, dim=-1), zero).sum(-1)
    ef = torch.where(inliers, torch.linalg.vector_norm(reproject(Rk, tk, K, p3d)[0] - p2d, dim=-1), zero).sum(-1)
    use = ef <= e0
    return torch.where(use[..., None, None], Rk, R0), torch.where(use[..., None], tk, t0)


def ransac(p3d, p2d, K, weights, samples, reproj_err: float = 2.0, refine_iters: int = 10):
    """(R (B, 3, 3), t (B, 3)) from correspondences p3d (B, N, 3), p2d
    (N, 2), weights (B, N) (valid where > 0) and the hypotheses' draws
    ``samples`` (B, H, 4): the first hypothesis with the most inliers
    (valid points in front of the camera whose reprojection lies within
    ``reproj_err`` pixels), refined on its inliers."""
    B, N = p3d.shape[:2]
    p2d = p2d.expand(B, N, 2)
    valid = weights > 0
    f_all = bearings(p2d, K)
    pts, f = take(p3d, samples), take(f_all, samples)
    R, t, ok = p3p(pts[..., :3, :], f[..., :3, :])
    uv4, z4 = reproject(R, t, K[:, None, None], pts[..., None, 3:4, :])
    err4 = torch.linalg.vector_norm(uv4[..., 0, :] - take(p2d, samples[..., 3])[..., None, :], dim=-1)
    err4 = torch.where(ok & (z4[..., 0] > 0), err4, torch.full_like(err4, 1e9))
    root = torch.argmin(err4, -1)
    R_h = R.gather(2, root[..., None, None, None].expand(-1, -1, 1, 3, 3))[:, :, 0]
    t_h = t.gather(2, root[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    ok_h = err4.gather(2, root[..., None])[..., 0] < 1e8
    uv, z = reproject(R_h, t_h, K[:, None], p3d[:, None])
    inl = (torch.linalg.vector_norm(uv - p2d[:, None], dim=-1) < reproj_err) & (z > 0) & valid[:, None, :]
    counts = torch.where(ok_h, inl.sum(-1), torch.full_like(ok_h, -1, dtype=torch.int64))
    best = torch.argmax(counts, -1)
    ar = torch.arange(B, device=p3d.device)
    return refine(R_h[ar, best], t_h[ar, best], inl[ar, best], p3d, p2d, K, refine_iters)
