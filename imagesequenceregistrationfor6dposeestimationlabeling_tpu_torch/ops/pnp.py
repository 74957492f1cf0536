"""Perspective-n-Point (counterpart of ops/pnp.py): batched Grunert P3P,
fixed-budget RANSAC and Gauss-Newton refinement.

Conventions: OpenCV column form, x_cam = R x_world + t, pixel
u = fx Xc/Zc + cx.  Every function takes explicit leading batch dims where
the reference used ``vmap``: images (B) and hypotheses (H).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import NamedTuple

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import (
    hat,
    kabsch,
    rotvec_to_matrix,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.polynomial import (
    durand_kerner,
    real_roots_mask,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import graphs
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils.profiling import span


def bearings(p2d: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., N, 2) -> unit bearings (..., N, 3); K (..., 3, 3)."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    x = (p2d[..., 0] - cx) / fx
    y = (p2d[..., 1] - cy) / fy
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _poly_mul(a, b):
    out = [0.0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] = out[i + j] + ai * bj
    return out


def p3p_grunert(p3d: torch.Tensor, f: torch.Tensor):
    """Closed-form P3P (Grunert's quartic).

    p3d (..., 3, 3) world points, f (..., 3, 3) unit bearings.  Returns
    R (..., 4, 3, 3), t (..., 4, 3), valid (..., 4): one solution per
    quartic root, invalid where the root is not a real positive solution.
    """
    P1, P2, P3 = p3d[..., 0, :], p3d[..., 1, :], p3d[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    aa = ((P2 - P3) ** 2).sum(-1)
    bb = ((P1 - P3) ** 2).sum(-1)
    cc = ((P1 - P2) ** 2).sum(-1)
    p = 2.0 * (f2 * f3).sum(-1)
    q = 2.0 * (f1 * f3).sum(-1)
    r = 2.0 * (f1 * f2).sum(-1)
    m = aa / bb.clamp_min(1e-12)
    n = cc / bb.clamp_min(1e-12)

    # u = N(v) / D(v); substituting into 1 + u^2 - r u = n (1 + v^2 - q v)
    # and clearing D^2 gives N^2 - r N D + (1 - n (1 + v^2 - q v)) D^2 = 0
    n2 = 1.0 - m + n
    n1 = (m - n) * q
    n0 = -(1.0 + m - n)
    d1 = p
    d0 = -r
    N_ = [n2, n1, n0]
    D_ = [d1, d0]
    NN = _poly_mul(N_, N_)
    ND = _poly_mul(N_, D_)
    DD = _poly_mul(D_, D_)
    g = [-n, n * q, 1.0 - n]
    GDD = _poly_mul(g, DD)

    def pad(c, deg=4):
        return [0.0] * (deg + 1 - len(c)) + list(c)

    NN, ND, GDD = pad(NN), pad(ND), pad(GDD)
    coeffs = torch.stack([torch.as_tensor(NN[k] - r * ND[k] + GDD[k]).expand_as(r) for k in range(5)], -1)

    lead_ok = coeffs[..., 0].abs() > 1e-10
    roots = durand_kerner(coeffs, n_iters=50)
    v = roots.real
    is_real = real_roots_mask(roots, tol=5e-3)

    n2, n1, n0, d1, d0, q, bb = (x[..., None] for x in (n2, n1, n0, d1, d0, q, bb))
    denom_u = d1 * v + d0
    u = (n2 * v * v + n1 * v + n0) / torch.where(denom_u.abs() < 1e-9, torch.full_like(denom_u, 1e-9), denom_u)
    s1_sq = bb / (1.0 + v * v - q * v).clamp_min(1e-12)
    s1 = torch.sqrt(s1_sq.clamp_min(0.0))
    s2 = u * s1
    s3 = v * s1
    valid = is_real & (v > 1e-6) & (u > 1e-6) & (s1 > 1e-9) & lead_ok[..., None]

    # camera-frame points per root, then the 3-point Kabsch world -> camera
    X = torch.stack([s1[..., None] * f1[..., None, :], s2[..., None] * f2[..., None, :],
                     s3[..., None] * f3[..., None, :]], dim=-2)           # (..., 4, 3, 3)
    # degenerate draws (a point drawn twice) overflow the quartic: such roots
    # are never valid, and the SVD must not see their non-finite points
    finite = torch.isfinite(X).all(-1).all(-1)
    valid = valid & finite
    X = torch.where(finite[..., None, None], X, torch.zeros_like(X))
    R, t = kabsch(p3d[..., None, :, :].expand(X.shape), X)
    return R, t, valid


def solve_p3p_batch(p3d: torch.Tensor, p2d: torch.Tensor, K: torch.Tensor):
    """Raw P3P of a batch: (H, 3, 3) points and (H, 3, 2) pixels under K
    (3, 3) -> up to 4 solutions each: R (H, 4, 3, 3), t (H, 4, 3), valid
    (H, 4)."""
    return p3p_grunert(p3d, bearings(p2d, K))


def reproject(R, t, K, pts):
    """R (..., 3, 3), t (..., 3), K (..., 3, 3), pts (..., N, 3) ->
    pixels (..., N, 2) and depths (..., N)."""
    xc = pts @ R.transpose(-1, -2) + t[..., None, :]
    z = xc[..., 2]
    u = K[..., 0, 0, None] * xc[..., 0] / z + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * xc[..., 1] / z + K[..., 1, 2, None]
    return torch.stack([u, v], dim=-1), z


class RansacResult(NamedTuple):
    R: torch.Tensor          # (B, 3, 3)
    t: torch.Tensor          # (B, 3)
    inliers: torch.Tensor    # (B, N) bool
    n_inliers: torch.Tensor  # (B,)
    success: torch.Tensor    # (B,)


def draw_hypotheses(weights: torch.Tensor, n_hyp: int, generator: torch.Generator | None) -> torch.Tensor:
    """(B, N) non-negative weights -> (B, n_hyp, 4) correspondence indices,
    drawn with probability proportional to max(weight, 1e-12)."""
    probs = weights.clamp_min(1e-12)
    B = weights.shape[0]
    return torch.multinomial(probs, n_hyp * 4, replacement=True, generator=generator).view(B, n_hyp, 4)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    out = x.gather(1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x (B, H, ...), i (B,) -> x[b, i[b]]."""
    return x[torch.arange(x.shape[0], device=x.device), i]


# RANSAC's CUDA graphs (utils/graphs.py), one per input signature, the
# most recently used kept: each pins its memory pool, about 1.5 GB at
# serving's 16 images x 5,625 correspondences x 500 hypotheses
MAX_GRAPHS = 4
# CUDA calls of ransac_pnp: graphs captured, calls replayed through a graph
# captured earlier, and calls run eagerly (inputs that need grad, or a
# stream that is capturing already)
GRAPH_COUNT = {"captures": 0, "replays": 0, "eager": 0}
_GRAPHS: OrderedDict = OrderedDict()


def ransac_pnp(
    p3d: torch.Tensor,
    p2d: torch.Tensor,
    K: torch.Tensor,
    weights: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
    n_hyp: int = 500,
    reproj_err: float = 2.0,
    refine_iters: int = 10,
    generator: torch.Generator | None = None,
    samples: torch.Tensor | None = None,
) -> RansacResult:
    """Fixed-budget RANSAC-P3P over a batch of B images.

    p3d (B, N, 3), p2d (B, N, 2) or (N, 2), K (B, 3, 3), weights (B, N).
    Each hypothesis: 4 correspondences -> P3P on 3, the 4th picks the root
    -> inliers within ``reproj_err`` px; the best hypothesis is refined by
    Gauss-Newton on its inliers and kept if that did not diverge.
    ``samples`` (B, n_hyp, 4) injects the correspondence draws.

    After the draws, a call on the card runs ``ransac_body`` as a CUDA
    graph: captured on the first call of an input signature (device,
    shapes, dtypes, ``reproj_err``, ``refine_iters``), replayed on later
    ones.  Elsewhere, and where autograd must see the ops, it runs
    eagerly."""
    B, N = p3d.shape[:2]
    dev = p3d.device
    if samples is None:
        samples = draw_hypotheses(torch.ones((B, N), device=dev) if weights is None else weights, n_hyp, generator)
    args = (p3d, p2d, K, weights, valid, samples.to(dev))
    body = functools.partial(ransac_body, reproj_err=reproj_err, refine_iters=refine_iters)
    if dev.type != "cuda":
        return RansacResult(*body(*args))
    if torch.cuda.is_current_stream_capturing() or (
            torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args)):
        GRAPH_COUNT["eager"] += 1
        return RansacResult(*body(*args))
    key = (dev, tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args), float(reproj_err),
           int(refine_iters), torch.get_float32_matmul_precision())
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        while len(_GRAPHS) >= MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        GRAPH_COUNT["captures"] += 1
        graph = graphs.Graph(body, args, dev)
        out = graph.capture(args)
    else:
        GRAPH_COUNT["replays"] += 1
        with span("pnp.replay"):
            out = graph(args)
    _GRAPHS[key] = graph
    return RansacResult(*out)


def ransac_body(p3d, p2d, K, weights, valid, samples, reproj_err: float, refine_iters: int) -> tuple:
    """``ransac_pnp`` after the draws, on ``samples`` (B, n_hyp, 4): the
    five tensors of its ``RansacResult``.  It reads nothing back to the
    host but through the SVD of P3P's Kabsch step (``graphs.cut``)."""
    B, N = p3d.shape[:2]
    dev = p3d.device
    p2d = p2d.expand(B, N, 2)
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=dev) if weights is None else weights > 0
    samp = samples.long()

    with span("pnp.p3p"):
        f_all = bearings(p2d, K)                                            # (B, N, 3)
        pts = _take(p3d, samp)                                              # (B, H, 4, 3)
        f = _take(f_all, samp)
        R, t, ok = p3p_grunert(pts[..., :3, :], f[..., :3, :])              # (B, H, 4, ...)
        uv4, z4 = reproject(R, t, K[:, None, None], pts[..., None, 3:4, :])  # (B, H, 4, 1, ...)
        target4 = _take(p2d, samp[..., 3])                                  # (B, H, 2)
        err4 = torch.linalg.vector_norm(uv4[..., 0, :] - target4[..., None, :], dim=-1)
        err4 = torch.where(ok & (z4[..., 0] > 0), err4, torch.full_like(err4, 1e9))
        best_root = torch.argmin(err4, dim=-1)                              # (B, H)
        R_h = R.gather(2, best_root[..., None, None, None].expand(-1, -1, 1, 3, 3))[:, :, 0]
        t_h = t.gather(2, best_root[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        ok_h = err4.gather(2, best_root[..., None])[..., 0] < 1e8

    with span("pnp.score"):
        uv, z = reproject(R_h, t_h, K[:, None], p3d[:, None])              # (B, H, N, ...)
        err = torch.linalg.vector_norm(uv - p2d[:, None], dim=-1)
        inl = (err < reproj_err) & (z > 0) & valid[:, None, :]
        counts = torch.where(ok_h, inl.sum(-1), torch.full_like(ok_h, -1, dtype=torch.int64))
        best = torch.argmax(counts, dim=-1)                                 # (B,)
        R0, t0 = _pick(R_h, best), _pick(t_h, best)
        inliers = _pick(inl, best)
        success = _pick(counts, best) >= 4

    with span("pnp.refine"):
        fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
        w_in = inliers.to(p3d.dtype)
        eye6 = 1e-6 * torch.eye(6, dtype=p3d.dtype, device=dev)
        Rk, tk = R0, t0
        for _ in range(refine_iters):
            uvk, _ = reproject(Rk, tk, K, p3d)
            res = (uvk - p2d) * w_in[..., None]                              # (B, N, 2)
            xc = p3d @ Rk.transpose(-1, -2) + tk[:, None, :]
            X, Y, Z = xc[..., 0], xc[..., 1], xc[..., 2]
            iZ = 1.0 / Z.clamp_min(1e-9)
            zero = torch.zeros_like(Z)
            J_u = torch.stack([fx * iZ, zero, -fx * X * iZ * iZ], -1)
            J_v = torch.stack([zero, fy * iZ, -fy * Y * iZ * iZ], -1)
            J_uv = torch.stack([J_u, J_v], -2)                              # (B, N, 2, 3)
            J = torch.cat([J_uv @ -hat(xc), J_uv], dim=-1) * w_in[..., None, None]  # (B, N, 2, 6)
            JtJ = torch.einsum("bnik,bnil->bkl", J, J) + eye6
            Jtr = torch.einsum("bnik,bni->bk", J, res)
            delta = -torch.linalg.solve_ex(JtJ, Jtr, check_errors=False).result
            dR = rotvec_to_matrix(delta[:, :3])
            Rk, tk = dR @ Rk, (dR @ tk[..., None])[..., 0] + delta[:, 3:]

        uv0, _ = reproject(R0, t0, K, p3d)
        uvf, _ = reproject(Rk, tk, K, p3d)
        zero = torch.zeros((), dtype=p3d.dtype, device=dev)
        e0 = torch.where(inliers, torch.linalg.vector_norm(uv0 - p2d, dim=-1), zero).sum(-1)
        ef = torch.where(inliers, torch.linalg.vector_norm(uvf - p2d, dim=-1), zero).sum(-1)
        use_f = ef <= e0
        R_out = torch.where(use_f[:, None, None], Rk, R0)
        t_out = torch.where(use_f[:, None], tk, t0)
    return R_out, t_out, inliers, inliers.sum(-1), success
