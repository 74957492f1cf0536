"""Plain PyTorch SurfEmb pose estimator for one crop: the published
``estimate_pose`` (poseEstSurf.py:11-261) and ``refine_pose``
(pose_refine.py:21-104), as inference.py:324-366 calls them, on the query
and mask maps of the crop.

1. mask terms: the mask's log-probability and its complement's, max over
   each ``down_sample``^2 block and then over 3 x 3; the mask probability
   of each block's mean logit;
2. the correspondence distribution: an exact float64 log-softmax of the
   block-mean queries against every key, and one float64 cdf of
   (softmax x mask probability) ** alpha over the flat pixel x key array,
   built ``BLOCK`` pixels at a time with the running total carried over;
   the log-softmax then max-pooled over 3 x 3 pixels on each key's plane;
3. inversion of given uniforms: per u the first flat entry whose cdf is at
   or above it;
4. Grunert's P3P in float64 on each 4-tuple's first three (``pnp.p3p``),
   one valid root picked by the largest of the given pick uniforms;
5. pruning: 2-D spread, depth range and normal visibility;
6. the first ``max_pose_evaluations`` survivors scored in float32: every
   key's point projected, a z-buffer per pose and pixel, the mask score
   (mean of the pooled mask log-probability where a point landed and its
   complement elsewhere, over log 2) plus the coord score (the mean pooled
   log-probability of the points that won their pixel, over log M);
7. the argmax;
8. refinement in float32 from the best pose: the object coordinates the
   pose renders (each pixel's nearest projected point), each pixel's key
   (the key of the nearest baked point to that coordinate), a
   log-denominator image over the first ``n_denom`` keys of a given
   permutation, and BFGS on -mean log-probability / 2 over the covered
   pixels, its 12 Armijo trials (alpha 1, 1/2, ... 1/2^11) as one batch,
   the first that passes taken, a trust region of 0.3.

Departures from the published code:

- the refiner optimises the rotation (a rotation vector applied on the
  left) and the translation, in units of 10 % of the camera distance; the
  published refiner optimises and returns the translation alone;
- the cdf is exact (float64 entries, a float64 running sum) where the
  published code takes one float32 ``cumsum`` over n x M entries, which at
  5,476 x 80,000 moves most draws;
- P3P is Grunert's closed form with Durand-Kerner roots, batched, where
  the published code calls OpenCV's ``solveP3P`` per hypothesis; the root
  is picked by a uniform draw among the valid ones, as the port does;
- the object coordinates are rendered by splatting the baked points into a
  z-buffer, where the published code renders the mesh with OpenGL.

It imports nothing of the port and no JAX; TF32 is off (``no_tf32``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import pnp as ref_pnp
from portbench.reference.precision import no_tf32

# pixels of the distribution built at a time, poses scored at a time,
# keys max-pooled at a time, and queries of the nearest-point search
BLOCK = 256
POSES = 125
KEYS = 4096
NN_BLOCK = 2048


def avg_pool(x, k: int):
    """(H, W[, C]) -> (H // k, W // k[, C])."""
    H, W = x.shape[:2]
    x = x[: H - H % k, : W - W % k]
    return x.reshape(H // k, k, W // k, k, *x.shape[2:]).mean(dim=(1, 3))


def max_pool(x, k: int):
    H, W = x.shape
    return x[: H - H % k, : W - W % k].reshape(H // k, k, W // k, k).amax(dim=(1, 3))


def max_pool_3x3(x):
    """3 x 3 / 1 max pool of (..., H, W) over the window's in-image cells."""
    return F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), 3, 1, 1).reshape(x.shape)


def mask_terms(mask_lgts, down_sample: int, pool: bool = True):
    """Flat (n,) mask log-probability, its complement's, and the mask
    probability, at the down-sampled grid."""
    lp = max_pool(F.logsigmoid(mask_lgts), down_sample)
    nlp = max_pool(F.logsigmoid(-mask_lgts), down_sample)
    if pool:
        lp, nlp = max_pool_3x3(lp), max_pool_3x3(nlp)
    return lp.reshape(-1), nlp.reshape(-1), torch.sigmoid(avg_pool(mask_lgts, down_sample)).reshape(-1)


def queries_of(query_img, down_sample: int):
    """The block-mean queries (n, e) of a query image (S, S, e)."""
    q = avg_pool(query_img, down_sample)
    return q.reshape(-1, q.shape[-1])


def distribution(queries, keys, mask_prob, alpha: float, res: int, pool: bool = True):
    """(corr_log (n, M) float64, max-pooled over each key's 3 x 3 pixel
    window when ``pool``; cdf (n * M,) float64 ending at 1)."""
    q, k, mp = queries.double(), keys.double(), mask_prob.double()
    n, m = q.shape[0], k.shape[0]
    corr_log = torch.empty((n, m), dtype=torch.float64, device=q.device)
    cdf = torch.empty((n * m,), dtype=torch.float64, device=q.device)
    carry = torch.zeros((), dtype=torch.float64, device=q.device)
    for a in range(0, n, BLOCK):
        b = min(a + BLOCK, n)
        lg = torch.log_softmax(q[a:b] @ k.T, dim=1)
        corr_log[a:b] = lg
        run = torch.cumsum(((torch.exp(lg) * mp[a:b, None]) ** alpha).reshape(-1), 0) + carry
        cdf[a * m:b * m] = run
        carry = run[-1]
    cdf /= cdf[-1].clone()
    if pool:
        grid = corr_log.view(res, res, m)
        for k0 in range(0, m, KEYS):
            planes = grid[:, :, k0:k0 + KEYS].permute(2, 0, 1)
            grid[:, :, k0:k0 + KEYS] = max_pool_3x3(planes).permute(1, 2, 0)
    return corr_log, cdf


def inverse(cdf, u):
    """Flat (pixel x key) indices of the uniforms ``u``."""
    return torch.searchsorted(cdf, u.double().reshape(-1)).clamp_max(cdf.numel() - 1).reshape(u.shape)


def mass_off(cdf, u, idx) -> float:
    """The largest probability mass by which a uniform lies outside the
    cdf's bin of the index drawn for it: 0 where every index is the one
    ``cdf`` draws, the rounding of a cdf where a draw moves to a
    neighbouring bin."""
    u, idx = u.double().reshape(-1), idx.reshape(-1)
    lo = torch.where(idx > 0, cdf[(idx - 1).clamp_min(0)], torch.zeros_like(u))
    return float(torch.maximum(lo - u, u - cdf[idx]).clamp_min(0.0).max())


def downsample_K(K, down_sample: int):
    Kd = K.to(torch.float32).clone()
    Kd[0:2, 2] += 0.5
    Kd[0:2, :] /= down_sample
    Kd[0:2, 2] -= 0.5
    return Kd


def hypotheses(idx, m: int, res: int, pts, normals, pick, Kd, diameter: float, dist_2d_min: float):
    """P3P in float64 of each drawn 4-tuple (flat indices ``idx`` (P, 4))
    on its first three, the root of the largest ``pick`` uniform among the
    valid ones, then the pruning: (R (P, 3, 3), t (P, 3), keep (P,)), f64."""
    p2i, p3i = torch.div(idx, m, rounding_mode="floor"), idx % m
    p2d = torch.stack([p2i % res, torch.div(p2i, res, rounding_mode="floor")], -1).double()
    p3d = pts.double()[p3i]
    n3d = normals.double()[p3i[:, :3]]
    Kd = Kd.double()
    Rs, ts, valid = ref_pnp.p3p(p3d[:, :3], ref_pnp.bearings(p2d[:, :3], Kd))
    root = torch.argmax(torch.where(valid, pick.double(), torch.full_like(pick.double(), -1.0)), 1)
    rows = torch.arange(idx.shape[0], device=idx.device)
    R, t = Rs[rows, root], ts[rows, root]
    d2 = torch.linalg.vector_norm(p2d[:, :3, None] - p2d[:, None, :3], dim=-1).amax(dim=(1, 2))
    z = t[:, 2]
    z_min, z_max = Kd[0, 0] * diameter / (res * 20.0), Kd[0, 0] * diameter / (res * 0.5)
    facing = ((n3d @ R.transpose(-1, -2)) * (p3d[:, :3] @ R.transpose(-1, -2) + t[:, None])).sum(-1) < 0
    keep = valid.any(1) & (d2 >= dist_2d_min * res) & (z_min < z) & (z < z_max) & facing.all(-1)
    return R, t, keep


def survivors(keep, n_eval: int):
    """The first ``n_eval`` hypotheses that survived the pruning, in order
    (then the others)."""
    return torch.argsort((~keep).to(torch.int8), stable=True)[:n_eval]


def project(R, t, Kd, pts):
    """Float32 pixels (..., N, 2) and depths (..., N) of pts under (R, t)."""
    xc = pts @ R.transpose(-1, -2) + t[..., None, :]
    z = xc[..., 2]
    return torch.stack([Kd[0, 0] * xc[..., 0] / z + Kd[0, 2], Kd[1, 1] * xc[..., 1] / z + Kd[1, 2]], -1), z


def scores(R, t, Kd, pts, corr_log, mask_lp, neg_lp, res: int):
    """(mask score, coord score), each (P,) float64, of the poses R (P, 3,
    3), t (P, 3), projected and z-buffered in float32."""
    n, m = res * res, pts.shape[0]
    cols = torch.arange(m, device=pts.device)
    out_m, out_c = [], []
    for a in range(0, R.shape[0], POSES):
        Rc, tc = R[a:a + POSES].float(), t[a:a + POSES].float()
        P = Rc.shape[0]
        uv, z = project(Rc, tc, Kd.float(), pts.float())
        uv = torch.round(uv)
        inside = ((uv >= 0) & (uv < res)).all(-1)
        flat = torch.where(inside, (uv[..., 1] * res + uv[..., 0]).long(), torch.full_like(cols, n)[None])
        seg = flat + (torch.arange(P, device=pts.device) * (n + 1))[:, None]
        zz = torch.where(z > 0, z, torch.full_like(z, math.inf))
        zbuf = torch.full((P * (n + 1),), math.inf, device=pts.device).scatter_reduce_(
            0, seg.reshape(-1), zz.reshape(-1), "amin").view(P, n + 1)
        seen = torch.isfinite(zbuf[:, :n]) & (zbuf[:, :n] > 0)
        won = inside & (z <= zbuf.gather(1, flat) + 1e-9)
        out_m.append(torch.where(seen, mask_lp, neg_lp).double().mean(1))
        vals = torch.where(won, corr_log[flat.clamp(0, n - 1), cols[None]], torch.zeros((), dtype=torch.float64,
                                                                                        device=pts.device))
        c = vals.sum(1) / won.sum(1).clamp_min(1)
        out_c.append(torch.where(won.any(1), c, torch.full_like(c, -math.inf)))
    return torch.cat(out_m) / math.log(2.0), torch.cat(out_c) / math.log(float(m))


def estimate(mask_lgts, query_img, pts, normals, keys, diameter: float, K, u, pick, s: dict) -> dict:
    """The hypotheses of one crop's maps, the first ``max_pose_evaluations``
    survivors scored, the best: a dict of ``idx`` (the drawn flat indices),
    ``R``, ``t``, ``valid``, ``score`` (mask + coord, -inf off the
    survivors) and ``best``.  ``s``: the configuration's ``surfemb``
    group."""
    no_tf32()
    ds = s["down_sample"]
    res = mask_lgts.shape[0] // ds
    Kd = downsample_K(K, ds)
    mlp, nlp, mp = mask_terms(mask_lgts.float(), ds, s["max_pool"])
    corr_log, cdf = distribution(queries_of(query_img.float(), ds), keys, mp, s["alpha"], res, s["max_pool"])
    idx = inverse(cdf, u)
    del cdf
    R, t, keep = hypotheses(idx, keys.shape[0], res, pts, normals, pick, Kd, diameter, s["dist_2d_min"])
    sel = survivors(keep, s["max_pose_evaluations"])
    R, t, valid = R[sel], t[sel], keep[sel]
    ms, cs = scores(R, t, Kd, pts, corr_log, mlp, nlp, res)
    score = torch.where(valid, ms + cs, torch.full_like(ms, -math.inf))
    return {"idx": idx, "R": R, "t": t, "valid": valid, "score": score, "mask": ms, "coord": cs,
            "best": int(torch.argmax(score))}


# ------------------------------------------------------------------ refinement


def render_coords(pts, R, t, K, res: int):
    """(coords (res * res, 3), covered (res * res,)) under (R, t): each
    pixel's nearest projected point (the lowest index among equal depths)."""
    m, n = pts.shape[0], res * res
    uv, z = project(R, t, K, pts)
    uv = torch.round(uv)
    inside = ((uv >= 0) & (uv < res)).all(-1) & (z > 0)
    flat = torch.where(inside, (uv[:, 1] * res + uv[:, 0]).long(), n)
    zbuf = torch.full((n + 1,), math.inf, device=pts.device).scatter_reduce_(
        0, flat, torch.where(inside, z, torch.full_like(z, math.inf)), "amin")
    won = inside & (z <= zbuf[flat] + 1e-9)
    ids = torch.arange(m, device=pts.device)
    first = torch.full((n + 1,), m, device=pts.device).scatter_reduce_(0, flat, torch.where(won, ids, m), "amin")[:n]
    hit = first < m
    coords = torch.where(hit[:, None], pts[first.clamp(0, m - 1)], torch.zeros((), device=pts.device))
    return coords, torch.isfinite(zbuf[:n])


def nearest(q, pts):
    """Index of each query's nearest point (float64 distances, the lowest
    index among ties)."""
    p = pts.double()
    p2 = (p * p).sum(-1)
    out = []
    for a in range(0, q.shape[0], NN_BLOCK):
        qa = q[a:a + NN_BLOCK].double()
        d = (qa * qa).sum(-1, keepdim=True) - 2.0 * qa @ p.T + p2
        out.append(torch.argmin(d, 1))
    return torch.cat(out)


def rotation_angle(R, R_ref) -> torch.Tensor:
    """The angle of R_ref^T R, in radians."""
    c = ((R_ref.double().transpose(-1, -2) @ R.double()).diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.arccos(c.clamp(-1.0, 1.0))


class Objective:
    """-mean log-probability / 2 over the pixels the start pose (R0, t0)
    covers, as a function of a pose, batched: (B, 3, 3), (B, 3) -> (B,),
    float32.  The covered pixels' object coordinates and keys are fixed at
    the start; each pose samples the query image and the log-denominator
    image (bilinear, border padding) where it projects them."""

    def __init__(self, R0, t0, query_img, K, pts, keys, sel, n_denom: int):
        no_tf32()
        res = query_img.shape[0]
        self.res, self.K, self.R0, self.t0 = res, K.float(), R0.float(), t0.float()
        with torch.no_grad():
            coords, covered = render_coords(pts.float(), self.R0, self.t0, self.K, res)
            self.coords, self.vis = coords, covered.float()
            self.keys_vis = keys.float()[nearest(coords, pts)]
            sub = keys.float()[sel[:min(n_denom, keys.shape[0])].long()]
            q = query_img.float().reshape(-1, query_img.shape[-1])
            denom = torch.cat([torch.logsumexp(c @ sub.T, -1) for c in torch.split(q, 4096)])
        self.q_img = query_img.float().permute(2, 0, 1)[None]              # (1, e, res, res)
        self.d_img = denom.reshape(1, 1, res, res)
        self.n_vis = self.vis.sum().clamp_min(1.0)

    def __call__(self, R, t):
        xc = self.coords @ R.transpose(-1, -2) + t[:, None, :]
        K, res = self.K, self.res
        u = K[0, 0] * xc[..., 0] / xc[..., 2] + K[0, 2]
        v = K[1, 1] * xc[..., 1] / xc[..., 2] + K[1, 2]
        grid = torch.stack([(u + 0.5) * (2.0 / res) - 1.0, (v + 0.5) * (2.0 / res) - 1.0], -1)
        B, N = grid.shape[:2]
        grid = grid.reshape(1, 1, B * N, 2)
        kw = dict(mode="bilinear", padding_mode="border", align_corners=False)
        q = F.grid_sample(self.q_img, grid, **kw)[0, :, 0].T.reshape(B, N, -1)
        d = F.grid_sample(self.d_img, grid, **kw)[0, 0, 0].reshape(B, N)
        per_px = ((q * self.keys_vis).sum(-1) - d) * self.vis
        return -(per_px.sum(-1) / self.n_vis) / 2.0

    def pose(self, x, translation_only: bool = False, base=None):
        """The pose of parameters x (B, 6): a rotation vector on the left of
        the base pose's rotation and a translation step in units of 10 % of
        |t0| from its translation; the base pose is the start unless given."""
        R_b, t_b = (self.R0, self.t0) if base is None else base
        w = x[..., :3] * (0.0 if translation_only else 1.0)
        return ref_pnp.rotvec_to_matrix(w) @ R_b, t_b + x[..., 3:] * (0.1 * torch.linalg.vector_norm(self.t0))


def bfgs(obj: Objective, n_steps: int, translation_only: bool = False, n_trials: int = 12, max_step: float = 0.3,
         base=None):
    """BFGS on ``obj`` from the base pose (the start unless given): (R, t,
    objective) after ``n_steps``."""
    f = lambda x: obj(*obj.pose(x, translation_only, base))  # noqa: E731

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            fx = f(x[None])[0]
            (g,) = torch.autograd.grad(fx, x)
        return fx.detach(), g

    dev = obj.R0.device
    eye = torch.eye(6, device=dev)
    alphas = 0.5 ** torch.arange(n_trials, dtype=torch.float32, device=dev)
    x = torch.zeros(6, device=dev)
    (fx, g), H = value_and_grad(x), eye
    for _ in range(n_steps):
        p = torch.nan_to_num(-(H @ g))
        norm = torch.linalg.vector_norm(p)
        p = torch.where(norm > max_step, p * (max_step / norm.clamp_min(1e-12)), p)
        with torch.no_grad():
            trials = f(x[None] + alphas[:, None] * p[None])
        ok = trials <= fx + 1e-4 * alphas * torch.dot(g, p)
        alpha = torch.where(ok.any(), alphas[torch.argmax(ok.to(torch.int8))], torch.zeros_like(fx))
        s = alpha * p
        f_new, g_new = value_and_grad(x + s)
        y = g_new - g
        sy = torch.dot(s, y)
        curv = sy > 1e-8 * torch.linalg.vector_norm(s) * torch.linalg.vector_norm(y) + 1e-20
        rho = torch.where(curv, 1.0 / torch.where(curv, sy, torch.ones_like(sy)), torch.zeros_like(sy))
        V = eye - rho * torch.outer(s, y)
        H = torch.where(curv, V @ H @ V.T + rho * torch.outer(s, s), H)
        bad = ~torch.isfinite(f_new)
        x, g, fx = torch.where(bad, x, x + s), torch.where(bad, g, g_new), torch.where(bad, fx, f_new)
    with torch.no_grad():
        R, t = obj.pose(x[None], translation_only, base)
    return R[0], t[0], fx


def refine(R0, t0, query_img, K, pts, keys, sel, s: dict):
    """The refined pose from (R0, t0) and its objective: (R, t, objective,
    the ``Objective`` it minimised)."""
    obj = Objective(R0, t0, query_img, K, pts, keys, sel, s["n_denom"])
    R, t, f = bfgs(obj, s["refine_steps"], s["translation_only"])
    return R, t, f, obj


def refined_gaps(R0, t0, R, t, f, query_img, K, pts, keys, sel, s: dict) -> tuple:
    """A refinement from (R0, t0) that ended at (R, t), reporting objective
    ``f``, held to the refinement objective set up at (R0, t0): (the share
    of the gain from the start that another ``refine_steps`` BFGS steps
    from (R, t) still find, 0 where they find nothing; the gap between
    ``f`` and the objective at (R, t), relative)."""
    obj = Objective(R0, t0, query_img, K, pts, keys, sel, s["n_denom"])
    with torch.no_grad():
        f_at, f_start = obj(torch.stack([R.float(), obj.R0]), torch.stack([t.float(), obj.t0])).tolist()
    _, _, f_more = bfgs(obj, s["refine_steps"], s["translation_only"], base=(R.float(), t.float()))
    f_more = float(f_more)
    if not math.isfinite(f_at):
        return math.inf, math.inf
    left = max(0.0, f_at - f_more) / max(f_start - f_more, 1e-6 * abs(f_more), 1e-12)
    return left, abs(float(f) - f_at) / max(abs(f_at), 1e-12)


def pose_of_crop(maps, pts, normals, keys, diameter: float, K, u, pick, sel, s: dict) -> dict:
    """The estimator's answer from a crop's maps (S, S, 13: 12 query
    channels, the mask logit): ``estimate``'s dict with the best pose
    refined (``R_best``, ``t_best``; ``R_final``, ``t_final``)."""
    est = estimate(maps[..., 12], maps[..., :12], pts, normals, keys, diameter, K, u, pick, s)
    R0, t0 = est["R"][est["best"]].float(), est["t"][est["best"]].float()
    est.update(R_best=R0, t_best=t0)
    if s["refine"]:
        R0, t0, _, _ = refine(R0, t0, maps[..., :12], K, pts, keys, sel, s)
    est.update(R_final=R0, t_final=t0)
    return est
