"""SurfEmb pose hypotheses: sampling and scoring (counterpart of
pipeline/pose_est_surf.py).

1. the correspondence distribution corr = softmax(q . k^T) x mask
   probability over (pixels x keys), sharpened by ``alpha``; 4-tuples drawn
   from it by inversion;
2. P3P of each 4-tuple's first three correspondences (one batch), one
   valid root picked at random;
3. pruning by 2-D spread, depth range and normal visibility;
4. scoring of the first ``max_pose_evaluations`` survivors: every key
   projected, a z-buffer per pose and pixel (``scatter_reduce`` "amin"), a
   mask score and the mean correspondence log-probability of the winning
   points.

Fixed shapes throughout: pruning gives a validity mask, not a filter.

With a device ``mesh`` (``parallel.mesh``) the hypothesis axis splits
over its entries twice, as the reference's hypothesis-axis constraints
do: the P3P solves with the pruning, and the z-buffer scoring.  The draws,
the selection of the ``max_pose_evaluations`` survivors and the argmax
stay on home.

The distribution is built ``ROW_CHUNK`` pixels at a time and never whole
in more than two copies: the max-pooled log-softmax (f32) and the cdf.  The
cdf is f64 in two levels: each pixel's row of ``corr ** alpha`` is summed
along the row on the device (a row-wise scan, whose sums have a fixed
order), and the rows' offsets are a sequential f64 sum on the host; the
offset row is monotone, so ``searchsorted`` draws the index exact arithmetic
draws, wherever a u falls farther than f64 rounding from a boundary.  The
reference's single f32 ``cumsum`` over n x M entries does not: at the full
5,476 x 80,000 a sequential f32 running sum stops growing long before its
end (PERF.md gives the share of draws whose index moves), and a 1-D scan on
the card sums in an order that varies from run to run.

Spans (``utils/profiling.py``): ``surf.distribution`` (mask terms, the
distribution, the keys' max pool), ``surf.sample`` (the draws, their
inversion, the gathers), ``surf.p3p`` (P3P with the pruning, the survivors'
selection) and ``surf.score``.  ``SURF_COUNT`` counts on the host, from
shapes and call sites, never from a value on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.cameras import downsample_K
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.rasterize import segment_min
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils.profiling import span

# pixels of the distribution built at a time, hypotheses scored at a time,
# and keys max-pooled at a time
ROW_CHUNK = 256
POSE_CHUNK = 125
KEY_CHUNK = 4096
# the SurfEmb path's work: images posed (``estimate_pose`` calls),
# hypotheses drawn, hypotheses scored, and the times it waits for a value
# on the host: each cdf's row totals and the best score; on the card also
# the offsets' copy back, the P3P SVD's convergence check (twice) and the
# best hypothesis' three picks (``inference._surfemb_core``)
SURF_COUNT = {"images": 0, "hypotheses": 0, "scored": 0, "host_reads": 0}


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """(H, W[, C]) -> (H // k, W // k[, C]) average pooling."""
    H, W = x.shape[:2]
    x = x[: H - H % k, : W - W % k]
    return x.reshape(H // k, k, W // k, k, *x.shape[2:]).mean(dim=(1, 3))


def _max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    H, W = x.shape
    return x[: H - H % k, : W - W % k].reshape(H // k, k, W // k, k).amax(dim=(1, 3))


def _max_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 / 1 max pool of (..., H, W) over the window's in-image cells
    (``max_pool2d`` pads with -inf)."""
    return F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), 3, 1, 1).reshape(x.shape)


def _max_pool_3x3_keys(corr_log: torch.Tensor, res: int):
    """``_max_pool_3x3_same`` over the pixel grid of each key's column of the
    (res * res, M) log-probabilities, in place, ``KEY_CHUNK`` keys at a time."""
    grid = corr_log.view(res, res, -1)
    for k0 in range(0, grid.shape[2], KEY_CHUNK):
        planes = grid[:, :, k0:k0 + KEY_CHUNK].permute(2, 0, 1)
        grid[:, :, k0:k0 + KEY_CHUNK] = _max_pool_3x3_same(planes).permute(1, 2, 0)
    return corr_log


class SurfEmbResult(NamedTuple):
    R: torch.Tensor             # (P, 3, 3)
    t: torch.Tensor             # (P, 3)
    pose_scores: torch.Tensor   # (P,)
    mask_scores: torch.Tensor
    coord_scores: torch.Tensor
    valid: torch.Tensor         # (P,) surviving poses


class HypothesisDraws(NamedTuple):
    """The draws of ``estimate_pose``: the inversion uniforms (max_poses, 4)
    and the root-pick uniforms (max_poses, 4)."""
    u: torch.Tensor
    pick: torch.Tensor


def draw_hypotheses(max_poses: int, generator: torch.Generator | None, device) -> HypothesisDraws:
    u = torch.rand((max_poses, 4), generator=generator, device=device)
    return HypothesisDraws(u, torch.rand((max_poses, 4), generator=generator, device=device))


def correspondence_distribution(queries: torch.Tensor, keys: torch.Tensor, mask_prob: torch.Tensor, alpha: float):
    """(log_softmax(q . k^T) (n, M) f32, cdf (n, M) f64 of corr ** alpha,
    normalized to end at 1), with corr = exp(log_softmax) x mask_prob."""
    n, m = queries.shape[0], keys.shape[0]
    corr_log = torch.empty((n, m), dtype=torch.float32, device=queries.device)
    cdf = torch.empty((n, m), dtype=torch.float64, device=queries.device)
    for r0 in range(0, n, ROW_CHUNK):
        rows = slice(r0, r0 + ROW_CHUNK)
        with no_tf32():
            logits = queries[rows] @ keys.T
        corr_log[rows] = torch.log_softmax(logits, dim=1)
        flat = (torch.exp(corr_log[rows]) * mask_prob[rows, None]) ** alpha
        cdf[rows] = torch.cumsum(flat.to(torch.float64), dim=1)
    # the rows' offsets: a sequential f64 sum of the row totals on the host
    SURF_COUNT["host_reads"] += 1 + (cdf.device.type == "cuda")
    totals = cdf[:, -1].cpu().numpy()
    offsets = np.concatenate([[0.0], np.cumsum(totals)[:-1]])
    cdf += torch.from_numpy(offsets).to(cdf.device)[:, None]
    cdf /= cdf[-1, -1].clone()
    return corr_log, cdf


def inverse_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Flat (pixel x key) indices of the uniforms ``u``: per u the first
    entry of the flat cdf at or above it."""
    return torch.searchsorted(cdf.view(-1), u.to(cdf.dtype)).clamp_max(cdf.numel() - 1)


def mask_terms(mask_lgts: torch.Tensor, down_sample: int, max_pool: bool = True):
    """The mask logits (r, r) at the downsampled grid, each flat (n,): the
    log-probability of the mask and of its complement (max over each
    down_sample^2 block, then over 3x3 when ``max_pool``) and the mask
    probability (of the block's mean logit)."""
    mask_log_prob = _max_pool(F.logsigmoid(mask_lgts), down_sample)
    neg_mask_log_prob = _max_pool(F.logsigmoid(-mask_lgts), down_sample)
    if max_pool:
        mask_log_prob = _max_pool_3x3_same(mask_log_prob)
        neg_mask_log_prob = _max_pool_3x3_same(neg_mask_log_prob)
    mask_prob = torch.sigmoid(_avg_pool(mask_lgts, down_sample))
    return mask_log_prob.reshape(-1), neg_mask_log_prob.reshape(-1), mask_prob.reshape(-1)


def score_poses(R: torch.Tensor, t: torch.Tensor, Kd: torch.Tensor, obj_pts: torch.Tensor, corr_log: torch.Tensor,
                mask_log_prob: torch.Tensor, neg_mask_log_prob: torch.Tensor, res: int):
    """(mask score, coord score), each (P,), of the poses (P, 3, 3) / (P, 3)
    on the res x res grid of intrinsics Kd: every point projected, a
    z-buffer per pose and pixel; the mask score is the mean over pixels of
    the (pooled) mask log-probability where a point landed and its
    complement elsewhere, over log 2; the coord score the mean
    ``corr_log`` (n, M) of the points that won their pixel, over log M
    (-inf where none did).  ``POSE_CHUNK`` poses at a time."""
    dev = obj_pts.device
    n, m = res * res, obj_pts.shape[0]
    cols = torch.arange(m, device=dev)
    inf = float("inf")
    mask_scores, coord_scores = [], []
    for p0 in range(0, R.shape[0], POSE_CHUNK):
        Rc, tc = R[p0:p0 + POSE_CHUNK], t[p0:p0 + POSE_CHUNK]
        P = Rc.shape[0]
        with no_tf32():
            uv, z_all = pnp.reproject(Rc, tc, Kd, obj_pts)      # (P, M, 2), (P, M)
        uv = torch.round(uv)
        inside = ((uv >= 0) & (uv < res)).all(-1)
        u_flat = torch.where(inside, (uv[..., 1] * res + uv[..., 0]).to(torch.int64), n)
        # z-buffer: per pose and pixel the least point depth (bin n: outside)
        seg = u_flat + (torch.arange(P, device=dev) * (n + 1))[:, None]
        z_flat = torch.where(z_all > 0, z_all, torch.full_like(z_all, inf))
        zbuf = segment_min(z_flat.reshape(-1), seg.reshape(-1), P * (n + 1), inf).view(P, n + 1)
        seg_min = zbuf[:, :n]
        visible_px = torch.isfinite(seg_min) & (seg_min > 0)
        # a point wins its pixel when its depth is the pixel's least
        # (outside points read the outside bin, and never win)
        won = inside & (z_all <= zbuf.gather(1, u_flat) + 1e-9)
        mask_scores.append(torch.where(visible_px, mask_log_prob, neg_mask_log_prob).mean(1))
        cl_vals = corr_log.view(-1)[u_flat.clamp(0, n - 1) * m + cols]
        cl_vals = torch.where(won, cl_vals, torch.zeros_like(cl_vals))
        coord = cl_vals.sum(1) / won.sum(1).clamp_min(1)
        coord_scores.append(torch.where(won.any(1), coord, torch.full_like(coord, -inf)))
    return torch.cat(mask_scores) / math.log(2.0), torch.cat(coord_scores) / math.log(float(m))


def _solve_and_prune(p3d, p2d, n3d, u_pick, Kd, res: int, obj_diameter: float, dist_2d_min: float):
    """P3P of each hypothesis' first three correspondences with one valid
    root picked by ``u_pick``, then the pruning: (R (P, 3, 3), t (P, 3),
    keep (P,))."""
    SURF_COUNT["host_reads"] += 2 * (p3d.device.type == "cuda")
    Rs, ts, valid4 = pnp.solve_p3p_batch(p3d[:, :3], p2d[:, :3], Kd)
    pick = torch.argmax(torch.where(valid4, u_pick, -1.0), dim=1)
    rows = torch.arange(p3d.shape[0], device=p3d.device)
    R, t = Rs[rows, pick], ts[rows, pick]
    pose_ok = valid4.any(1)

    d2 = torch.linalg.vector_norm(p2d[:, :3, None] - p2d[:, None, :3], dim=-1).amax(dim=(1, 2))
    dist_ok = d2 >= dist_2d_min * res
    z = t[:, 2]
    z_min = Kd[0, 0] * obj_diameter / (res * 20.0)
    z_max = Kd[0, 0] * obj_diameter / (res * 0.5)
    size_ok = (z_min < z) & (z < z_max)
    with no_tf32():
        n3d_cam = n3d @ R.transpose(-1, -2)
        p3d_cam = p3d[:, :3] @ R.transpose(-1, -2) + t[:, None]
    normals_ok = ((n3d_cam * p3d_cam).sum(-1) < 0).all(-1)
    return R, t, pose_ok & dist_ok & size_ok & normals_ok


@torch.no_grad()
def estimate_pose(mask_lgts: torch.Tensor, query_img: torch.Tensor, obj_pts: torch.Tensor, obj_normals: torch.Tensor,
                  obj_keys: torch.Tensor, obj_diameter: float, K: torch.Tensor,
                  generator: torch.Generator | None = None,
                  down_sample: int = 3, max_poses: int = 10000, max_pose_evaluations: int = 1000,
                  alpha: float = 1.5, dist_2d_min: float = 0.1, max_pool: bool = True,
                  draws: HypothesisDraws | None = None, mesh=None) -> SurfEmbResult:
    """Hypotheses of one image: mask_lgts (r, r), query_img (r, r, e), the
    baked points, normals and keys (M, 3) / (M, 3) / (M, e), the crop's
    intrinsics K (3, 3).  The draws come from ``generator`` unless ``draws``
    hands them in.  With ``mesh`` (home: the inputs' device) the hypotheses
    split over its entries for P3P with pruning and for scoring."""
    dev = query_img.device
    m = obj_keys.shape[0]
    Kd = downsample_K(K, down_sample)
    res = mask_lgts.shape[0] // down_sample
    n = res * res
    SURF_COUNT["images"] += 1

    with span("surf.distribution"):
        mask_log_prob, neg_mask_log_prob, mask_prob = mask_terms(mask_lgts, down_sample, max_pool)
        queries = _avg_pool(query_img, down_sample).reshape(n, -1)
        corr_log, cdf = correspondence_distribution(queries, obj_keys, mask_prob, alpha)
        if max_pool:
            _max_pool_3x3_keys(corr_log, res)

    # inversion sampling of 4-tuples
    with span("surf.sample"):
        if draws is None:
            draws = draw_hypotheses(max_poses, generator, dev)
        u, u_pick = (torch.as_tensor(d, device=dev) for d in draws)
        SURF_COUNT["hypotheses"] += u.shape[0]
        corr_idx = inverse_cdf(cdf, u)
        del cdf
        p2d_idx = torch.div(corr_idx, m, rounding_mode="floor")
        p3d_idx = corr_idx % m
        yy = torch.div(p2d_idx, res, rounding_mode="floor")
        xx = p2d_idx % res
        p2d = torch.stack([xx, yy], dim=-1).to(torch.float32)       # (P, 4, 2)
        p3d = obj_pts[p3d_idx]                                       # (P, 4, 3)
        n3d = obj_normals[p3d_idx[:, :3]]                            # (P, 3, 3)

    with span("surf.p3p"):
        prune = dict(res=res, obj_diameter=obj_diameter, dist_2d_min=dist_2d_min)
        if mesh is None:
            R, t, keep = _solve_and_prune(p3d, p2d, n3d, u_pick, Kd, **prune)
        else:
            R, t, keep = mesh_lib.gather([_solve_and_prune(*(x[s].to(d) for x in (p3d, p2d, n3d, u_pick)),
                                                           Kd.to(d), **prune)
                                          for _, d, s in mesh_lib.shards(max_poses, mesh)], mesh)
        # the first max_pose_evaluations survivors, in their order
        sel = torch.argsort((~keep).to(torch.int8), stable=True)[:max_pose_evaluations]
        R_e, t_e, valid_e = R[sel], t[sel], keep[sel]

    with span("surf.score"):
        SURF_COUNT["scored"] += R_e.shape[0]
        maps = (Kd, obj_pts, corr_log, mask_log_prob, neg_mask_log_prob)
        if mesh is None:
            mask_score, coord_score = score_poses(R_e, t_e, *maps, res)
        else:
            each = mesh_lib.broadcast(maps, mesh)
            mask_score, coord_score = mesh_lib.gather([score_poses(R_e[s].to(d), t_e[s].to(d), *each[i], res)
                                                       for i, d, s in mesh_lib.shards(R_e.shape[0], mesh)], mesh)
        score = torch.where(valid_e, mask_score + coord_score, torch.full_like(mask_score, -float("inf")))
    return SurfEmbResult(R_e, t_e, score, mask_score, coord_score, valid_e)
