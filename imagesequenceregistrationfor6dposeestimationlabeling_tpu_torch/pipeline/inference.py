"""Per-image 6D pose inference (counterpart of pipeline/inference.py).

For a batch of masked crops, the query CNN and the baked keys:

1. CNN -> 12-d query map (+ mask logit),
2. stride downsample with the pixel-center K fix-up,
3. dense correspondence over all keys (kernel K3 on the card),
4. keep the top-80% most confident correspondences,
5. fixed-budget RANSAC-P3P -> (R, t).

The reference vmapped the per-image path; here images are a batch dim.
``estimate_pose_full_frame`` takes a raw frame and its visibility mask
through the SurfEmb affine crop first.

The SurfEmb side (``estimate_pose_surfemb``, ``run_sequence_surfemb``)
samples and scores pose hypotheses from the full correspondence
distribution (``pose_est_surf``), then refines the best by gradient
(``pose_refine``: its key lookup is K2 on the card).  Its distribution is
pixels x keys per image, so images go one at a time: the reference's
``make_batch_surfemb_estimator`` (``lax.map`` over mesh-sharded image
groups) has no counterpart, and ``run_sequence_surfemb`` is a loop over
the images.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device, sync
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.cameras import (
    downsample_K,
    surfemb_crop_M,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp, similarity
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.grid_sample import grid_sample

# when a list, each SurfEmb image appends its stage seconds (a device sync
# between stages), its best score and, on the card, its peak device bytes
STAGE_LOG = None


class PoseEstimate(NamedTuple):
    R: torch.Tensor          # (B, 3, 3)
    t: torch.Tensor          # (B, 3)
    n_inliers: torch.Tensor  # (B,)
    success: torch.Tensor    # (B,)
    conf_mask: torch.Tensor  # (B, Sd*Sd)


def correspondences(cnn, images, masks, cam_Ks, feats, down_sample: int = 3, keep_frac: float = 0.8):
    """Steps 1-4 for a batch: (idx (B, Nq), conf_mask (B, Nq), p2d (Nq, 2), Kd (B, 3, 3))."""
    feat_full = cnn(images)                                  # (B, S, S, 13)
    q = feat_full[:, ::down_sample, ::down_sample, :12]
    m = masks[:, ::down_sample, ::down_sample] > 0.5
    Kd = downsample_K(cam_Ks, down_sample)
    B, Sd = q.shape[:2]
    idx, conf = similarity.correspondence_argmax(q.reshape(B, -1, 12), feats)
    conf_mask = similarity.confidence_threshold(conf, m.reshape(B, -1), keep_frac)
    yy = torch.arange(Sd, device=q.device)
    gy, gx = torch.meshgrid(yy, yy, indexing="ij")
    # p2d[:, 0] = column (x), p2d[:, 1] = row (y)
    p2d = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1).to(torch.float32)
    return idx, conf_mask, p2d, Kd


@torch.no_grad()
def estimate_poses(cnn, images, masks, cam_Ks, verts, feats, down_sample: int = 3,
                   keep_frac: float = 0.8, n_hyp: int = 500, reproj_err: float = 2.0,
                   generator: torch.Generator | None = None, samples=None) -> PoseEstimate:
    """Poses for a batch of B images: images (B, S, S, 3) ImageNet-normalized
    crops, masks (B, S, S), cam_Ks (B, 3, 3), verts (M, 3), feats (M, 12).
    ``samples`` (B, n_hyp, 4) injects the RANSAC draws."""
    idx, conf_mask, p2d, Kd = correspondences(cnn, images, masks, cam_Ks, feats, down_sample, keep_frac)
    p3d = verts[idx.long()]
    res = pnp.ransac_pnp(p3d, p2d, Kd, weights=conf_mask.to(torch.float32), n_hyp=n_hyp,
                         reproj_err=reproj_err, generator=generator, samples=samples)
    return PoseEstimate(res.R, res.t, res.n_inliers, res.success, conf_mask)


def estimate_pose_single(cnn, image, mask, cam_K, verts, feats, **kw) -> PoseEstimate:
    """One image: (S, S, 3), (S, S), (3, 3); results keep a batch dim of 1."""
    return estimate_poses(cnn, image[None], mask[None], cam_K[None], verts, feats, **kw)


def run_sequence(cnn, images, masks, cam_Ks, verts, feats, cfg: InferenceConfig = InferenceConfig(),
                 seed: int = 1, batch: int = 16, generator: torch.Generator | None = None,
                 samples=None, device=None):
    """Poses of a whole sequence, ``batch`` images at a time ->
    (pred_R (N, 3, 3), pred_t (N, 3)) as numpy.  ``samples`` (N, n_hyp, 4)
    injects the RANSAC draws; otherwise they come from ``generator`` (a
    fresh one seeded with ``seed`` when None)."""
    device = torch.device(device) if device is not None else next(cnn.parameters()).device
    if generator is None and samples is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32
    to = lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=f32).to(device)  # noqa: E731
    images, masks, cam_Ks, verts, feats = (to(x) for x in (images, masks, cam_Ks, verts, feats))
    N = images.shape[0]
    batch = max(min(batch, N), 1)
    Rs, ts = [], []
    for i in range(0, N, batch):
        sl = slice(i, i + batch)
        est = estimate_poses(
            cnn, images[sl], masks[sl], cam_Ks[sl], verts, feats,
            down_sample=cfg.down_sample, keep_frac=cfg.conf_keep_frac, n_hyp=cfg.ransac_iters,
            reproj_err=cfg.reproj_err_px, generator=generator,
            samples=None if samples is None else torch.as_tensor(samples[sl]),
        )
        Rs.append(est.R.cpu().numpy())
        ts.append(est.t.cpu().numpy())
    return np.concatenate(Rs), np.concatenate(ts)


def surfemb_crop(image, mask, K, crop_res: int = 224, pad: float = 1.2, device=None):
    """Full frame -> SurfEmb affine crop: the bounding rect of the mask (on
    the host), the affine Ms with scale crop_res / max(w, h) / pad centred
    on it, the raw frame warped bilinearly and the mask by nearest
    neighbour to crop_res^2 (output pixel (u, v) samples the frame at
    Ms^-1 (u, v, 1), integer coordinates at pixel centres), and camMat = Ms
    @ K.  image (H, W, 3) in [0, 1], mask (H, W), K (3, 3); returns (crop,
    crop mask, camMat) on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    mask_np = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask)
    ys, xs = np.where(mask_np > 0)
    if len(xs) == 0:
        raise ValueError("empty mask — nothing to crop")
    x, y = int(xs.min()), int(ys.min())
    w, h = int(xs.max() - x + 1), int(ys.max() - y + 1)
    _, Ms = surfemb_crop_M(x, y, w, h, crop_res, pad, device=dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a), dtype=torch.float32,  # noqa: E731
                                    device=dev)
    cam_mat = Ms @ f32(K)
    inv = torch.linalg.inv(Ms)
    ar = torch.arange(crop_res, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(ar, ar, indexing="ij")
    pix = torch.stack([uu.reshape(-1), vv.reshape(-1), torch.ones(crop_res * crop_res, device=dev)], dim=-1)
    src = pix @ inv.T
    H, W = mask_np.shape[:2]
    grid = torch.stack([(src[:, 0] + 0.5) * (2.0 / W) - 1.0, (src[:, 1] + 0.5) * (2.0 / H) - 1.0], dim=-1)[None]
    crop = grid_sample(f32(image)[None], grid, mode="bilinear", align_corners=False)[0].reshape(crop_res, crop_res, 3)
    crop_mask = grid_sample(f32(mask_np)[None, ..., None], grid, mode="nearest", align_corners=False)[0]
    return crop, crop_mask.reshape(crop_res, crop_res), cam_mat


def estimate_pose_full_frame(cnn, frame, mask, K, verts, feats, cfg: InferenceConfig = InferenceConfig(),
                             normalize=None, generator: torch.Generator | None = None, samples=None,
                             device=None) -> PoseEstimate:
    """The pose from a raw full frame (H, W, 3) in [0, 1] and its visibility
    mask: the SurfEmb crop, then the per-image path (batch of one) on
    ``device`` (the card unless named).  ``samples`` (1, n_hyp, 4) injects
    the RANSAC draws."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import normalize_image

    crop, crop_mask, cam_mat = surfemb_crop(frame, mask, K, cfg.crop_res, cfg.crop_pad, device=device)
    norm = normalize if normalize is not None else normalize_image
    return estimate_pose_single(
        cnn, norm(crop), crop_mask, cam_mat, verts, feats, down_sample=cfg.down_sample, keep_frac=cfg.conf_keep_frac,
        n_hyp=cfg.ransac_iters, reproj_err=cfg.reproj_err_px, generator=generator, samples=samples,
    )


class SurfEmbDraws(NamedTuple):
    """One image's draws on the SurfEmb path: the hypotheses' inversion and
    root-pick uniforms (max_poses, 4) each, and the refiner's key
    permutation (M,)."""
    u: torch.Tensor
    pick: torch.Tensor
    sel: torch.Tensor


def _surfemb_core(cnn, image, cam_K, verts, normals, feats, diameter: float, cfg: InferenceConfig, refine: bool,
                  refine_steps: int, translation_only: bool, generator=None, draws: SurfEmbDraws | None = None):
    """One image: CNN -> hypothesis sampling and z-buffer scoring -> the best
    -> optional refinement.  Returns (R (3, 3), t (3,), score ())."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf, pose_refine

    dev = image.device
    stages = {} if STAGE_LOG is not None else None
    if stages is not None and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        feat_full = cnn(image[None])[0]
    query_img, mask_lgts = feat_full[..., :12], feat_full[..., 12]
    hyp = None if draws is None else pose_est_surf.HypothesisDraws(draws.u, draws.pick)
    res = pose_est_surf.estimate_pose(
        mask_lgts, query_img, verts, normals, feats, diameter, cam_K, generator, down_sample=cfg.down_sample,
        max_poses=cfg.max_poses, max_pose_evaluations=cfg.max_pose_evaluations, alpha=cfg.alpha,
        dist_2d_min=cfg.dist_2d_min, draws=hyp, stages=stages,
    )
    best = torch.argmax(res.pose_scores)
    R, t, score = res.R[best], res.t[best], res.pose_scores[best]
    if refine:
        t0 = time.perf_counter()
        R, t, _ = pose_refine.refine_pose(R, t, query_img, cam_K, verts, feats, generator, n_steps=refine_steps,
                                          translation_only=translation_only,
                                          sel=None if draws is None else draws.sel)
        if stages is not None:
            sync(dev)
            stages["refinement"] = time.perf_counter() - t0
    if stages is not None:
        stages["best_score"] = float(score)
        if dev.type == "cuda":
            stages["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        STAGE_LOG.append(stages)
    return R, t, score


def estimate_pose_surfemb(cnn, image, cam_K, verts, normals, feats, diameter: float,
                          cfg: InferenceConfig = InferenceConfig(), refine: bool = True, refine_steps: int = 50,
                          translation_only: bool = False, generator: torch.Generator | None = None,
                          draws: SurfEmbDraws | None = None):
    """The SurfEmb pose of one ImageNet-normalized crop (S, S, 3) with its
    crop camera (3, 3): hypothesis sampling and z-buffer scoring, then
    gradient refinement.  Returns (R, t, score): the best hypothesis' SurfEmb
    score (higher is better).  The draws come from ``generator`` unless
    ``draws`` hands them in."""
    R, t, score = _surfemb_core(cnn, image, cam_K, verts, normals, feats, diameter, cfg, refine, refine_steps,
                                translation_only, generator, draws)
    return R, t, float(score)


def run_sequence_surfemb(cnn, images, cam_Ks, verts, normals, feats, diameter: float,
                         cfg: InferenceConfig = InferenceConfig(), seed: int = 1, refine: bool = True,
                         refine_steps: int = 50, translation_only: bool = False,
                         generator: torch.Generator | None = None, draws=None, device=None):
    """``estimate_pose_surfemb`` over a sequence of N crops, one image at a
    time, on ``device`` (the card unless named) -> (pred_R (N, 3, 3), pred_t
    (N, 3), scores (N,)) as numpy.  The images draw in turn from one
    generator (seeded with ``seed`` unless given), or ``draws`` hands in one
    ``SurfEmbDraws`` an image."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    def f32(x):
        return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=torch.float32).to(dev)

    images, cam_Ks, verts, normals, feats = map(f32, (images, cam_Ks, verts, normals, feats))
    Rs, ts, scores = [], [], []
    for i in range(images.shape[0]):
        R, t, s = _surfemb_core(cnn, images[i], cam_Ks[i], verts, normals, feats, diameter, cfg, refine,
                                refine_steps, translation_only, generator, None if draws is None else draws[i])
        Rs.append(R.cpu().numpy())
        ts.append(t.cpu().numpy())
        scores.append(float(s))
    return np.stack(Rs), np.stack(ts), np.asarray(scores, np.float32)
