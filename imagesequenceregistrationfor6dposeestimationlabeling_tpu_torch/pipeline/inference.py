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
the images.  Its spans and counters: ``pose_est_surf`` and ``pose_refine``,
and ``surf.unet`` around the CNN here.

With a device ``mesh`` (``parallel.mesh``; ``mesh="auto"`` is every card
when there are several), ``run_sequence`` splits each batch of images over
the entries, each running the CNN, K3 and RANSAC on its device, and
``run_sequence_surfemb`` splits the sequence's images; ``hyp_mesh`` splits
one SurfEmb image's hypotheses.  Every random draw is made on home for the
whole batch, in the order the unsharded run makes it, and then sliced, so
the poses do not depend on the split.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.cameras import (
    downsample_K,
    surfemb_crop_M,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp, similarity
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.grid_sample import grid_sample
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf, pose_refine
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils.profiling import span


class PoseEstimate(NamedTuple):
    R: torch.Tensor          # (B, 3, 3)
    t: torch.Tensor          # (B, 3)
    n_inliers: torch.Tensor  # (B,)
    success: torch.Tensor    # (B,)
    conf_mask: torch.Tensor  # (B, Sd*Sd)


def correspondences(cnn, images, masks, cam_Ks, feats, down_sample: int = 3, keep_frac: float = 0.8):
    """Steps 1-4 for a batch: (idx (B, Nq), conf_mask (B, Nq), p2d (Nq, 2), Kd (B, 3, 3))."""
    with span("infer.unet"):
        feat_full = cnn(images)                              # (B, S, S, 13)
        q = feat_full[:, ::down_sample, ::down_sample, :12]
    B, Sd = q.shape[:2]
    with span("infer.k3"):
        idx, conf = similarity.correspondence_argmax(q.reshape(B, -1, 12), feats)
    with span("infer.filter"):
        m = masks[:, ::down_sample, ::down_sample] > 0.5
        conf_mask = similarity.confidence_threshold(conf, m.reshape(B, -1), keep_frac)
        Kd = downsample_K(cam_Ks, down_sample)
        yy = torch.arange(Sd, device=q.device)
        gy, gx = torch.meshgrid(yy, yy, indexing="ij")
        # p2d[:, 0] = column (x), p2d[:, 1] = row (y)
        p2d = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1).to(torch.float32)
    return idx, conf_mask, p2d, Kd


@torch.no_grad()
def estimate_poses(cnn, images, masks, cam_Ks, verts, feats, down_sample: int = 3,
                   keep_frac: float = 0.8, n_hyp: int = 500, reproj_err: float = 2.0,
                   generator: torch.Generator | None = None, samples=None, mesh=None,
                   replicas=None) -> PoseEstimate:
    """Poses for a batch of B images: images (B, S, S, 3) ImageNet-normalized
    crops, masks (B, S, S), cam_Ks (B, 3, 3), verts (M, 3), feats (M, 12).
    ``samples`` (B, n_hyp, 4) injects the RANSAC draws.  The images split
    over ``mesh``'s entries (None: one entry on the images' device), run on
    ``replicas`` ((CNN, verts, feats) on each entry; made here when None;
    without a mesh, the caller's own): each entry finds its images'
    correspondences (CNN, K3), the RANSAC draws are made on home for the
    whole batch from the gathered weights (or sliced from ``samples``), and
    each entry runs RANSAC on its images.  The results are gathered on
    home."""
    if mesh is None:
        mesh, replicas = mesh_lib.Mesh([images.device]), [(cnn, verts, feats)]
    elif replicas is None:
        replicas = replicate_model(cnn, verts, feats, mesh)
    parts = []
    for i, d, s in mesh_lib.shards(images.shape[0], mesh):
        idx, conf_mask, p2d, Kd = correspondences(replicas[i][0], images[s].to(d), masks[s].to(d), cam_Ks[s].to(d),
                                                  replicas[i][2], down_sample, keep_frac)
        parts.append((i, d, s, idx, conf_mask, p2d, Kd))
    if samples is None:
        with span("infer.draw"):
            weights = mesh_lib.gather([p[4] for p in parts], mesh).to(torch.float32)
            samples = pnp.draw_hypotheses(weights, n_hyp, generator)
    out = []
    for i, d, s, idx, conf_mask, p2d, Kd in parts:
        with span("infer.ransac"):
            res = pnp.ransac_pnp(replicas[i][1][idx.long()], p2d, Kd, weights=conf_mask.to(torch.float32),
                                 n_hyp=n_hyp, reproj_err=reproj_err, samples=samples[s].to(d))
        out.append((res.R, res.t, res.n_inliers, res.success, conf_mask))
    return PoseEstimate(*mesh_lib.gather(out, mesh))


def replicate_model(cnn, verts, feats, mesh: mesh_lib.Mesh) -> list:
    """Per mesh entry: (its own copy of the CNN, the baked points and keys
    on its device)."""
    return [(c, *vf) for c, vf in zip(mesh_lib.replicate(cnn, mesh), mesh_lib.broadcast((verts, feats), mesh))]


def estimate_pose_single(cnn, image, mask, cam_K, verts, feats, **kw) -> PoseEstimate:
    """One image: (S, S, 3), (S, S), (3, 3); results keep a batch dim of 1."""
    return estimate_poses(cnn, image[None], mask[None], cam_K[None], verts, feats, **kw)


def run_sequence(cnn, images, masks, cam_Ks, verts, feats, cfg: InferenceConfig = InferenceConfig(),
                 seed: int = 1, batch: int = 16, generator: torch.Generator | None = None,
                 samples=None, device=None, mesh="auto"):
    """Poses of a whole sequence, ``batch`` images at a time ->
    (pred_R (N, 3, 3), pred_t (N, 3)) as numpy.  ``samples`` (N, n_hyp, 4)
    injects the RANSAC draws; otherwise they come from ``generator`` (a
    fresh one seeded with ``seed`` when None).  With ``mesh`` (home: the
    CNN's device) each batch's images split over its entries."""
    device = torch.device(device) if device is not None else next(cnn.parameters()).device
    mesh = mesh_lib.resolve(mesh, device)
    if generator is None and samples is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32
    to = lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=f32).to(device)  # noqa: E731
    images, masks, cam_Ks, verts, feats = (to(x) for x in (images, masks, cam_Ks, verts, feats))
    N = images.shape[0]
    batch = max(min(batch, N), 1)
    replicas = None if mesh is None else replicate_model(cnn, verts, feats, mesh)
    Rs, ts = [], []
    for i in range(0, N, batch):
        sl = slice(i, i + batch)
        est = estimate_poses(
            cnn, images[sl], masks[sl], cam_Ks[sl], verts, feats,
            down_sample=cfg.down_sample, keep_frac=cfg.conf_keep_frac, n_hyp=cfg.ransac_iters,
            reproj_err=cfg.reproj_err_px, generator=generator,
            samples=None if samples is None else torch.as_tensor(samples[sl]).to(device), mesh=mesh,
            replicas=replicas,
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


def _draw_surfemb(generator: torch.Generator, cfg: InferenceConfig, n_keys: int, refine: bool) -> SurfEmbDraws:
    """One image's ``SurfEmbDraws`` from ``generator`` on its device, in
    the order ``_surfemb_core`` draws them (``sel`` None without
    refinement)."""
    dev = generator.device
    hyp = pose_est_surf.draw_hypotheses(cfg.max_poses, generator, dev)
    sel = torch.randperm(n_keys, generator=generator, device=dev) if refine else None
    return SurfEmbDraws(hyp.u, hyp.pick, sel)


def _surfemb_core(cnn, image, cam_K, verts, normals, feats, diameter: float, cfg: InferenceConfig, refine: bool,
                  refine_steps: int, translation_only: bool, generator=None, draws: SurfEmbDraws | None = None,
                  hyp_mesh=None):
    """One image: CNN -> hypothesis sampling and z-buffer scoring (split
    over ``hyp_mesh`` when given) -> the best -> optional refinement.
    Returns (R (3, 3), t (3,), score ())."""
    with span("surf.unet"), torch.no_grad():
        feat_full = cnn(image[None])[0]
        query_img, mask_lgts = feat_full[..., :12], feat_full[..., 12]
    hyp = None if draws is None else pose_est_surf.HypothesisDraws(draws.u, draws.pick)
    res = pose_est_surf.estimate_pose(
        mask_lgts, query_img, verts, normals, feats, diameter, cam_K, generator, down_sample=cfg.down_sample,
        max_poses=cfg.max_poses, max_pose_evaluations=cfg.max_pose_evaluations, alpha=cfg.alpha,
        dist_2d_min=cfg.dist_2d_min, draws=hyp, mesh=hyp_mesh,
    )
    best = torch.argmax(res.pose_scores)
    # each index by a device scalar reads it back on the card
    pose_est_surf.SURF_COUNT["host_reads"] += 3 * (best.device.type == "cuda")
    R, t, score = res.R[best], res.t[best], res.pose_scores[best]
    if refine:
        R, t, _ = pose_refine.refine_pose(R, t, query_img, cam_K, verts, feats, generator, n_steps=refine_steps,
                                          translation_only=translation_only,
                                          sel=None if draws is None else draws.sel)
    return R, t, score


def estimate_pose_surfemb(cnn, image, cam_K, verts, normals, feats, diameter: float,
                          cfg: InferenceConfig = InferenceConfig(), refine: bool = True, refine_steps: int = 50,
                          translation_only: bool = False, generator: torch.Generator | None = None,
                          draws: SurfEmbDraws | None = None, hyp_mesh=None):
    """The SurfEmb pose of one ImageNet-normalized crop (S, S, 3) with its
    crop camera (3, 3): hypothesis sampling and z-buffer scoring, then
    gradient refinement.  Returns (R, t, score): the best hypothesis' SurfEmb
    score (higher is better).  The draws come from ``generator`` unless
    ``draws`` hands them in.  ``hyp_mesh`` (home: the image's device) splits
    the hypotheses' P3P, pruning and scoring over its entries."""
    R, t, score = _surfemb_core(cnn, image, cam_K, verts, normals, feats, diameter, cfg, refine, refine_steps,
                                translation_only, generator, draws, mesh_lib.resolve(hyp_mesh, image.device))
    pose_est_surf.SURF_COUNT["host_reads"] += 1
    return R, t, float(score)


def run_sequence_surfemb(cnn, images, cam_Ks, verts, normals, feats, diameter: float,
                         cfg: InferenceConfig = InferenceConfig(), seed: int = 1, refine: bool = True,
                         refine_steps: int = 50, translation_only: bool = False,
                         generator: torch.Generator | None = None, draws=None, device=None, mesh="auto"):
    """``estimate_pose_surfemb`` over a sequence of N crops, one image at a
    time, on ``device`` (the card unless named; the mesh's home when only a
    mesh is given) -> (pred_R (N, 3, 3), pred_t (N, 3), scores (N,)) as
    numpy.  The images draw in turn from one generator (seeded with
    ``seed`` unless given), or ``draws`` hands in one ``SurfEmbDraws`` an
    image.  Every image's draws are made on home first, in sequence order;
    with ``mesh`` the images then split over its entries, each entry taking
    its images in turn with its own copy of the CNN."""
    mesh, dev = mesh_lib.place(mesh, device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    def f32(x):
        return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=torch.float32).to(dev)

    images, cam_Ks, verts, normals, feats = map(f32, (images, cam_Ks, verts, normals, feats))
    N = images.shape[0]
    if draws is None:
        draws = [_draw_surfemb(generator, cfg, feats.shape[0], refine) for _ in range(N)]
    if mesh is None:
        mesh, cnns, consts = mesh_lib.Mesh([dev]), [cnn], [(verts, normals, feats)]
    else:
        cnns, consts = mesh_lib.replicate(cnn, mesh), mesh_lib.broadcast((verts, normals, feats), mesh)
    shards = mesh_lib.shards(N, mesh)
    out = [None] * N
    # every entry's r-th image in turn, so each card has work queued
    for r in range(max(s.stop - s.start for *_, s in shards)):
        for i, d, s in shards:
            k = s.start + r
            if k < s.stop:
                out[k] = _surfemb_core(cnns[i], images[k].to(d), cam_Ks[k].to(d), *consts[i], diameter, cfg, refine,
                                       refine_steps, translation_only, None, mesh_lib.to(draws[k], d))
    R, t, s = (torch.stack([o[j].to(dev) for o in out]) for j in range(3))
    pose_est_surf.SURF_COUNT["host_reads"] += 3
    return R.cpu().numpy(), t.cpu().numpy(), s.cpu().numpy().astype(np.float32)
