"""Registration finale (counterpart of pipeline/registration.py):
relative-pose tensors, the pairwise agreement matrix and the best image,
Chamfer verification of consecutive poses, point-to-point ICP with nearest
neighbours from kernel K2, and the Chamfer check against the CAD cloud.

The reference shards the agreement matrix's pairs and the ICP sweeps over a
device mesh; one card needs none, so the port has no ``mesh`` argument."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import rotations
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc


def relative_pose_tensor(R: torch.Tensor, t: torch.Tensor):
    """(N, 3, 3), (N, 3) -> rel_R (N, N, 3, 3), rel_t (N, N, 3) with
    rel(i, j) = (R_i^T R_j, t_j - t_i), in f32 without TF32."""
    with no_tf32():
        rel_R = torch.einsum("ika,jkb->ijab", R, R)
    return rel_R, t[None, :, :] - t[:, None, :]


@torch.no_grad()
def agreement_matrix(rel_R_gt, rel_t_gt, rel_R_pred, rel_t_pred, verts, diameter: float, pair_chunk: int = 64):
    """((N, N) bool, (N, N) errors): per image pair, ADD-S between ``verts``
    (a subsample of a few hundred points) posed by the GT and by the
    predicted relative pose, against 0.1 x diameter.  Squared distances
    are ``|a|^2 + |b|^2 - 2 a.b`` as the reference takes them; the pairs
    run ``pair_chunk`` at a time."""
    N = rel_R_gt.shape[0]
    flat = [x.reshape(N * N, *x.shape[2:]) for x in (rel_R_gt, rel_t_gt, rel_R_pred, rel_t_pred)]
    errs = []
    with no_tf32():
        for i0 in range(0, N * N, pair_chunk):
            Rg, tg, Rp, tp = (x[i0: i0 + pair_chunk] for x in flat)
            a = verts @ Rg.transpose(-1, -2) + tg[:, None]          # (P, V, 3)
            b = verts @ Rp.transpose(-1, -2) + tp[:, None]
            a2 = (a * a).sum(-1, keepdim=True)
            b2 = (b * b).sum(-1, keepdim=True)
            d2 = torch.clamp_min(a2 + b2.transpose(-1, -2) - 2.0 * (a @ b.transpose(-1, -2)), 0.0)
            errs.append(torch.sqrt(d2.amin(-1).clamp_min(0.0)).mean(-1))
    errs = torch.cat(errs).reshape(N, N)
    return errs < 0.1 * diameter, errs


def choose_best_image(agree, top_k: int = 50):
    """The image with the most agreements (argmax of the row sums) and the
    ``top_k`` images in that order (numpy's default sort, as the
    reference's, so ties come out in the same order)."""
    sums = np.asarray(agree).sum(axis=1)
    order = np.argsort(-sums)
    return int(order[0]), order[:top_k]


class ICPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inlier_rmse: torch.Tensor
    fitness: torch.Tensor


@torch.no_grad()
def icp_point_to_point(source: torch.Tensor, target: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
                       threshold: float, max_iters: int = 30, source_mask=None,
                       target_mask=None) -> ICPResult:
    """Open3D registration_icp(PointToPoint) equivalent; x' = R x + t on source."""
    s_mask = torch.ones(source.shape[0], dtype=torch.bool, device=source.device) if source_mask is None \
        else source_mask.bool()
    R, t = R0, t0
    for _ in range(max_iters):
        moved = source @ R.T + t
        d, idx = pc.nn_query(moved, target, target_mask)
        w = (d < threshold) & s_mask
        Rk, tk = rotations.kabsch(moved, target[idx.long()], w.to(source.dtype))
        R, t = Rk @ R, Rk @ t + tk
    moved = source @ R.T + t
    d, _ = pc.nn_query(moved, target, target_mask)
    inl = (d < threshold) & s_mask
    n_inl = inl.sum().clamp_min(1)
    rmse = torch.sqrt(torch.where(inl, d * d, torch.zeros_like(d)).sum() / n_inl)
    fitness = inl.sum() / s_mask.sum().clamp_min(1)
    return ICPResult(R, t, rmse, fitness)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32).to(device)


@torch.no_grad()
def register_halves(upper, lower, R_gt_chosen, t_gt_chosen, R_pred_chosen, t_pred_chosen, cad_points,
                    diameter: float, icp_threshold: float = 20.0, icp_iters: int = 30, device=None):
    """Bring the upper half into the lower/CAD frame: pose it with the chosen
    image's GT pose, start ICP from the inverse of its predicted pose, merge
    with the lower half and take the Chamfer distance to the CAD cloud, on
    ``device`` (the card unless named)."""
    device = resolve_device(device)
    upper, lower, Rg, tg, Rp, tp, cad = (
        _f32(x, device) for x in (upper, lower, R_gt_chosen, t_gt_chosen, R_pred_chosen, t_pred_chosen,
                                  cad_points)
    )
    actual_upper = upper @ Rg.T + tg
    R_inv, t_inv = rotations.invert_pose(Rp, tp)
    res = icp_point_to_point(actual_upper, lower, R_inv, t_inv, icp_threshold, max_iters=icp_iters)
    moved = actual_upper @ res.R.T + res.t
    merged = torch.cat([moved, lower], dim=0)
    chamfer = float(pc.chamfer_distance(merged, cad))
    return {
        "R": res.R.cpu().numpy(),
        "t": res.t.cpu().numpy(),
        "fitness": float(res.fitness),
        "inlier_rmse": float(res.inlier_rmse),
        "chamfer": chamfer,
        "correct": chamfer < 0.1 * diameter,
        "merged": merged.cpu().numpy(),
    }


@torch.no_grad()
def verify_consecutive(cloud, R_gt, t_gt, R_pred, t_pred, device=None):
    """Per consecutive image pair, the Chamfer distance between the cloud
    rotated by the GT relative pose and by the predicted next pose
    (rotation only), on ``device`` (the card unless named).  Returns (best
    index, chamfer list)."""
    device = resolve_device(device)
    cloud, R_gt, t_gt, R_pred = (_f32(x, device) for x in (cloud, R_gt, t_gt, R_pred))
    rel_R, _ = rotations.relative_pose_se3(R_gt[:-1], t_gt[:-1], R_gt[1:], t_gt[1:])
    out = []
    for i in range(R_gt.shape[0] - 1):
        pc_gt = (cloud @ R_pred[i].T) @ rel_R[i]
        pc_pred = cloud @ R_pred[i + 1]
        out.append(float(pc.chamfer_distance(pc_gt, pc_pred)))
    return int(np.argmin(out)), out
