"""Registration finale (counterpart of pipeline/registration.py): Chamfer
verification of consecutive poses, point-to-point ICP with nearest
neighbours from kernel K2, and the Chamfer check against the CAD cloud."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import rotations
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc


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
