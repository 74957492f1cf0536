"""Pose-quality metrics (counterpart of ops/metrics.py): ADD, ADD-S (its
nearest neighbours from kernel K2 on the card) and the 0.1 x diameter
criterion."""

from __future__ import annotations

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.pointcloud import nn_query


def add_metric(verts: torch.Tensor, R_gt, t_gt, R_est, t_est) -> torch.Tensor:
    """ADD: mean vertex distance under the two poses (column convention).
    verts (V, 3); poses may carry a leading batch dim -> (...,)."""
    a = verts @ R_gt.transpose(-1, -2) + t_gt[..., None, :]
    b = verts @ R_est.transpose(-1, -2) + t_est[..., None, :]
    return torch.linalg.vector_norm(a - b, dim=-1).mean(-1)


def adds_metric(verts: torch.Tensor, R_gt, t_gt, R_est, t_est, surface_points=None) -> torch.Tensor:
    """ADD-S: mean distance from each GT-posed vertex to its nearest
    neighbour in the estimate-posed ``surface_points`` (default ``verts``).
    One pose: verts (V, 3), R (3, 3), t (3,) -> ()."""
    if surface_points is None:
        surface_points = verts
    a = verts @ R_gt.T + t_gt
    b = surface_points @ R_est.T + t_est
    d, _ = nn_query(a.contiguous(), b.contiguous())
    return d.mean()


def pose_correct(verts, R_gt, t_gt, R_est, t_est, diameter: float, symmetric: bool = False,
                 surface_points=None) -> torch.Tensor:
    """ADD (ADD-S when ``symmetric``) below 0.1 x ``diameter``."""
    if symmetric:
        m = adds_metric(verts, R_gt, t_gt, R_est, t_est, surface_points=surface_points)
    else:
        m = add_metric(verts, R_gt, t_gt, R_est, t_est)
    return m < 0.1 * diameter
