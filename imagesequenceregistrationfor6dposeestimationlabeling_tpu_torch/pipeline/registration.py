"""Registration finale (counterpart of pipeline/registration.py):
relative-pose tensors, the pairwise agreement matrix and the best image,
Chamfer verification of consecutive poses, point-to-point ICP with nearest
neighbours from kernel K2, and the Chamfer check against the CAD cloud.

With a device ``mesh`` (``parallel.mesh``), the agreement matrix splits
its pairs over the entries, ICP its source points (each entry runs K2 on
its share against the whole target; the Kabsch sums and the fitness are
per-entry partial sums reduced on home in entry order), and the Chamfer
distances their queries.  ``register_halves`` and ``verify_consecutive``
take ``mesh="auto"``, the reference's default: every card when there are
several, else none."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import rotations
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib


def relative_pose_tensor(R: torch.Tensor, t: torch.Tensor):
    """(N, 3, 3), (N, 3) -> rel_R (N, N, 3, 3), rel_t (N, N, 3) with
    rel(i, j) = (R_i^T R_j, t_j - t_i), in f32 without TF32."""
    with no_tf32():
        rel_R = torch.einsum("ika,jkb->ijab", R, R)
    return rel_R, t[None, :, :] - t[:, None, :]


def _pair_adds(flat, verts, pair_chunk: int) -> torch.Tensor:
    """ADD-S of each pair of the flat (P, ...) relative poses, ``pair_chunk``
    pairs at a time."""
    errs = []
    with no_tf32():
        for i0 in range(0, flat[0].shape[0], pair_chunk):
            Rg, tg, Rp, tp = (x[i0: i0 + pair_chunk] for x in flat)
            a = verts @ Rg.transpose(-1, -2) + tg[:, None]          # (P, V, 3)
            b = verts @ Rp.transpose(-1, -2) + tp[:, None]
            a2 = (a * a).sum(-1, keepdim=True)
            b2 = (b * b).sum(-1, keepdim=True)
            d2 = torch.clamp_min(a2 + b2.transpose(-1, -2) - 2.0 * (a @ b.transpose(-1, -2)), 0.0)
            errs.append(torch.sqrt(d2.amin(-1).clamp_min(0.0)).mean(-1))
    return torch.cat(errs)


@torch.no_grad()
def agreement_matrix(rel_R_gt, rel_t_gt, rel_R_pred, rel_t_pred, verts, diameter: float, pair_chunk: int = 64,
                     mesh=None):
    """((N, N) bool, (N, N) errors): per image pair, ADD-S between ``verts``
    (a subsample of a few hundred points) posed by the GT and by the
    predicted relative pose, against 0.1 x diameter.  Squared distances
    are ``|a|^2 + |b|^2 - 2 a.b`` as the reference takes them; the pairs
    run ``pair_chunk`` at a time, split over ``mesh``'s entries when one is
    given (the errors gathered on home)."""
    N = rel_R_gt.shape[0]
    flat = [x.reshape(N * N, *x.shape[2:]) for x in (rel_R_gt, rel_t_gt, rel_R_pred, rel_t_pred)]
    if mesh is None:
        errs = _pair_adds(flat, verts, pair_chunk)
    else:
        vs = mesh_lib.broadcast(verts, mesh)
        errs = mesh_lib.gather([_pair_adds([x[s].to(d) for x in flat], vs[i], pair_chunk)
                                for i, d, s in mesh_lib.shards(N * N, mesh)], mesh)
    errs = errs.reshape(N, N)
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
                       target_mask=None, mesh=None) -> ICPResult:
    """Open3D registration_icp(PointToPoint) equivalent; x' = R x + t on
    source.  The source points split over ``mesh``'s entries (none: one
    entry on the source's device): each entry moves its share and runs K2
    against the whole target on its device; every sum of the step (Kabsch's
    weight total, weighted means and cross-covariance, then the inliers and
    their squared distances) is a per-entry partial sum, reduced on home in
    entry order with the single-device formula's roundings."""
    if source.shape[0] == 0:
        raise ValueError("icp_point_to_point: empty source cloud")
    s_mask = torch.ones(source.shape[0], dtype=torch.bool, device=source.device) if source_mask is None \
        else source_mask.bool()
    mesh = mesh or mesh_lib.Mesh([source.device])
    refs = mesh_lib.broadcast((target, target_mask), mesh)
    parts = [(source[s].to(d), s_mask[s].to(d), *refs[i]) for i, d, s in mesh_lib.shards(source.shape[0], mesh)]

    def total(xs):
        return mesh_lib.reduce_sum(xs, mesh)

    def nearest(R, t):
        """Per entry: (moved share, its K2 distance and index, its mask, the target)."""
        out = []
        for src, sm, tgt, tm in parts:
            moved = src @ R.to(src.device).T + t.to(src.device)
            dist, idx = pc.nn_query(moved, tgt, tm)
            out.append((moved, dist, idx, sm, tgt))
        return out

    R, t = R0, t0
    for _ in range(max_iters):
        near = nearest(R, t)
        ws = [((dist < threshold) & sm).to(source.dtype) for _, dist, _, sm, _ in near]
        W = total([w.sum(-1, keepdim=True) for w in ws]).clamp_min(1e-12)
        ws = [w / W.to(w.device) for w in ws]
        dsts = [tgt[idx.long()] for _, _, idx, _, tgt in near]
        mu_s = total([(m * w[:, None]).sum(-2) for (m, *_), w in zip(near, ws)])
        mu_d = total([(dd * w[:, None]).sum(-2) for dd, w in zip(dsts, ws)])
        H = total([((m - mu_s.to(m.device)) * w[:, None]).T @ (dd - mu_d.to(m.device))
                   for (m, *_), dd, w in zip(near, dsts, ws)])
        Rk, tk = rotations.kabsch_solve(H, mu_s, mu_d)
        R, t = Rk @ R, Rk @ t + tk
    near = nearest(R, t)
    inls = [(dist < threshold) & sm for _, dist, _, sm, _ in near]
    n_in = total([i.sum() for i in inls])
    sq = total([torch.where(i, dist * dist, torch.zeros_like(dist)).sum() for i, (_, dist, *_) in zip(inls, near)])
    return ICPResult(R, t, torch.sqrt(sq / n_in.clamp_min(1)), n_in / s_mask.sum().clamp_min(1))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32).to(device)


@torch.no_grad()
def register_halves(upper, lower, R_gt_chosen, t_gt_chosen, R_pred_chosen, t_pred_chosen, cad_points,
                    diameter: float, icp_threshold: float = 20.0, icp_iters: int = 30, device=None, mesh="auto"):
    """Bring the upper half into the lower/CAD frame: pose it with the chosen
    image's GT pose, start ICP from the inverse of its predicted pose, merge
    with the lower half and take the Chamfer distance to the CAD cloud, on
    ``device`` (the card unless named; the mesh's home when only a mesh is
    given), ICP and Chamfer split over ``mesh``."""
    mesh, device = mesh_lib.place(mesh, device)
    upper, lower, Rg, tg, Rp, tp, cad = (
        _f32(x, device) for x in (upper, lower, R_gt_chosen, t_gt_chosen, R_pred_chosen, t_pred_chosen,
                                  cad_points)
    )
    actual_upper = upper @ Rg.T + tg
    R_inv, t_inv = rotations.invert_pose(Rp, tp)
    res = icp_point_to_point(actual_upper, lower, R_inv, t_inv, icp_threshold, max_iters=icp_iters, mesh=mesh)
    moved = actual_upper @ res.R.T + res.t
    merged = torch.cat([moved, lower], dim=0)
    chamfer = float(pc.chamfer_distance(merged, cad, mesh=mesh))
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
def verify_consecutive(cloud, R_gt, t_gt, R_pred, t_pred, device=None, mesh="auto"):
    """Per consecutive image pair, the Chamfer distance between the cloud
    rotated by the GT relative pose and by the predicted next pose
    (rotation only), on ``device`` (the card unless named; the mesh's home
    when only a mesh is given), each Chamfer split over ``mesh``.  Returns
    (best index, chamfer list)."""
    mesh, device = mesh_lib.place(mesh, device)
    cloud, R_gt, t_gt, R_pred = (_f32(x, device) for x in (cloud, R_gt, t_gt, R_pred))
    rel_R, _ = rotations.relative_pose_se3(R_gt[:-1], t_gt[:-1], R_gt[1:], t_gt[1:])
    out = []
    for i in range(R_gt.shape[0] - 1):
        pc_gt = (cloud @ R_pred[i].T) @ rel_R[i]
        pc_pred = cloud @ R_pred[i + 1]
        out.append(float(pc.chamfer_distance(pc_gt, pc_pred, mesh=mesh)))
    return int(np.argmin(out)), out
