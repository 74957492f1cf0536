"""SO(3)/SE(3) utilities (counterpart of the reference's geometry/rotations.py).

Everything takes explicit leading batch dimensions where the reference
relied on ``vmap``.
"""

from __future__ import annotations

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import graphs


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def rotvec_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues exp-map, (..., 3) -> (..., 3, 3), Taylor-safe at 0."""
    theta2 = (rvec * rvec).sum(-1, keepdim=True)[..., None]
    K = hat(rvec)
    K2 = K @ K
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a * K + b * K2


def matrix_to_rotvec(R: torch.Tensor) -> torch.Tensor:
    """Log-map, (..., 3, 3) -> (..., 3); near pi the axis comes from the
    diagonal of (R + I) / 2, its signs from the off-diagonals of the row of
    the largest axis component."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(((trace - 1.0) / 2.0).clamp(-1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    scale_generic = theta / (2.0 * torch.sin(theta)).clamp_min(1e-12)
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0, scale_generic)
    generic = w * scale[..., None]

    A = (R + torch.eye(3, dtype=R.dtype, device=R.device)) / 2.0
    axis_sq = torch.diagonal(A, dim1=-2, dim2=-1).clamp(0.0, 1.0)
    axis = torch.sqrt(axis_sq)
    idx = axis_sq.argmax(-1)
    s01, s02, s12 = torch.sign(A[..., 0, 1]), torch.sign(A[..., 0, 2]), torch.sign(A[..., 1, 2])
    a0, a1, a2 = axis.unbind(-1)
    candidates = torch.stack([torch.stack([a0, a1 * s01, a2 * s02], -1),
                              torch.stack([a0 * s01, a1, a2 * s12], -1),
                              torch.stack([a0 * s02, a1 * s12, a2], -1)], -2)       # (..., 3, 3)
    pi_axis = torch.gather(candidates, -2, idx[..., None, None].expand(*idx.shape, 1, 3))[..., 0, :]
    near_pi = theta > (torch.pi - 1e-3)
    return torch.where(near_pi[..., None], pi_axis * theta[..., None], generic)


def euler_zyx_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """rot_z @ rot_y @ rot_x of (..., 3) euler angles (x, y, z)."""
    x, y, z = euler.unbind(-1)
    one, zero = torch.ones_like(x), torch.zeros_like(x)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([(one, zero, zero), (zero, x.cos(), -x.sin()), (zero, x.sin(), x.cos())])
    ry = mat([(y.cos(), zero, y.sin()), (zero, one, zero), (-y.sin(), zero, y.cos())])
    rz = mat([(z.cos(), -z.sin(), zero), (z.sin(), z.cos(), zero), (zero, zero, one)])
    return rz @ ry @ rx


def relative_pose(R1, t1, R2, t2):
    """(R1^T R2, t2 - t1)."""
    return R1.transpose(-1, -2) @ R2, t2 - t1


def relative_pose_se3(R1, t1, R2, t2):
    """T2 @ inv(T1): (R2 R1^T, t2 - R2 R1^T t1)."""
    rel_R = R2 @ R1.transpose(-1, -2)
    rel_t = t2 - (rel_R @ t1[..., None])[..., 0]
    return rel_R, rel_t


def invert_pose(R, t):
    """Inverse of x -> R x + t."""
    RT = R.transpose(-1, -2)
    return RT, -(RT @ t[..., None])[..., 0]


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None):
    """Best-fit rigid (R, t) minimizing ||R src + t - dst||^2.

    src, dst: (..., N, 3); weights: (..., N) optional.  Returns
    R (..., 3, 3), t (..., 3).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / weights.sum(-1, keepdim=True).clamp_min(1e-12)
    mu_s = (src * w[..., None]).sum(-2)
    mu_d = (dst * w[..., None]).sum(-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    return kabsch_solve((sc * w[..., None]).transpose(-1, -2) @ dc, mu_s, mu_d)


def kabsch_solve(H: torch.Tensor, mu_s: torch.Tensor, mu_d: torch.Tensor):
    """Kabsch's (R, t) from the weighted cross-covariance H (..., 3, 3) of
    the centred points and the weighted means mu_s, mu_d (..., 3).  The
    SVD checks its convergence on the host, so a CUDA graph is cut there."""
    U, _, Vt = graphs.cut(torch.linalg.svd, H)
    V = Vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = V @ D @ U.transpose(-1, -2)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


def transform_points(R, t, pts):
    """x -> R x + t for row points: pts (..., N, 3) @ R^T + t."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]
