"""Gradient pose refinement (counterpart of pipeline/pose_refine.py).

Maximizes the mean query-key log-probability of the surface visible under
the initial pose over (rotvec, t), the gradient from ``torch.autograd``:
BFGS with a backtracking Armijo line search and a trust region, or plain
gradient descent when ``lr > 0``.  ``translation_only`` holds the rotation.

The line search evaluates its 12 trial points (alpha = 1, 1/2, ..., 1/2^11:
they depend only on the step direction) as one batch and takes the first
that passes, as the reference's scan over all 12 with no early exit does;
no step reads a value back to the host.
"""

from __future__ import annotations

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import rotvec_to_matrix
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.grid_sample import grid_sample
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.pointcloud import nn_query
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.rasterize import render_object_coords

# pixels of the denominator image's logits (pixels x keys) taken at a time
DENOM_CHUNK = 4096


def _value_and_grad(f, x: torch.Tensor):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        fx = f(x[None])[0]
        (g,) = torch.autograd.grad(fx, x)
    return fx.detach(), g


def _bfgs(f, x0: torch.Tensor, n_steps: int, n_backtrack: int = 12, max_step: float = 1.0):
    """Minimal BFGS with a backtracking Armijo line search and a trust region
    of ``max_step``.  ``f`` maps a batch of points (B, d) to values (B,)."""
    dim = x0.shape[0]
    eye = torch.eye(dim, dtype=x0.dtype, device=x0.device)
    alphas = 0.5 ** torch.arange(n_backtrack, dtype=x0.dtype, device=x0.device)
    x, (fx, g), H = x0, _value_and_grad(f, x0), eye
    for _ in range(n_steps):
        p = torch.nan_to_num(-(H @ g))
        p_norm = torch.linalg.vector_norm(p)
        p = torch.where(p_norm > max_step, p * (max_step / p_norm.clamp_min(1e-12)), p)
        with torch.no_grad():
            f_try = f(x[None] + alphas[:, None] * p[None])
        ok = f_try <= fx + 1e-4 * alphas * torch.dot(g, p)
        # the first passing trial, or no step where none passes
        alpha = torch.where(ok.any(), alphas[torch.argmax(ok.to(torch.int8))], torch.zeros_like(fx))
        s = alpha * p
        x_new = x + s
        f_new, g_new = _value_and_grad(f, x_new)
        y = g_new - g
        sy = torch.dot(s, y)
        # the curvature condition guards against an exploding inverse Hessian
        curv_ok = sy > 1e-8 * torch.linalg.vector_norm(s) * torch.linalg.vector_norm(y) + 1e-20
        rho = torch.where(curv_ok, 1.0 / torch.where(curv_ok, sy, torch.ones_like(sy)), torch.zeros_like(sy))
        V = eye - rho * torch.outer(s, y)
        H = torch.where(curv_ok, V @ H @ V.T + rho * torch.outer(s, s), H)
        # a non-finite value rejects the step
        bad = ~torch.isfinite(f_new)
        x = torch.where(bad, x, x_new)
        g = torch.where(bad, g, g_new)
        fx = torch.where(bad, fx, f_new)
    return x, fx


def refine_pose(R0: torch.Tensor, t0: torch.Tensor, query_img: torch.Tensor, K: torch.Tensor, surf_pts: torch.Tensor,
                surf_keys: torch.Tensor, generator: torch.Generator | None = None, n_steps: int = 50, lr: float = 0.0,
                translation_only: bool = False, n_denom: int = 10960, sel: torch.Tensor | None = None):
    """(R, t, final objective) refined from (R0, t0): query_img (res, res, e),
    the crop camera K (3, 3), the baked points and keys (M, 3) / (M, e).  The
    objective is -mean log-probability / 2 (lower is better) over the pixels
    the surface covers under the initial pose.  The denominator's key subset
    is ``sel`` (the first n_denom entries of a permutation of the M keys)
    when passed in, else drawn from ``generator``."""
    res = query_img.shape[0]
    dev = query_img.device
    with torch.no_grad():
        # the visible surface under the initial pose, and its keys: the key
        # of each rendered coordinate's nearest baked point (K2 on the card)
        coords, mask = render_object_coords(surf_pts, R0, t0, K, res)
        coord_flat = coords.reshape(-1, 3)
        vis = (mask.reshape(-1) > 0.5).to(torch.float32)
        _, nn_idx = nn_query(coord_flat, surf_pts)
        keys_vis = surf_keys[nn_idx.long()]
        # the per-pixel log-denominator over a random key subset
        m = surf_keys.shape[0]
        if sel is None:
            sel = torch.randperm(m, generator=generator, device=dev)
        sub = surf_keys[torch.as_tensor(sel, device=dev)[: min(n_denom, m)].long()]
        q_flat = query_img.reshape(-1, query_img.shape[-1])
        parts = []
        for c in torch.split(q_flat, DENOM_CHUNK):
            with no_tf32():
                parts.append(torch.logsumexp(c @ sub.T, dim=-1))
        denom_img = torch.cat(parts).reshape(res, res, 1)
        # rotations in radians, translations in units of 10 % of the camera
        # distance: balanced gradients, one trust region for both blocks
        t_scale = 0.1 * torch.linalg.vector_norm(t0)
        n_vis = vis.sum().clamp_min(1.0)

    def pose(params):
        w, dt = params[..., :3], params[..., 3:] * t_scale
        if translation_only:
            w = w * 0.0
        return rotvec_to_matrix(w) @ R0, t0 + dt

    def objective(params):                       # (B, 6) -> (B,)
        R, t = pose(params)
        with no_tf32():
            xc = coord_flat @ R.transpose(-1, -2) + t[:, None, :]   # (B, N, 3)
        u = K[0, 0] * xc[..., 0] / xc[..., 2] + K[0, 2]
        v = K[1, 1] * xc[..., 1] / xc[..., 2] + K[1, 2]
        # grid_sample's align_corners=False pixel convention
        grid = torch.stack([(u + 0.5) * (2.0 / res) - 1.0, (v + 0.5) * (2.0 / res) - 1.0], dim=-1)
        B, N = grid.shape[:2]
        grid = grid.reshape(1, B * N, 2)
        q = grid_sample(query_img[None], grid, mode="bilinear", align_corners=False, padding_mode="border")
        d = grid_sample(denom_img[None], grid, mode="bilinear", align_corners=False, padding_mode="border")
        log_nom = (q.reshape(B, N, -1) * keys_vis).sum(-1)
        per_px = (log_nom - d.reshape(B, N)) * vis
        return -(per_px.sum(-1) / n_vis) / 2.0

    x0 = torch.zeros(6, dtype=torch.float32, device=dev)
    if lr > 0:
        x = x0
        for _ in range(n_steps):
            x = x - lr * _value_and_grad(objective, x)[1]
        with torch.no_grad():
            fval = objective(x[None])[0]
    else:
        x, fval = _bfgs(objective, x0, n_steps, max_step=0.3)
    with torch.no_grad():
        R, t = pose(x)
    return R, t, fval
