"""Volumetric rendering entry points (counterpart of render/renderer.py):
the density grid over [-1, 1]^3, and the coarse / fine ray renderers of
NeRF training, evaluated through the field's own color path."""

from __future__ import annotations

from typing import Callable

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.cameras import (
    Camera,
    RayBundle,
    monte_carlo_rays,
    ray_points,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch


@torch.no_grad()
def density_grid(field_density_fn: Callable, grid_res: int = 128, chunk: int = 262144,
                 device="cpu") -> torch.Tensor:
    """D[i, j, k] = density at (x=t[i], y=t[j], z=t[k]), t = linspace(-1, 1, R),
    evaluated ``chunk`` points at a time."""
    t = torch.linspace(-1.0, 1.0, grid_res, dtype=torch.float32, device=device)
    xx, yy, zz = torch.meshgrid(t, t, t, indexing="ij")
    pts = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)
    dens = torch.cat([field_density_fn(p)[..., 0] for p in torch.split(pts, chunk)])
    return dens.reshape(grid_res, grid_res, grid_res)


def density_grid_cached(field, grid_res: int = 128, chunk: int = 262144) -> torch.Tensor:
    """``density_grid`` of a NerfField, through the density kernel when it
    is enabled for the field (the name keeps the reference's)."""
    device = next(field.parameters()).device
    return density_grid(field_kernel.density_eval_fn(field), grid_res, chunk, device)


def render_bundle(field_fn: Callable, bundle: RayBundle, mode: str = "color", threshold_mode: bool = False,
                  threshold: float = 0.03, eps: float = 1e-10):
    """Evaluate ``field_fn(points, view_dirs, mode) -> (densities (..., P, 1),
    feats)`` along the rays and EA-composite: (images (..., C+1), weights
    (..., P))."""
    dens, feats = field_fn(ray_points(bundle), bundle.directions, mode)
    return raymarch.composite(dens[..., 0], feats, eps=eps, threshold_mode=threshold_mode, threshold=threshold)


def render_coarse_fine(coarse_fn: Callable, fine_fn: Callable, cam: Camera, n_rays: int, n_pts_coarse: int,
                       n_pts_fine: int, min_depth: float, max_depth: float, add_input_samples: bool = True,
                       generator: torch.Generator | None = None, draws=None):
    """Coarse field on stratified Monte-Carlo rays, fine field on depths
    resampled from the detached coarse weights.  ``draws`` = (xys, u,
    u_pdf) replaces the draws from ``generator``.  Returns (coarse images,
    fine images, ray xys); images are rgb + silhouette."""
    xys, u, u_pdf = draws if draws is not None else (None, None, None)
    bundle = monte_carlo_rays(cam, n_rays, n_pts_coarse, min_depth, max_depth, generator, xys, u)
    coarse_img, coarse_w = render_bundle(coarse_fn, bundle)
    z_fine = raymarch.importance_resample(bundle.lengths, coarse_w.detach(), n_pts_fine, generator, u_pdf,
                                          add_input_samples=add_input_samples)
    fine_img, _ = render_bundle(fine_fn, bundle._replace(lengths=z_fine))
    return coarse_img, fine_img, bundle.xys
