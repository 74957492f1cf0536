"""Volumetric rendering entry points (counterpart of render/renderer.py):
the density grid over [-1, 1]^3, the coarse / fine ray renderers of NeRF
training, evaluated through the field's own color path, and the chunked,
full-grid and back-ray renders of the correspondence stage and the
previews."""

from __future__ import annotations

from typing import Callable

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.cameras import (
    Camera,
    RayBundle,
    grid_rays,
    monte_carlo_rays,
    ray_points,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch


@torch.no_grad()
def density_grid(field_density_fn: Callable, grid_res: int = 128, chunk: int = 262144,
                 device=None) -> torch.Tensor:
    """D[i, j, k] = density at (x=t[i], y=t[j], z=t[k]), t = linspace(-1, 1, R),
    evaluated ``chunk`` points at a time on ``device`` (the card unless
    named)."""
    device = resolve_device(device)
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


def render_rays_chunked(field_fn: Callable, bundle: RayBundle, mode: str = "feature", threshold_mode: bool = True,
                        threshold: float = 0.2, chunk: int = 32768):
    """EA render of a flat bundle of N rays, ``chunk`` rays at a time (the
    last chunk ragged): (images (N, C+1), weights (N, P))."""
    images, weights = [], []
    for part in bundle_chunks(bundle, chunk):
        img, w = render_bundle(field_fn, part, mode=mode, threshold_mode=threshold_mode, threshold=threshold)
        images.append(img)
        weights.append(w)
    return torch.cat(images), torch.cat(weights)


def render_grid_chunked(field_fn: Callable, cam: Camera, image_size: int, n_pts: int, min_depth, max_depth,
                        mode: str = "feature", threshold_mode: bool = True, threshold: float = 0.2,
                        chunk: int = 32768):
    """EA render of one camera's full S x S pixel grid, ``chunk`` rays at a
    time: (images (S*S, C+1), weights (S*S, P), bundle)."""
    bundle = grid_rays(cam, image_size, n_pts, min_depth, max_depth)
    images, weights = render_rays_chunked(field_fn, bundle, mode=mode, threshold_mode=threshold_mode,
                                          threshold=threshold, chunk=chunk)
    return images, weights, bundle


def bundle_chunks(bundle: RayBundle, chunk: int):
    """The flat bundle's rays ``chunk`` at a time, the last chunk ragged."""
    for i0 in range(0, bundle.origins.shape[0], chunk):
        c = slice(i0, i0 + chunk)
        yield RayBundle(bundle.origins[c], bundle.directions[c], bundle.lengths[c], bundle.xys[c])


def back_ray_bundle(front_bundle: RayBundle, front_hits: torch.Tensor, div: float = 3.0) -> RayBundle:
    """Rays from the front surface hits away from the camera: origin = the
    hit, direction = -normalize(camera origin), lengths = (l - l0) / div."""
    o = front_bundle.origins
    d = -o / torch.linalg.vector_norm(o, dim=-1, keepdim=True)
    lengths = (front_bundle.lengths - front_bundle.lengths[..., 0:1]) / div
    return RayBundle(origins=front_hits, directions=d, lengths=lengths, xys=front_bundle.xys)


def masked_ray_indices(silhouette: torch.Tensor, n_rays: int, generator: torch.Generator | None = None,
                       gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """``n_rays`` flat pixel indices drawn uniformly, with replacement, from
    the silhouette's pixels (from all pixels if it has none): the argmax of
    the mask's logits plus Gumbel noise (n_rays, H*W), which may be passed in
    as ``gumbel``; otherwise it is drawn from ``generator``."""
    flat = silhouette.reshape(-1)
    logits = torch.where(flat > 0.5, 0.0, -1e9)
    if gumbel is None:
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand((n_rays, flat.shape[0]), generator=generator, device=flat.device).clamp_min(tiny)
        gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel.to(flat.device), dim=-1)


def render_depth(bundle: RayBundle, weights: torch.Tensor) -> torch.Tensor:
    """Per-ray depth from the EA weights: the largest length x weight."""
    return raymarch.surface_depth(bundle.lengths, weights)


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
