"""Emission-absorption compositing and importance sampling (counterpart of
render/raymarch.py).

The composite here is the reference's eps-cumprod form,
``weights = density * shifted_cumprod((1 + eps) - density)``; the training
kernel's closed form lives with it in ops/field_kernel.py.
"""

from __future__ import annotations

from typing import Tuple

import torch


def shifted_cumprod(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """cumprod along the last axis, shifted right by `shift` with ones prepended."""
    cp = torch.cumprod(x, dim=-1)
    if shift <= 0:
        return cp
    return torch.cat([torch.ones_like(x[..., :shift]), cp[..., :-shift]], dim=-1)


def ea_weights(densities: torch.Tensor, eps: float = 1e-10, surface_thickness: int = 1) -> torch.Tensor:
    """weights = density * shifted_cumprod((1+eps) - density); densities (..., P)."""
    return densities * shifted_cumprod((1.0 + eps) - densities, shift=surface_thickness)


def threshold_densities(densities: torch.Tensor, threshold: float) -> torch.Tensor:
    """Binarize density > threshold."""
    return (densities > threshold).to(densities.dtype)


def weight_mode_densities(densities: torch.Tensor, threshold: float, eps: float = 1e-10,
                          surface_thickness: int = 1) -> torch.Tensor:
    """1 at the samples of largest EA weight along each ray that have
    density > threshold, 0 elsewhere; densities (..., P)."""
    above = (densities > threshold).to(densities.dtype)
    w = ea_weights(densities, eps, surface_thickness)
    top = (w - w.amax(-1, keepdim=True) >= 0).to(densities.dtype)
    return top * above


def composite(
    densities: torch.Tensor,
    features: torch.Tensor,
    eps: float = 1e-10,
    surface_thickness: int = 1,
    threshold_mode: bool = False,
    weight_mode: bool = False,
    threshold: float = 0.03,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """densities (..., P), features (..., P, C) ->
    (features+opacity (..., C+1), weights (..., P)).  ``threshold_mode``
    binarizes the densities at ``threshold``; else ``weight_mode`` keeps
    only each ray's top-weight sample above it."""
    if threshold_mode:
        densities = threshold_densities(densities, threshold)
    elif weight_mode:
        densities = weight_mode_densities(densities, threshold, eps, surface_thickness)
    weights = ea_weights(densities, eps, surface_thickness)
    feat = (weights[..., None] * features).sum(-2)
    opacity = 1.0 - torch.prod(1.0 - densities, dim=-1, keepdim=True)
    return torch.cat([feat, opacity], dim=-1), weights


def back_weights(densities: torch.Tensor, eps: float = 1e-10, surface_thickness: int = 1,
                 threshold_mode: bool = False, threshold: float = 0.05) -> torch.Tensor:
    """Weights of the last surface crossing along each ray: the EA weights
    with the cumprod taken from the ray's end (densities (..., P))."""
    if threshold_mode:
        densities = threshold_densities(densities, threshold)
    flipped = shifted_cumprod((1.0 + eps) - densities.flip(-1), shift=surface_thickness)
    return densities * flipped.flip(-1)


def surface_depth(lengths: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """max(lengths * weights) depth heuristic."""
    return (lengths * weights).amax(-1)


def surface_points(origins, directions, lengths, weights):
    """o + d * surface_depth."""
    return origins + directions * surface_depth(lengths, weights)[..., None]


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: torch.Generator | None = None, u: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` depths per ray: bins (..., B)
    sorted, weights (..., B-1) non-negative.  The uniforms ``u`` (...,
    n_samples) in [0, 1 - 1e-6) may be passed in; otherwise they are drawn
    from ``generator``."""
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1).contiguous()       # (..., B)
    if u is None:
        u = torch.rand(cdf.shape[:-1] + (n_samples,), generator=generator, device=cdf.device) * (1.0 - 1e-6)
    # idx = #(cdf <= u): the cdf is non-decreasing, so this is a right search
    idx = torch.searchsorted(cdf, u.contiguous(), right=True).clamp(1, cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, idx - 1), torch.gather(cdf, -1, idx)
    bin_b, bin_a = torch.gather(bins, -1, idx - 1), torch.gather(bins, -1, idx)
    denom = torch.where(cdf_a - cdf_b < 1e-10, torch.ones_like(cdf_a), cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


def importance_resample(lengths: torch.Tensor, weights: torch.Tensor, n_samples: int,
                        generator: torch.Generator | None = None, u: torch.Tensor | None = None,
                        add_input_samples: bool = True) -> torch.Tensor:
    """New depths from the (detached) coarse weight distribution at the bin
    midpoints, optionally joined with the input depths, sorted."""
    z_mid = 0.5 * (lengths[..., 1:] + lengths[..., :-1])
    z_new = sample_pdf(z_mid, weights[..., 1:-1].detach(), n_samples, generator, u)
    z = torch.cat([lengths, z_new], -1) if add_input_samples else z_new
    return torch.sort(z, -1).values


def huber(x: torch.Tensor, y: torch.Tensor, scaling: float = 0.1) -> torch.Tensor:
    """Smooth-L1 loss: (sqrt(1 + (x - y)^2 / s^2) - 1) * s."""
    diff_sq = (x - y) ** 2
    return (torch.sqrt(torch.clamp(1.0 + diff_sq / (scaling**2), min=1e-4)) - 1.0) * scaling


def mip360_distortion(lengths: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """mip-NeRF-360 distortion loss over rays of depths ``lengths`` and EA
    weights ``weights`` (both (..., P)), the depths normalized to [0, 1]
    per ray; the mean over rays.  Not used by training."""
    w = weights[..., :-1]
    t = lengths - lengths[..., 0:1]
    t = t / t.amax(-1, keepdim=True)
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = (ut[..., :, None] - ut[..., None, :]).abs()
    loss_inter = (w * (w[..., None, :] * dut).sum(-1)).sum(-1)
    loss_intra = (w**2 * (t[..., 1:] - t[..., :-1])).sum(-1) / 3
    return (loss_inter + loss_intra).mean()
