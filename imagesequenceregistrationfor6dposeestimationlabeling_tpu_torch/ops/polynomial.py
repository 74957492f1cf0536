"""Batched polynomial roots by Durand-Kerner (counterpart of ops/polynomial.py):
a fixed number of simultaneous root iterations in complex64."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _initial_roots(device: torch.device, D: int) -> torch.Tensor:
    """The standard initialization, powers of (0.4 + 0.9i): (D,) complex64
    on ``device``, made once, so that a call copies nothing from the host
    (a CUDA graph can capture it)."""
    w = [1.0 + 0.0j]
    for _ in range(D - 1):
        w.append(w[-1] * (0.4 + 0.9j))
    return torch.tensor(w, dtype=torch.complex64, device=device)


def durand_kerner(coeffs: torch.Tensor, n_iters: int = 40) -> torch.Tensor:
    """Roots of sum_k coeffs[..., k] x^(D-k) (highest degree first):
    (..., D+1) real or complex -> (..., D) complex64."""
    c = coeffs.to(torch.complex64)
    lead = c[..., 0:1]
    c = c / torch.where(lead.abs() < 1e-30, torch.full_like(lead, 1e-30), lead)
    D = c.shape[-1] - 1
    roots = _initial_roots(c.device, D).expand(c.shape[:-1] + (D,))
    eye = torch.eye(D, dtype=torch.bool, device=c.device)
    one = torch.ones((), dtype=torch.complex64, device=c.device)
    tiny = torch.full((), 1e-20, dtype=torch.complex64, device=c.device)
    for _ in range(n_iters):
        p = c[..., 0:1].expand(roots.shape)
        for i in range(1, D + 1):
            p = p * roots + c[..., i : i + 1]
        diff = roots[..., :, None] - roots[..., None, :]
        denom = torch.where(eye, one, diff).prod(-1)
        denom = torch.where(denom.abs() < 1e-20, tiny, denom)
        roots = roots - p / denom
    return roots


def real_roots_mask(roots: torch.Tensor, tol: float = 1e-3) -> torch.Tensor:
    """Boolean mask of (approximately) real roots."""
    return roots.imag.abs() < tol * (1.0 + roots.real.abs())
