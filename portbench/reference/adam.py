"""Plain Adam (optax.adam: b1 0.9, b2 0.999, eps 1e-8; update k, from 0,
takes the bias corrections of count k + 1) and the two learning-rate
schedules the trainers publish."""

from __future__ import annotations

import numpy as np
import torch


def warmup_rate(lr: float, warmup: int, count: int) -> float:
    """NeRF training: linear from 2 % of ``lr`` to ``lr`` over ``warmup``
    updates (optax.linear_schedule), at update ``count``."""
    if warmup <= 0:
        return float(np.float32(lr))
    c = np.float32(min(max(count, 0), warmup))
    frac = np.float32(1) - c / np.float32(warmup)
    return float(np.float32(lr * 0.02 - lr) * frac + np.float32(lr))


def ramp_rate(lr: float, warmup: int, count: int) -> float:
    """Descriptor training: ``lr * min((count + 1) / warmup, 1)``."""
    f = np.float32
    return float(f(lr) * np.minimum(f(count + 1) / f(warmup), f(1)))


class Adam:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: list, weight_decay: float = 0.0):
        self.params = params
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.weight_decay = weight_decay

    @torch.no_grad()
    def update(self, grads: list, lr: float):
        c = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * g * (1 - self.b2))
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay > 0:
                upd = upd + self.weight_decay * p
            p.add_(-lr * upd)
        self.count += 1
