"""Plain PyTorch radiance field with its SurfEmb key head, as published
(Kudo510/ImageSequenceRegistrationfor6DPoseEstimationLabeling nerf.py
107, 149-218): a function of a parameter dict.

* harmonic embedding of xyz: sin and cos of x * omega0 * 2^f for f < H,
  [sin block | cos block], each coordinate-major;
* trunk: two Dense(n_hidden) + softplus(beta);
* density: 1 - exp(-softplus(h . wd + bd)), in float32;
* colour: Dense over [h | embed(unit view dir)], softplus, Dense(3),
  sigmoid;
* key head: SIREN 3 -> n_hidden x 2 -> feature_dim (sin(30 (W x + b))
  layers, a linear output) in float32, or with ``siren`` false
  sigmoid(Dense(softplus(Dense(embed(xyz))))).

Rounding follows the configuration: a Dense takes ``compute_dtype``
operands, its product and its bias are rounded to that type (flax's
``Dense(dtype=...)``), the nonlinearity runs in float32 and the stored
activation is rounded to ``act_dtype``.  ``prec`` supplies the rounding
(``precision.Precision``), so the control runs the same code a step lower.

Parameter names and layouts are those of the field's state dict
(``trunk1.weight`` is (out, in)); the benchmark makes the values and hands
the same dict to the program and to this reference.
"""

from __future__ import annotations

import torch


def harmonic_embedding(x: torch.Tensor, n_harmonic: int, omega0: float) -> torch.Tensor:
    lead = x.shape[:-1]
    freqs = omega0 * (2.0 ** torch.arange(n_harmonic, dtype=torch.float32, device=x.device))
    ang = (x[..., None] * freqs).reshape(*lead, -1)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softplus(x: torch.Tensor, beta: float) -> torch.Tensor:
    y = x * beta
    return (torch.relu(y) + torch.log1p(torch.exp(-y.abs()))) / beta


class Field:
    """The field of ``cfg`` (the configuration's ``field`` group) over the
    parameter dict ``p``.  ``compute`` rounds products' operands and
    results; ``store`` rounds stored activations."""

    def __init__(self, cfg: dict, p: dict, compute, store):
        self.cfg, self.p, self.compute, self.store = cfg, p, compute, store

    def dense(self, x, name: str, bias: bool = True):
        r = self.compute.round
        y = r(r(x) @ r(self.p[name + ".weight"]).T)
        return r(y + r(self.p[name + ".bias"])) if bias else y

    def act(self, x):
        return self.store.round(softplus(x, self.cfg["softplus_beta"]))

    def embed(self, x):
        return self.store.round(harmonic_embedding(x, self.cfg["n_harmonic_functions"], self.cfg["omega0"]))

    def trunk(self, pts):
        return self.act(self.dense(self.act(self.dense(self.embed(pts), "trunk1")), "trunk2"))

    def density(self, h):
        raw = softplus(h @ self.p["density_layer.weight"].T + self.p["density_layer.bias"], self.cfg["softplus_beta"])
        return 1.0 - torch.exp(-raw)

    def color(self, h, dirs):
        """rgb per point from the trunk's h (..., P, nh) and one view
        direction a ray (..., 3)."""
        nh, r = self.cfg["n_hidden"], self.compute.round
        w, b = self.p["color1.weight"], self.p["color1.bias"]
        d = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
        hpart = r(r(h) @ r(w[:, :nh]).T)
        dpart = r(r(r(self.embed(d)) @ r(w[:, nh:]).T) + r(b))
        x = self.act(r(hpart + dpart[..., None, :]))
        return torch.sigmoid(self.dense(x, "color2"))

    def forward(self, pts, dirs):
        """(density (..., P), rgb (..., P, 3)) at points (..., P, 3) of rays
        with directions (..., 3)."""
        h = self.trunk(pts)
        return self.density(h)[..., 0], self.color(h, dirs)

    def keys(self, pts):
        """feature_dim-d keys (..., E) of the key head."""
        if self.cfg["siren"]:
            h = pts
            for i in range(3):
                h = torch.sin(30.0 * (h @ self.p[f"feature_layer.layers.{i}.weight"].T
                                      + self.p[f"feature_layer.layers.{i}.bias"]))
            return h @ self.p["feature_layer.out.weight"].T + self.p["feature_layer.out.bias"]
        h = softplus(self.dense(self.embed(pts), "feat1"), self.cfg["softplus_beta"])
        return torch.sigmoid(self.dense(h, "feat2"))


FEATURE_PREFIXES = ("feature_layer.", "feat1.", "feat2.")


def is_head(name: str) -> bool:
    """Is ``name`` a parameter of the key head (frozen in NeRF training,
    the only part of the field descriptor training updates)?"""
    return name.startswith(FEATURE_PREFIXES)
