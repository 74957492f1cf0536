"""Neural radiance field with a SurfEmb feature head (counterpart of
models/fields.py).

Same architecture and numerics as the reference's flax ``NerfField``:

* harmonic embedding of xyz, "direct" (one sin/cos per frequency) or
  "grouped" (double-angle ladder from G = H/L base frequencies);
* trunk: 2 x Linear(n_hidden) + Softplus(beta), matmuls on bf16-rounded
  operands with the product rounded to bf16 and the bias added in bf16
  (flax ``Dense(dtype=bfloat16)``), the nonlinearity in f32, storage in
  ``act_dtype``;
* density head in f32: ``1 - exp(-softplus(h @ wd + bd))``;
* color head: ``DirSplitDense`` over ``[h | dir-sin | dir-cos]`` with the
  direction part computed once per ray, then Linear(3) + sigmoid;
* feature head: SIREN(3 -> n_hidden x 2 -> feature_dim) in f32, or with
  ``siren=False`` ``sigmoid(feat2(softplus(feat1(embed(xyz)))))``: both
  products on the compute dtype, the softplus and the sigmoid in f32, and
  the softplus not stored in ``act_dtype`` (flax's rounding points).

Weights are stored in torch layout (``Linear.weight`` is (out, in));
``convert.params_from_jax`` maps the reference's flax trees onto them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32

_DTYPES = ("float32", "bfloat16")


def ladder_len(n_harmonic: int) -> int:
    """Rungs per group for method='grouped': the largest L <= 6 dividing H."""
    for L in (6, 5, 4, 3, 2):
        if n_harmonic % L == 0:
            return L
    return 1


def harmonic_embedding(x: torch.Tensor, n_harmonic: int = 60, omega0: float = 0.1,
                       method: str = "direct") -> torch.Tensor:
    """(..., D) -> (..., 2 * D * H): [sin block | cos block], each d-major
    with the frequency index minor."""
    lead = x.shape[:-1]
    if method == "direct":
        freqs = omega0 * (2.0 ** torch.arange(n_harmonic, dtype=x.dtype, device=x.device))
        ang = (x[..., None] * freqs).reshape(*lead, -1)
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if method != "grouped":
        raise ValueError(f"unknown embed_method {method!r}")
    L = ladder_len(n_harmonic)
    G = n_harmonic // L
    base = omega0 * (2.0 ** (L * torch.arange(G, dtype=x.dtype, device=x.device)))
    a = x[..., None] * base                                   # (..., D, G)
    s, c = torch.sin(a), torch.cos(a)
    sins, coss = [s], [c]
    for _ in range(L - 1):
        s, c = 2.0 * s * c, 1.0 - 2.0 * (s * s)
        sins.append(s)
        coss.append(c)
    # rungs minor: (..., D, G, L) -> (..., D*H) with f = g*L + l
    sin_blk = torch.stack(sins, dim=-1).reshape(*lead, -1)
    cos_blk = torch.stack(coss, dim=-1).reshape(*lead, -1)
    return torch.cat([sin_blk, cos_blk], dim=-1)


def softplus_beta(x: torch.Tensor, beta: float = 10.0) -> torch.Tensor:
    """log(1 + exp(beta x)) / beta in the overflow-safe form."""
    y = x * beta
    return (torch.relu(y) + torch.log1p(torch.exp(-y.abs()))) / beta


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dense_bf16(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """flax ``Dense(dtype=bfloat16)``: bf16 operands, the product rounded
    to bf16, the bias added in bf16.  Returns f32 holding bf16 values."""
    y = _bf16(_bf16(x) @ _bf16(weight).T)
    if bias is not None:
        y = _bf16(y + _bf16(bias))
    return y


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    """flax lecun_normal: truncated normal on [-2, 2] scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator | None):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Siren(nn.Module):
    """SIREN MLP: sin(30 (W x + b)) layers, then a linear output layer."""

    def __init__(self, in_features: int = 3, hidden_features: int = 256, hidden_layers: int = 2,
                 out_features: int = 12, omega: float = 30.0):
        super().__init__()
        self.omega = omega
        dims = [in_features] + [hidden_features] * (hidden_layers + 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.out = nn.Linear(hidden_features, out_features)

    def reset_parameters(self, generator: torch.Generator | None = None):
        for i, lin in enumerate(self.layers):
            fan_in = lin.in_features
            bound = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / self.omega
            _uniform_(lin.weight, bound, generator)
            _uniform_(lin.bias, bound, generator)
        bound = math.sqrt(6.0 / self.out.in_features) / self.omega
        _uniform_(self.out.weight, bound, generator)
        _uniform_(self.out.bias, bound, generator)

    def forward(self, x):
        h = x
        for lin in self.layers:
            h = torch.sin(self.omega * lin(h))
        return self.out(h)


class DirSplitDense(nn.Module):
    """Color-head input layer over ``[h | d_emb]`` as two products, the
    direction part computed once per ray and broadcast over its samples.
    The weight is that of one Linear over the concat (columns
    ``[h | dir-sin | dir-cos]``)."""

    def __init__(self, n_hidden: int, emb_dim: int, features: int, bf16: bool = True):
        super().__init__()
        self.n_hidden = n_hidden
        self.bf16 = bf16
        self.weight = nn.Parameter(torch.empty(features, n_hidden + emb_dim))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, h, d_emb):
        nh = self.n_hidden
        if self.bf16:
            hpart = _dense_bf16(h, self.weight[:, :nh], None)
            dpart = _dense_bf16(d_emb, self.weight[:, nh:], self.bias)
        else:
            hpart = h @ self.weight[:, :nh].T
            dpart = d_emb @ self.weight[:, nh:].T + self.bias
        while dpart.ndim < hpart.ndim:
            dpart = dpart[..., None, :]
        out = hpart + dpart
        return _bf16(out) if self.bf16 else out


class NerfField(nn.Module):
    """Radiance field; a pure function of points (and view dirs for color)."""

    def __init__(self, cfg: FieldConfig = FieldConfig()):
        super().__init__()
        if cfg.compute_dtype not in _DTYPES or cfg.act_dtype not in _DTYPES:
            raise ValueError(f"unsupported dtypes {cfg.compute_dtype}/{cfg.act_dtype}")
        self.cfg = cfg
        nh = cfg.n_hidden
        emb = 6 * cfg.n_harmonic_functions
        self.trunk1 = nn.Linear(emb, nh)
        self.trunk2 = nn.Linear(nh, nh)
        self.density_layer = nn.Linear(nh, 1)
        self.color1 = DirSplitDense(nh, emb, nh, bf16=cfg.compute_dtype == "bfloat16")
        self.color2 = nn.Linear(nh, 3)
        if cfg.siren:
            self.feature_layer = Siren(3, nh, 2, cfg.feature_dim)
        else:
            self.feat1 = nn.Linear(emb, nh)
            self.feat2 = nn.Linear(nh, cfg.feature_dim)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Init following the reference's flax initializers: lecun-normal
        Dense kernels, zero biases, density bias ``cfg.density_bias``,
        SIREN's uniform scheme for a SIREN feature head.  The feature head
        draws last, so the other heads' weights do not depend on ``siren``
        (flax folds its init keys by module name)."""
        for lin in (self.trunk1, self.trunk2, self.density_layer, self.color2):
            _lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)
        _lecun_normal_(self.color1.weight, self.color1.weight.shape[1], generator)
        nn.init.zeros_(self.color1.bias)
        nn.init.constant_(self.density_layer.bias, self.cfg.density_bias)
        if self.cfg.siren:
            self.feature_layer.reset_parameters(generator)
        else:
            for lin in (self.feat1, self.feat2):
                _lecun_normal_(lin.weight, lin.in_features, generator)
                nn.init.zeros_(lin.bias)
        return self

    # -- the reference's bf16 compute/storage discipline
    def _matmul(self, x, lin: nn.Linear):
        if self.cfg.compute_dtype == "bfloat16":
            return _dense_bf16(x, lin.weight, lin.bias)
        return lin(x)

    def _store(self, x):
        return _bf16(x) if self.cfg.act_dtype == "bfloat16" else x

    def _act(self, x):
        return self._store(softplus_beta(x, self.cfg.softplus_beta))

    def embed(self, pts):
        c = self.cfg
        return self._store(harmonic_embedding(pts, c.n_harmonic_functions, c.omega0, c.embed_method))

    def trunk(self, embeds):
        return self._act(self._matmul(self._act(self._matmul(embeds, self.trunk1)), self.trunk2))

    def density_from_trunk(self, h):
        raw = softplus_beta(self.density_layer(h), self.cfg.softplus_beta)
        return 1.0 - torch.exp(-raw)

    def density(self, pts):
        """Opacity in [0, 1) per point, (..., 3) -> (..., 1)."""
        return self.density_from_trunk(self.trunk(self.embed(pts)))

    def color(self, pts, view_dirs):
        """RGB per point; ``view_dirs`` (..., 3) per ray."""
        h = self.trunk(self.embed(pts))
        d = view_dirs / torch.linalg.vector_norm(view_dirs, dim=-1, keepdim=True).clamp_min(1e-12)
        x = self._act(self.color1(h, self.embed(d)))
        return torch.sigmoid(self._matmul(x, self.color2))

    def features(self, pts):
        """feature_dim-d descriptor keys per point: SIREN on xyz, or the
        softplus MLP on the embedding (its softplus kept in f32)."""
        if self.cfg.siren:
            return self.feature_layer(pts)
        h = softplus_beta(self._matmul(self.embed(pts), self.feat1), self.cfg.softplus_beta)
        return torch.sigmoid(self._matmul(h, self.feat2))

    def forward(self, pts, view_dirs=None, mode: str = "color"):
        """Densities (..., 1) and per-point channels: 'color' -> rgb,
        'feature' -> keys, 'both' -> their concat."""
        dens = self.density_from_trunk(self.trunk(self.embed(pts)))
        if mode == "feature":
            feats = self.features(pts)
        elif mode == "color":
            feats = self.color(pts, view_dirs)
        else:
            feats = torch.cat([self.color(pts, view_dirs), self.features(pts)], dim=-1)
        return dens, feats

    def density_and_features(self, pts):
        """Density and feature head without view dirs."""
        return self.density(pts), self.features(pts)

    def custom_forward(self, pts):
        """The feature head's keys with a zero opacity channel appended."""
        f = self.features(pts)
        return torch.cat([f, torch.zeros_like(f[..., :1])], dim=-1)


@torch.no_grad()
def eval_features(field: NerfField, pts: torch.Tensor) -> torch.Tensor:
    """Feature-head keys for points (f32 products in f32, not TF32)."""
    with no_tf32():
        return field.features(pts)


# Explicit module partition for freeze_spec: every top-level NerfField
# module is in exactly one set, so a renamed or added layer raises instead
# of silently training or freezing the wrong head.
FEATURE_HEAD_MODULES = frozenset({"feature_layer", "feat1", "feat2"})
NON_FEATURE_MODULES = frozenset({"trunk1", "trunk2", "density_layer", "color1", "color2"})


def freeze_spec(train_feature_head: bool):
    """``label_fn(field) -> {parameter name: "train" | "freeze"}``.

    NeRF training freezes the feature head; descriptor training trains only
    the feature head.  Membership is decided by the module sets above; an
    unknown top-level module raises."""

    def label_fn(field: nn.Module) -> dict:
        labels = {}
        for name, _ in field.named_parameters():
            top = name.split(".")[0]
            if top in FEATURE_HEAD_MODULES:
                is_feat = True
            elif top in NON_FEATURE_MODULES:
                is_feat = False
            else:
                raise ValueError(f"freeze_spec: unknown NerfField module {top!r}: update FEATURE_HEAD_MODULES / "
                                 "NON_FEATURE_MODULES in models/fields.py when renaming or adding field layers")
            labels[name] = "train" if is_feat == train_feature_head else "freeze"
        return labels

    return label_fn
