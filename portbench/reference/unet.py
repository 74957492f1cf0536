"""Plain PyTorch ResNet-UNet query encoder as published (SurfEmb's
ResNet18-shaped UNet): a 7x7/2 stem, max-pool, four stages of two basic
blocks (64, 128, 256, 512), GroupNorm(8, eps 1e-6), a decoder that
upsamples (nearest) and joins each skip back to full size, a 3x3 head and a
1x1 output of 13 channels (12 query dims and a mask logit).

A function of the state-dict ``p`` of the configuration's ``unet`` group.
Convolutions take operands rounded to ``compute`` (the configuration's
dtype) and round their output to it, computed in float32; GroupNorm and
what follows in float32; the last 1x1 convolution in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_GN_EPS = 1e-6
_GROUPS = 8


def conv(p: dict, name: str, x, stride: int, compute):
    w = p[name + ".weight"]
    r = compute.round
    return r(F.conv2d(r(x), r(w), None, stride, w.shape[-1] // 2))


def norm(p: dict, name: str, x):
    return F.group_norm(x, _GROUPS, p[name + ".weight"], p[name + ".bias"], _GN_EPS)


def forward(p: dict, uc: dict, x, compute):
    """(B, H, W, 3) normalized images -> (B, H, W, n_class)."""
    H, W = x.shape[1:3]
    x = x.permute(0, 3, 1, 2)
    s0 = F.relu(norm(p, "stem_norm", conv(p, "stem", x, 2, compute)))
    h = F.max_pool2d(s0, 3, 2, padding=1)
    skips, b, cin = [s0], 0, 64
    for i, (n, w) in enumerate(zip(uc["stage_sizes"], uc["widths"])):
        for j in range(n):
            stride = 2 if (j == 0 and i > 0) else 1
            pre = f"blocks.{b}."
            y = F.relu(norm(p, pre + "norm1", conv(p, pre + "conv1", h, stride, compute)))
            y = norm(p, pre + "norm2", conv(p, pre + "conv2", y, 1, compute))
            res = h
            if cin != w or stride != 1:
                res = norm(p, pre + "down_norm", conv(p, pre + "down", h, stride, compute))
            h = F.relu(y + res)
            cin, b = w, b + 1
        skips.append(h)
    h = skips[-1]
    for k, skip in enumerate(reversed(skips[:-1])):
        h = F.interpolate(h, size=skip.shape[2:], mode="nearest-exact")
        h = F.relu(norm(p, f"dec_norms.{k}", conv(p, f"dec_convs.{k}", torch.cat([h, skip], 1), 1, compute)))
    h = F.interpolate(h, size=(H, W), mode="nearest-exact")
    h = F.relu(norm(p, "head_norm", conv(p, "head_conv", h, 1, compute)))
    out = F.conv2d(h, p["out.weight"], p["out.bias"])
    return out.permute(0, 2, 3, 1)


MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def normalize(img):
    return (img - torch.tensor(MEAN, device=img.device)) / torch.tensor(STD, device=img.device)
