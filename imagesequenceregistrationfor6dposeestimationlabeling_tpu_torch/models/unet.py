"""ResNet-UNet query encoder (counterpart of models/unet.py).

ResNet18-shaped encoder (7x7/2 stem, max-pool, 4 stages of 2 basic
blocks) with GroupNorm(8 groups, eps 1e-6 as flax), and a decoder that
upsamples (nearest, half-pixel centers) and concatenates skips back to full
resolution; 13 outputs = 12 query features + 1 mask logit.

Numerics follow the reference: convolutions on ``dtype`` (bf16) operands
with the output rounded to ``dtype``, GroupNorm and everything after it in f32, the final
1x1 convolution in f32.  The public layout is the reference's NHWC; the
module works in NCHW inside.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32

_GN_EPS = 1e-6
_GROUPS = 8


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Bias-free convolution on ``dtype`` operands, returned in f32."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)
    return y.to(torch.float32)


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(_GROUPS, c, eps=_GN_EPS)


def _conv2d(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=bias)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv2d(cin, cout, 3, stride)
        self.norm1 = _norm(cout)
        self.conv2 = _conv2d(cout, cout, 3)
        self.norm2 = _norm(cout)
        self.down = None
        if cin != cout or stride != 1:
            self.down = _conv2d(cin, cout, 1, stride)
            self.down_norm = _norm(cout)

    def forward(self, x):
        y = F.relu(self.norm1(_conv(self.conv1, x, self.dtype)))
        y = self.norm2(_conv(self.conv2, y, self.dtype))
        res = x if self.down is None else self.down_norm(_conv(self.down, x, self.dtype))
        return F.relu(y + res)


class ResNetUNet(nn.Module):
    """13-channel query CNN: 12 feature dims + 1 mask logit."""

    def __init__(self, n_class: int = 13, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512), decoder_width: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem = _conv2d(3, 64, 7, 2)
        self.stem_norm = _norm(64)
        blocks = []
        cin = 64
        for i, (n_blocks, w) in enumerate(zip(stage_sizes, widths)):
            for b in range(n_blocks):
                blocks.append(BasicBlock(cin, w, 2 if (b == 0 and i > 0) else 1, dtype))
                cin = w
        self.blocks = nn.ModuleList(blocks)
        self.stage_sizes = tuple(stage_sizes)
        # decoder: deepest stage upsampled onto each shallower skip in turn
        skip_ch = [64] + list(widths[:-1])
        dec_in = [widths[-1]] + [2 * decoder_width] * (len(skip_ch) - 1)
        self.dec_convs = nn.ModuleList(
            _conv2d(a + s, 2 * decoder_width, 3) for a, s in zip(dec_in, reversed(skip_ch))
        )
        self.dec_norms = nn.ModuleList(_norm(2 * decoder_width) for _ in skip_ch)
        self.head_conv = _conv2d(2 * decoder_width, decoder_width, 3)
        self.head_norm = _norm(decoder_width)
        self.out = nn.Conv2d(decoder_width, n_class, 1)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax defaults: lecun-normal conv kernels, zero biases, unit
        GroupNorm scales."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                    m.weight.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) ImageNet-normalized -> (B, H, W, n_class) f32."""
        H, W = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)
        s0 = F.relu(self.stem_norm(_conv(self.stem, x, self.dtype)))
        h = F.max_pool2d(s0, 3, 2, padding=1)
        skips = [s0]
        i = 0
        for n_blocks in self.stage_sizes:
            for _ in range(n_blocks):
                h = self.blocks[i](h)
                i += 1
            skips.append(h)
        h = skips[-1]
        for conv, norm, skip in zip(self.dec_convs, self.dec_norms, reversed(skips[:-1])):
            h = F.interpolate(h, size=skip.shape[2:], mode="nearest-exact")
            h = F.relu(norm(_conv(conv, torch.cat([h, skip], dim=1), self.dtype)))
        h = F.interpolate(h, size=(H, W), mode="nearest-exact")
        h = F.relu(self.head_norm(_conv(self.head_conv, h, self.dtype)))
        # the f32 output layer must not drop to TF32 inside cuDNN
        with no_tf32():
            out = self.out(h)
        return out.permute(0, 2, 3, 1)


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


# copied to a device once, read-only and shared: a copy from the host waits
# for the device's queue, and cannot be captured into a CUDA graph
@functools.lru_cache(maxsize=None)
def _mean_std_on(device: torch.device, dtype: torch.dtype) -> tuple:
    return torch.tensor(_MEAN, dtype=dtype, device=device), torch.tensor(_STD, dtype=dtype, device=device)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of (..., 3) images."""
    mean, std = _mean_std_on(img.device, img.dtype)
    return (img - mean) / std


def denormalize_image(img: torch.Tensor) -> torch.Tensor:
    """The inverse of ``normalize_image``."""
    mean, std = _mean_std_on(img.device, img.dtype)
    return img * std + mean
