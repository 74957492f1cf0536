"""Image augmentation for descriptor training (counterpart of
train/augment.py), on a batch of views at once.

Per view: a random rotation / scale / translation (the SurfEmb scale rule
``crop_res / max(w, h) / pad * U(1 +- scale_jitter)``), cutouts and a
half-plane erosion of the mask before the warp, a smooth-noise (or bank)
background, colour jitter, Gaussian blur, ISO noise, an optional
distractor paste, border blackout and ImageNet normalization.  The warp is
returned as (A, t) acting on NDC ray coordinates, ``xys' = xys @ A.T + t``,
the same map the image went through, so the per-view ray dumps stay
aligned (``transform_xys``).

Randomness comes in as an ``AugmentDraws``: each field is what one
``jax.random`` call of the reference draws for a view, with a leading batch
axis (so tests can replay the reference's keys); ``draw_augment`` draws the
same structure from a ``torch.Generator``.

The image-folder banks (backgrounds, distractor crops) load with Pillow,
imported where a bank is read.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import normalize_image
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import graphs


class AugmentConfig(NamedTuple):
    crop_res: int = 224
    pad: float = 1.2                  # SurfEmb crop pad
    scale_jitter: float = 0.075       # 0.05 * surfEmbScaleFac(1.5)
    trans_frac: float = 0.1           # transScale(0.2) * imX/2 -> frac of S
    p_background: float = 0.9         # augment.py:300
    p_occlude: float = 0.49           # maskErosion 0.7 * inner 0.7
    p_line_erode: float = 0.49
    p_color_jitter: float = 0.7
    p_border: float = 0.4
    p_distractor: float = 0.0         # tless_aug distractor paste (augment.py:402-418)
    p_blur: float = 0.5               # AB.GaussianBlur(blur_limit=(1,3)) (augment.py:248,347)
    p_iso_noise: float = 0.5          # AB.ISONoise() (augment.py:249,348)
    min_mask_sum: float = 200.0       # maskMax analog at our test scales


class Augmented(NamedTuple):
    rgb: torch.Tensor        # (B, S, S, 3) ImageNet-normalized
    mask_full: torch.Tensor  # (B, S, S) warped original mask (the BCE target)
    mask_crop: torch.Tensor  # (B, S, S) warped occluded mask
    A: torch.Tensor          # (B, 2, 2) NDC linear part
    t: torch.Tensor          # (B, 2) NDC translation


class AugmentDraws(NamedTuple):
    """One batch's draws, leading axis B; in brackets the reference's key
    (``split(key, 18)[k]``) and its draw.  Uniforms are in [0, 1) unless a
    range is given."""

    rot: torch.Tensor            # (B,)            [0] theta = rot * 2 pi
    scale: torch.Tensor          # (B,)            [1] in [1 - scale_jitter, 1 + scale_jitter)
    trans: torch.Tensor          # (B, 2)          [2] in [-trans_frac, trans_frac)
    occlude: torch.Tensor        # (B, 4)          [3] split 4: corner x, y, width, height
    occlude_on: torch.Tensor     # (B,)            [4]
    line: torch.Tensor           # (B, 3)          [5] split 3: point x, y, angle
    line_on: torch.Tensor        # (B,)            [6]
    background: torch.Tensor     # (B, 8, 8, 3), or (B,) bank index   [7]
    background_on: torch.Tensor  # (B,)            [8]
    gain: torch.Tensor           # (B, 3)          [9] split 3, [0]: in [0.8, 1.2)
    bias: torch.Tensor           # (B, 3)              [1]: in [-0.08, 0.08)
    gamma: torch.Tensor          # (B,)                [2]: in [0.8, 1.25)
    jitter_on: torch.Tensor      # (B,)            [10]
    border_on: torch.Tensor      # (B,)            [11]
    shift: torch.Tensor          # (B, 2) int      [12] split 2, [0]: in [-S // 2, S // 2)
    distractor_on: torch.Tensor  # (B,)            [13]
    sigma: torch.Tensor          # (B,)            [14] in [0.3, 1.0)
    blur_on: torch.Tensor        # (B,)            [15]
    iso_intensity: torch.Tensor  # (B,)            [16] split 4, [0]: in [0.1, 0.5)
    iso_shift: torch.Tensor      # (B,)                [1]: in [0.01, 0.05)
    iso_luma: torch.Tensor       # (B, S, S, 1)        [2]: standard normal
    iso_chroma: torch.Tensor     # (B, S, S, 3)        [3]: standard normal
    iso_on: torch.Tensor         # (B,)            [17]


def draw_augment(generator: torch.Generator | None, B: int, S: int, cfg: AugmentConfig, n_bank: int = 0,
                 device=None) -> AugmentDraws:
    """``AugmentDraws`` for B views of S x S from ``generator`` on ``device``
    (the generator's); ``n_bank`` > 0 draws background bank indices instead
    of the smooth noise."""
    dev = torch.device(device) if device is not None else (generator.device if generator is not None else None)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand((B,) + shape, generator=generator, device=dev) * (hi - lo) + lo

    def normal(*shape):
        return torch.randn((B,) + shape, generator=generator, device=dev)

    j, tf = cfg.scale_jitter, cfg.trans_frac
    return AugmentDraws(
        rot=u(), scale=u(lo=1.0 - j, hi=1.0 + j), trans=u(2, lo=-tf, hi=tf), occlude=u(4), occlude_on=u(),
        line=u(3), line_on=u(),
        background=(torch.randint(0, n_bank, (B,), generator=generator, device=dev) if n_bank > 0
                    else u(8, 8, 3)),
        background_on=u(), gain=u(3, lo=0.8, hi=1.2), bias=u(3, lo=-0.08, hi=0.08), gamma=u(lo=0.8, hi=1.25),
        jitter_on=u(), border_on=u(),
        shift=torch.randint(-S // 2, S // 2, (B, 2), generator=generator, device=dev), distractor_on=u(),
        sigma=u(lo=0.3, hi=1.0), blur_on=u(), iso_intensity=u(lo=0.1, hi=0.5), iso_shift=u(lo=0.01, hi=0.05),
        iso_luma=normal(S, S, 1), iso_chroma=normal(S, S, 3), iso_on=u(),
    )


def _per_view(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with ``ndim`` dims in all."""
    return x.reshape(x.shape[:1] + (1,) * (ndim - 1))


def transform_xys(xys: torch.Tensor, A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """NDC ray coordinates (B, N, 2) through each view's augmentation,
    ``xys @ A.T + t``."""
    x, y = xys[..., 0], xys[..., 1]
    a = A[:, None]
    return torch.stack([x * a[..., 0, 0] + y * a[..., 0, 1], x * a[..., 1, 0] + y * a[..., 1, 1]], -1) + t[:, None]


def _mask_bbox(mask: torch.Tensor):
    """(x, y, w, h) int64 (B,) each of each mask's bounding box
    (cv2.boundingRect); (S, S, 1, 1) for an empty mask."""
    S = mask.shape[-1]
    cols = mask.amax(1) > 0.5
    rows = mask.amax(2) > 0.5
    idx = torch.arange(S, device=mask.device)
    x0 = torch.where(cols, idx, S).amin(1)
    x1 = torch.where(cols, idx, -1).amax(1)
    y0 = torch.where(rows, idx, S).amin(1)
    y1 = torch.where(rows, idx, -1).amax(1)
    return x0, y0, (x1 - x0 + 1).clamp_min(1), (y1 - y0 + 1).clamp_min(1)


def _source_pixels(A: torch.Tensor, t: torch.Tensor, S: int):
    """Continuous source pixel coordinates (B, S, S) each of every output
    pixel's center under the inverse warp."""
    ii = torch.arange(S, dtype=torch.float32, device=A.device) + 0.5
    py, px = torch.meshgrid(ii, ii, indexing="ij")
    ux = (1.0 - 2.0 * px / S) - _per_view(t[:, 0], 3)
    uy = (1.0 - 2.0 * py / S) - _per_view(t[:, 1], 3)
    a, b, c, d = (_per_view(A[:, i, j], 3) for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    det = a * d - b * c
    u_in_x = (ux * d - uy * b) / det
    u_in_y = (uy * a - ux * c) / det
    return (1.0 - u_in_x) * S / 2.0, (1.0 - u_in_y) * S / 2.0


def _bilinear_sample(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """img (B, S, S, C) at continuous pixel coordinates (B, ...) (pixel i's
    center at i + 0.5); taps outside the image read zero."""
    B, S, _, C = img.shape
    flat = img.reshape(B, S * S, C)
    x, y = px - 0.5, py - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(ix, iy):
        valid = (ix >= 0) & (ix < S) & (iy >= 0) & (iy < S)
        idx = (iy.clamp(0, S - 1) * S + ix.clamp(0, S - 1)).reshape(B, -1)
        got = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C)).reshape(ix.shape + (C,))
        return got * valid[..., None]

    top = tap(x0i, y0i) * (1 - tx) + tap(x0i + 1, y0i) * tx
    bot = tap(x0i, y0i + 1) * (1 - tx) + tap(x0i + 1, y0i + 1) * tx
    return top * (1 - ty) + bot * ty


def warp_affine_ndc(img: torch.Tensor, A: torch.Tensor, t: torch.Tensor, nearest: bool = False) -> torch.Tensor:
    """Warp each image (B, S, S) or (B, S, S, C) so that the content at NDC
    u appears at A u + t; bilinear, or nearest for masks."""
    S = img.shape[1]
    px, py = _source_pixels(A, t, S)
    if nearest:
        xi = torch.floor(px).long().clamp(0, S - 1)
        yi = torch.floor(py).long().clamp(0, S - 1)
        valid = (px >= 0) & (px < S) & (py >= 0) & (py < S)
        out = img[torch.arange(img.shape[0], device=img.device)[:, None, None], yi, xi]
        return out * (valid[..., None] if img.ndim == 4 else valid)
    if img.ndim == 3:
        return _bilinear_sample(img[..., None], px, py)[..., 0]
    return _bilinear_sample(img, px, py)


def warp_all_ndc(rgb: torch.Tensor, mask_full: torch.Tensor, mask_crop: torch.Tensor, A: torch.Tensor,
                 t: torch.Tensor):
    """The three warps of ``augment_view`` (bilinear rgb, nearest masks) from
    one gather: the source is packed so one read at the bilinear base pixel
    fetches all four taps of all five planes; each tap is zeroed where its
    unclipped coordinate leaves the image, as ``warp_affine_ndc`` does.
    Returns (rgb (B, S, S, 3), mask_full (B, S, S), mask_crop (B, S, S))."""
    B, S = rgb.shape[:2]
    src = torch.cat([rgb, mask_full[..., None], mask_crop[..., None]], -1)
    C = src.shape[-1]
    Z = F.pad(src, (0, 0, 1, 2, 1, 2))     # Z[y + 1, x + 1] = src[y, x], zero beyond
    packed = torch.cat([Z[:, :-1, :-1], Z[:, :-1, 1:], Z[:, 1:, :-1], Z[:, 1:, 1:]], -1)   # (B, S+2, S+2, 4C)
    px, py = _source_pixels(A, t, S)
    x, y = px - 0.5, py - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    idx = (y0i + 1).clamp(0, S + 1) * (S + 2) + (x0i + 1).clamp(0, S + 1)
    g = torch.gather(packed.reshape(B, -1, 4 * C), 1, idx.reshape(B, -1, 1).expand(B, S * S, 4 * C))
    g = g.reshape(B, S, S, 4 * C)

    def vmask(ix, iy):
        return ((ix >= 0) & (ix < S) & (iy >= 0) & (iy < S)).to(src.dtype)[..., None]

    v00 = g[..., 0 * C : 1 * C] * vmask(x0i, y0i)
    v01 = g[..., 1 * C : 2 * C] * vmask(x0i + 1, y0i)
    v10 = g[..., 2 * C : 3 * C] * vmask(x0i, y0i + 1)
    v11 = g[..., 3 * C : 4 * C] * vmask(x0i + 1, y0i + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    rgb_w = (top * (1 - ty) + bot * ty)[..., :3]
    # the nearest tap is base + (frac >= 0.5) on each axis
    right, down = tx >= 0.5, ty >= 0.5
    near = torch.where(down, torch.where(right, v11, v10), torch.where(right, v01, v00))
    return rgb_w, near[..., 3], near[..., 4]


def _smooth_noise(low: torch.Tensor, S: int) -> torch.Tensor:
    """(B, r, r, 3) uniforms bilinearly upsampled to (B, S, S, 3)."""
    up = F.interpolate(low.permute(0, 3, 1, 2), size=(S, S), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)


def _occlude(u: torch.Tensor, mask: torch.Tensor, x0, y0, w, h) -> torch.Tensor:
    """A rectangle cut out of each mask inside its bbox; u (B, 4)."""
    S = mask.shape[-1]
    nx = x0 + (u[:, 0] * w).long()
    ny = y0 + (u[:, 1] * h).long()
    max_w = torch.minimum(w, 30 + (u[:, 2] * 40).long())
    max_h = torch.minimum(h, 30 + (u[:, 3] * 40).long())
    nw = (u[:, 2] * max_w).long()
    nh = (u[:, 3] * max_h).long()
    ii = torch.arange(S, device=mask.device)
    in_x = (ii >= nx[:, None]) & (ii < (nx + nw)[:, None])
    in_y = (ii >= ny[:, None]) & (ii < (ny + nh)[:, None])
    return torch.where(in_y[:, :, None] & in_x[:, None, :], 0.0, mask)


def _line_erode(u: torch.Tensor, mask: torch.Tensor, x0, y0, w, h) -> torch.Tensor:
    """Each mask cut by a half-plane through a random point of its bbox; u (B, 3)."""
    S = mask.shape[-1]
    cx = _per_view(x0.to(torch.float32) + u[:, 0] * w, 3)
    cy = _per_view(y0.to(torch.float32) + u[:, 1] * h, 3)
    phi = u[:, 2] * 2 * math.pi
    n0, n1 = _per_view(torch.cos(phi), 3), _per_view(torch.sin(phi), 3)
    ii = torch.arange(S, dtype=torch.float32, device=mask.device)
    py, px = torch.meshgrid(ii, ii, indexing="ij")
    side = (px - cx) * n0 + (py - cy) * n1
    return torch.where(side > 0, 0.0, mask)


def _shift_clamp(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """x shifted by d along ``dim``, the edge repeated (no wrap-around)."""
    n = x.shape[dim]
    return x.index_select(dim, (torch.arange(n, device=x.device) + d).clamp(0, n - 1))


def gaussian_blur3(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 3x3 Gaussian blur of each image (B, S, S, C) with its own
    sigma (B,); sigma -> 0 is the identity."""
    w1 = _per_view(torch.exp(-0.5 / torch.clamp_min(sigma, 1e-3) ** 2), img.ndim)
    norm = 1.0 + 2.0 * w1

    def conv1d(x, dim):
        return (x + w1 * (_shift_clamp(x, -1, dim) + _shift_clamp(x, 1, dim))) / norm

    return conv1d(conv1d(img, 1), 2)


def iso_noise(img: torch.Tensor, intensity: torch.Tensor, color_shift: torch.Tensor, luma: torch.Tensor,
              chroma: torch.Tensor) -> torch.Tensor:
    """Sensor noise: luma noise scaled by the square root of the signal
    plus a small chroma shift, from standard normals ``luma`` (B, S, S, 1)
    and ``chroma`` (B, S, S, 3)."""
    shot = torch.sqrt(torch.clamp(img, 0.0, 1.0) + 1e-3)
    lum = luma * _per_view(intensity, 4) * 0.1 * shot.mean(-1, keepdim=True)
    return torch.clamp(img + lum + chroma * _per_view(color_shift, 4), 0.0, 1.0)


def paste_distractor(shift: torch.Tensor, rgb: torch.Tensor, mask: torch.Tensor, dis_rgb: torch.Tensor,
                     dis_mask: torch.Tensor):
    """Another object's pixels, rolled by ``shift`` (B, 2), composited over
    each image, the covered part of the mask zeroed; skipped for a view
    where it would hide 60 % of the mask or more."""
    B, S = rgb.shape[:2]
    ar = torch.arange(S, device=rgb.device)
    rows = (ar[None] - shift[:, 0:1]) % S
    cols = (ar[None] - shift[:, 1:2]) % S
    b = torch.arange(B, device=rgb.device)[:, None, None]
    dr = dis_rgb[b, rows[:, :, None], cols[:, None, :]]
    dm = dis_mask[b, rows[:, :, None], cols[:, None, :]]
    total = mask.sum((1, 2))
    remaining = (mask * (1 - dm)).sum((1, 2))
    ok = (total - remaining) < total * 0.6
    new_rgb = torch.where((dm > 0.5)[..., None], dr, rgb)
    new_mask = mask * (1.0 - (dm > 0.5).to(mask.dtype))
    return torch.where(_per_view(ok, 4), new_rgb, rgb), torch.where(_per_view(ok, 3), new_mask, mask)


def augment_view(rgb: torch.Tensor, mask: torch.Tensor, cfg: AugmentConfig, draws: AugmentDraws,
                 distractor: Optional[tuple] = None, bg_bank: Optional[torch.Tensor] = None) -> Augmented:
    """Augment a batch of views: rgb (B, S, S, 3) in [0, 1], mask (B, S, S).

    ``distractor``: optional (rgb (B, S, S, 3), mask (B, S, S)) of other
    objects or views, pasted with probability ``cfg.p_distractor``.
    ``bg_bank``: optional (N, S, S, 3) backgrounds, indexed by
    ``draws.background``, in place of the smooth noise."""
    S = rgb.shape[1]
    d = draws
    x0, y0, w, h = _mask_bbox(mask)

    # geometry: rotation, the SurfEmb scale rule relative to S, translation
    theta = d.rot * 2 * math.pi
    base_scale = cfg.crop_res / torch.maximum(w, h).to(torch.float32) / cfg.pad
    scale = base_scale * (S / cfg.crop_res) * d.scale
    c, s = torch.cos(theta), torch.sin(theta)
    A = scale[:, None, None] * torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)

    # mask occlusions before the warp
    m1 = _occlude(d.occlude, mask, x0, y0, w, h)
    take = (d.occlude_on < cfg.p_occlude) & (m1.sum((1, 2)) > cfg.min_mask_sum)
    occluded = torch.where(_per_view(take, 3), m1, mask)
    m2 = _line_erode(d.line, occluded, x0, y0, w, h)
    take = (d.line_on < cfg.p_line_erode) & (m2.sum((1, 2)) > cfg.min_mask_sum)
    occluded = torch.where(_per_view(take, 3), m2, occluded)

    rgb_w, mask_full_w, mask_crop_w = warp_all_ndc(rgb, mask, occluded, A, d.trans)

    bg = bg_bank[d.background.long()] if bg_bank is not None else _smooth_noise(d.background, S)
    bg = torch.where(_per_view(d.background_on < cfg.p_background, 4), bg, torch.zeros_like(bg))
    out = torch.where(mask_crop_w[..., None] > 0.5, rgb_w, bg)

    gain, bias = d.gain[:, None, None, :], d.bias[:, None, None, :]
    jittered = torch.clamp(torch.clamp(out, 0, 1) ** _per_view(d.gamma, 4) * gain + bias, 0.0, 1.0)
    out = torch.where(_per_view(d.jitter_on < cfg.p_color_jitter, 4), jittered, out)

    out = torch.where(_per_view(d.blur_on < cfg.p_blur, 4), gaussian_blur3(out, d.sigma), out)
    noisy = iso_noise(out, d.iso_intensity, d.iso_shift, d.iso_luma, d.iso_chroma)
    out = torch.where(_per_view(d.iso_on < cfg.p_iso_noise, 4), noisy, out)

    mask_out = mask_crop_w
    if distractor is not None and cfg.p_distractor > 0:
        pasted_rgb, pasted_mask = paste_distractor(d.shift, out, mask_crop_w, *distractor)
        use = d.distractor_on < cfg.p_distractor
        out = torch.where(_per_view(use, 4), pasted_rgb, out)
        mask_out = torch.where(_per_view(use, 3), pasted_mask, mask_crop_w)

    # border blackout: zero everything farther than 4 pixels from the mask
    dil = F.max_pool2d(mask_out[:, None], 9, 1, 4)[:, 0]
    blacked = out * (dil > 0.5)[..., None]
    out = torch.where(_per_view(d.border_on < cfg.p_border, 4), blacked, out)
    return Augmented(normalize_image(out), mask_full_w, mask_out, A, d.trans)


def nocs_map(xys: torch.Tensor, pos_vec: torch.Tensor, valid: torch.Tensor, res: int = 224) -> torch.Tensor:
    """(res, res, 3) NOCS image: each valid ray's 3D hit ``pos_vec`` (N, 3)
    written into the pixel its NDC ``xys`` (N, 2) lands on, zeros
    elsewhere.  Where rays share a pixel the last one writes, as the
    reference's scatter does on the CPU (a fixed choice on the card too)."""
    px = ((1.0 - xys[:, 0]) * 0.5 * (res - 1)).to(torch.int64)
    py = ((1.0 - xys[:, 1]) * 0.5 * (res - 1)).to(torch.int64)
    in_b = (px >= 0) & (px < res) & (py >= 0) & (py < res) & valid
    flat = torch.where(in_b, py * res + px, res * res)
    order = torch.arange(flat.shape[0], device=flat.device)
    last = torch.full((res * res + 1,), -1, dtype=torch.int64, device=flat.device)
    last = last.scatter_reduce(0, flat, order, "amax")[:-1]
    img = torch.where((last >= 0)[:, None], pos_vec[last.clamp_min(0)], torch.zeros((), dtype=pos_vec.dtype,
                                                                                     device=pos_vec.device))
    return img.reshape(res, res, 3)


def select_ray_samples(xys: torch.Tensor, valid: torch.Tensor, sample_size: int,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, sample_size) ray indices drawn with replacement, uniformly over
    each view's valid rays with |x|, |y| < 1; ray 0 every time where there
    are none (the reference's categorical over logits of -1e9 alike always
    picks the first).  Inside a CUDA graph's capture the draw runs eagerly
    between two graphs (``graphs.cut``), from the generator's state at
    that call."""
    w = ((xys[..., 0].abs() < 1.0) & (xys[..., 1].abs() < 1.0) & valid).to(torch.float32)
    first = torch.zeros_like(w)
    first[:, 0] = 1.0
    w = torch.where(w.sum(-1, keepdim=True) > 0, w, first)
    return graphs.cut(_draw_with_replacement, w, sample_size, generator)


def _draw_with_replacement(w: torch.Tensor, n: int, generator: torch.Generator | None) -> torch.Tensor:
    return torch.multinomial(w, n, replacement=True, generator=generator)


def _list_image_files(dir_path: str, max_images: int, kind: str) -> list:
    """The first ``max_images`` image files of a folder, by name."""
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    files = sorted(os.path.join(dir_path, f) for f in os.listdir(dir_path) if f.lower().endswith(exts))[:max_images]
    if not files:
        raise ValueError(f"no images found in {kind} dir {dir_path}")
    return files


def _load_image_dir(dir_path: str, size: int, max_images: int, resample, kind: str) -> np.ndarray:
    """An image folder as (N, size, size, 3) float32 in [0, 1]."""
    from PIL import Image

    return np.stack([np.asarray(Image.open(f).convert("RGB").resize((size, size), resample), np.float32) / 255.0
                     for f in _list_image_files(dir_path, max_images, kind)])


def load_background_bank(dir_path: str, size: int, max_images: int = 256) -> np.ndarray:
    """An image folder as an (N, size, size, 3) float32 background bank
    (bicubic resize); any folder of images works."""
    from PIL import Image

    return _load_image_dir(dir_path, size, max_images, Image.BICUBIC, "background")


def load_distractor_bank(dir_path: str, size: int, max_images: int = 128):
    """An image folder of masked crops of other objects as a distractor
    bank: ((N, size, size, 3) rgb, (N, size, size) masks).  A crop's mask
    is its non-black region, taken at the file's own resolution; the rgb
    then resizes bicubic and the mask nearest, so its edges stay crisp."""
    from PIL import Image

    rgbs, masks = [], []
    for f in _list_image_files(dir_path, max_images, "distractor"):
        im = Image.open(f).convert("RGB")
        native = np.asarray(im, np.float32) / 255.0
        m_native = (native.max(-1) > 1.0 / 255.0).astype(np.uint8) * 255
        rgbs.append(np.asarray(im.resize((size, size), Image.BICUBIC), np.float32) / 255.0)
        masks.append(np.asarray(Image.fromarray(m_native).resize((size, size), Image.NEAREST), np.float32) / 255.0)
    return np.clip(np.stack(rgbs), 0.0, 1.0), np.stack(masks)
