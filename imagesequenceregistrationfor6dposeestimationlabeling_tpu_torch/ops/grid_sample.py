"""Image sampling at normalized locations (counterpart of ops/grid_sample.py).

``torch.nn.functional.grid_sample`` semantics with ``align_corners=True``
(g = -1 -> pixel 0, g = +1 -> pixel S - 1), on channels-last images as the
reference keeps them.  Nearest mode rounds half to even, as ``jnp.round``
and ``torch.round`` both do.

The taps are gathered by ``gather_rows``, whose backward sums the grads of
a pixel read by several samples in a fixed order (``index_put_`` with
``accumulate=True``: a sort and a segmented sum on the card), so a step
that backpropagates through a sample is bit-reproducible; the backward of
``torch.gather`` adds them with atomics in whatever order the threads
arrive.
"""

from __future__ import annotations

import torch


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.shape = flat.shape
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[2]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        B, M, C = ctx.shape
        rows = (idx + M * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
        out = grad.new_zeros((B * M, C)).index_put_((rows,), grad.reshape(-1, C), accumulate=True)
        return out.reshape(B, M, C), None


def gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, M, C) rows at (B, N) indices -> (B, N, C); its backward sums the
    grads of repeated rows in a fixed order."""
    return _GatherRows.apply(flat, idx)


def _to_pixel(g: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def grid_sample(images: torch.Tensor, grid: torch.Tensor, mode: str = "nearest",
                align_corners: bool = True) -> torch.Tensor:
    """images (B, H, W, C); grid (B, N, 2) with (x, y) in [-1, 1] -> (B, N, C);
    taps outside the image read zero."""
    B, H, W, C = images.shape
    gx = _to_pixel(grid[..., 0], W, align_corners)
    gy = _to_pixel(grid[..., 1], H, align_corners)
    flat = images.reshape(B, H * W, C)

    def tap(ix, iy):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        return gather_rows(flat, idx) * valid[..., None]

    if mode == "nearest":
        return tap(torch.round(gx).long(), torch.round(gy).long())
    if mode != "bilinear":
        raise ValueError(f"unknown grid_sample mode {mode!r}")
    x0, y0 = torch.floor(gx), torch.floor(gy)
    tx, ty = (gx - x0)[..., None], (gy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    top = tap(x0i, y0i) * (1 - tx) + tap(x0i + 1, y0i) * tx
    bot = tap(x0i, y0i + 1) * (1 - tx) + tap(x0i + 1, y0i + 1) * tx
    return top * (1 - ty) + bot * ty


def sample_images_at_mc_locs(target_images: torch.Tensor, sampled_rays_xy: torch.Tensor,
                             mode: str = "nearest") -> torch.Tensor:
    """Sample (B, H, W, C) images at NDC ray xys (B, N, 2), with the sign
    inversion from NDC (+x left, +y up) to grid (+x right, +y down)."""
    return grid_sample(target_images, -sampled_rays_xy, mode=mode, align_corners=True)
