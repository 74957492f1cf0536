"""Visualization helpers (counterpart of utils/viz.py): feature-embedding
images, render previews of a field, an image tiler and the camera ring of
the rotating video.

``save_image`` writes 8-bit RGB PNGs with the standard library (zlib and
struct), so the training previews need no imaging package.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import euler_zyx_to_matrix


def emb_vis(emb_img, mask=None, demean: bool = False) -> np.ndarray:
    """12-d feature image -> RGB in [0, 1]: the channels folded 3 x 4 and
    averaged, normalized by the largest |value|."""
    emb = np.asarray(emb_img, np.float32)
    if demean:
        sel = emb[mask > 0.5] if mask is not None else emb.reshape(-1, emb.shape[-1])
        emb = emb - sel.reshape(-1, emb.shape[-1]).mean(0)
    h, w, _ = emb.shape
    rgb = emb.reshape(h, w, 3, -1).mean(-1)
    if mask is not None:
        rgb = rgb * (np.asarray(mask)[..., None] > 0.5)
    rgb = rgb / (np.abs(rgb).max() + 1e-9)
    return rgb * 0.5 + 0.5


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _png_bytes(img) -> bytes:
    """Float [0, 1] (H, W[, C]) as the bytes of an 8-bit RGB PNG: values
    clipped, times 255, truncated (a 2-D image is grey, repeated to RGB)."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    rgb = np.ascontiguousarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)[..., :3])
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)   # filter 0 a row
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def save_image(path: str, img):
    """Save float [0, 1] (H, W[, C]) as a PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_png_bytes(img))


@torch.no_grad()
def render_preview(field, cam, image_size: int, n_pts: int, min_depth, max_depth, mode: str = "color"):
    """A full-frame render of ``field`` (a NerfField or a field-like module
    called as ``field(pts, dirs, mode)``) from one camera, for training
    previews: (rgb (S, S, C), silhouette (S, S)) as numpy."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer

    S = image_size
    images, _, _ = renderer.render_grid_chunked(field, cam, S, n_pts, min_depth, max_depth, mode=mode,
                                                threshold_mode=False, chunk=min(4096, S * S))
    images = images.cpu().numpy()
    return images[:, :-1].reshape(S, S, -1), images[:, -1].reshape(S, S)


def image_grid(images, rows: int | None = None, cols: int | None = None, fill: bool = True, rgb: bool = True,
               pad: int = 0) -> np.ndarray:
    """Tile N images into one (rows*H, cols*W, 3) array.

    ``rows`` / ``cols`` come together or not at all (default: one column).
    ``rgb=True`` tiles the RGB channels, ``rgb=False`` the alpha channel;
    ``fill=False`` leaves a 2-px white gutter between cells, ``pad`` sets
    the gutter's width."""
    if (rows is None) != (cols is None):
        raise ValueError("Specify either both rows and cols or neither.")
    imgs = [np.asarray(im, np.float32) for im in images]
    if rows is None:
        rows, cols = len(imgs), 1
    cells = []
    for im in imgs:
        if im.ndim == 2:
            cells.append(im[..., None].repeat(3, -1))
        elif rgb or im.shape[-1] <= 3:
            cells.append(im[..., :3])
        else:
            cells.append(im[..., 3:4].repeat(3, -1))
    h = max(c.shape[0] for c in cells)
    w = max(c.shape[1] for c in cells)
    g = pad if pad else (0 if fill else 2)
    grid = np.ones((rows * (h + g) - g if rows else 0, cols * (w + g) - g if cols else 0, 3), np.float32)
    for k, cell in enumerate(cells[: rows * cols]):
        r, c = divmod(k, cols)
        grid[r * (h + g): r * (h + g) + cell.shape[0], c * (w + g): c * (w + g) + cell.shape[1]] = cell
    return grid


def rotating_views(n_frames: int = 36, dist: float = 4.0):
    """The camera ring of the rotating video: (R (n, 3, 3) f32, t (n, 3)),
    frame i turned by 2 pi i / n about y, at distance ``dist``."""
    angles = torch.tensor([[0.0, 2 * np.pi * i / n_frames, 0.0] for i in range(n_frames)], dtype=torch.float32)
    return euler_zyx_to_matrix(angles).numpy(), np.tile(np.array([0.0, 0.0, dist]), (n_frames, 1))
