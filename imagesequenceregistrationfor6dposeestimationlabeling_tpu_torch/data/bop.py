"""BOP dataset IO (counterpart of data/bop.py): the port's own copy of the
reference's host-side loader, numpy and Pillow only.

The crop follows the reference's ``generate_bop_realsamples``:

* mask the background to black,
* bounding rect of the mask, width/height rounded DOWN to even,
* paste the crop centered in a square of side max(w, h) + 2*offset,
* resize to maxB x maxB (cubic for RGB, nearest for the mask),
* K fixup: principal point shifted by the crop, then scaled by
  maxB / square_size,
* GT R, t from scene_gt.json,
* half-sequence selection by image id (``half_sequence_ids``).

Pillow is imported where an image is read, so the module imports without
it (the PLY and JSON readers need none).  Returns numpy arrays ready for
``geometry.cameras.camera_from_bop``.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Sequence

import numpy as np


class BopSamples(NamedTuple):
    images: np.ndarray        # (N, maxB, maxB, 3) float32 in [0, 1]
    sils: np.ndarray          # (N, maxB, maxB) float32 in {0, 1}
    R: np.ndarray             # (N, 3, 3) cam_R_m2c
    t: np.ndarray             # (N, 3) cam_t_m2c (mm)
    K: np.ndarray             # (N, 3, 3) crop-adjusted intrinsics
    ids: np.ndarray           # (N,) image ids


def _bounding_rect(mask: np.ndarray):
    """cv2.boundingRect equivalent on a binary mask."""
    ys, xs = np.where(mask > 0)
    if len(xs) == 0:
        return 0, 0, 0, 0
    x, y = xs.min(), ys.min()
    w, h = xs.max() - x + 1, ys.max() - y + 1
    return int(x), int(y), int(w), int(h)


def _resize(img: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    from PIL import Image

    im = Image.fromarray(img)
    im = im.resize((size, size), Image.NEAREST if nearest else Image.BICUBIC)
    return np.asarray(im)


def _read_image(path: str, rgb: bool) -> np.ndarray:
    from PIL import Image

    im = Image.open(path)
    return np.asarray(im.convert("RGB") if rgb else im)


def half_sequence_ids(dataset: str, uh: int, ruapc_total: int = 2561, tless_total: int = 1001):
    """First/second half split of a sequence's image ids."""
    total = tless_total if dataset == "tless" else ruapc_total
    n = total // 2
    ids = np.arange(n)
    if not uh:
        ids = ids + (500 if dataset == "tless" else 1280)
    return ids


def _read_mask(obj_dir: str, mask_str: str, im_id: int) -> np.ndarray:
    mask = _read_image(os.path.join(obj_dir, mask_str, f"{im_id:06d}_000000.png"), rgb=False)
    return mask[..., 0] if mask.ndim == 3 else mask


def load_bop_samples(dataset_path: str, objid, few_ids: Sequence[int], max_b: int = 200, offset: int = 5,
                     mask_str: str = "mask", split_dir: str = "train") -> BopSamples:
    """Masked, square-cropped training samples of ``few_ids`` with their GT
    poses and crop-adjusted intrinsics."""
    obj_dir = os.path.join(dataset_path, split_dir, str(objid).zfill(6))
    with open(os.path.join(obj_dir, "scene_camera.json")) as f:
        cam_params = json.load(f)
    with open(os.path.join(obj_dir, "scene_gt.json")) as f:
        scene_gt = json.load(f)

    n = len(few_ids)
    images = np.zeros((n, max_b, max_b, 3), np.float32)
    sils = np.zeros((n, max_b, max_b), np.float32)
    R = np.zeros((n, 3, 3))
    t = np.zeros((n, 3))
    K = np.zeros((n, 3, 3))

    for a, im_id in enumerate(few_ids):
        im_id = int(im_id)
        rgb = _read_image(os.path.join(obj_dir, "rgb", f"{im_id:06d}.png"), rgb=True).copy()
        mask = _read_mask(obj_dir, mask_str, im_id)
        rgb[mask == 0] = 0

        x2, y2, w2, h2 = _bounding_rect(mask)
        w2 -= w2 % 2
        h2 -= h2 % 2
        hw, hh = w2 // 2, h2 // 2
        side = max(w2, h2) + 2 * offset
        hs1 = side // 2

        sq_rgb = np.zeros((side, side, 3), np.uint8)
        sq_mask = np.zeros((side, side), np.uint8)
        sq_rgb[hs1 - hh: hs1 + hh, hs1 - hw: hs1 + hw] = rgb[y2: y2 + h2, x2: x2 + w2]
        sq_mask[hs1 - hh: hs1 + hh, hs1 - hw: hs1 + hw] = mask[y2: y2 + h2, x2: x2 + w2]

        images[a] = _resize(sq_rgb, max_b, nearest=False).astype(np.float32) / 255.0
        sils[a] = (_resize(sq_mask, max_b, nearest=True).astype(np.float32) / max(mask.max(), 1)) > 0.5

        det = scene_gt[str(im_id)][0]
        R[a] = np.asarray(det["cam_R_m2c"]).reshape(3, 3)
        t[a] = np.asarray(det["cam_t_m2c"])

        cam = np.asarray(cam_params[str(im_id)]["cam_K"]).reshape(3, 3).astype(np.float64)
        cam[0, 2] += -x2 + hs1 - hw
        cam[1, 2] += -y2 + hs1 - hh
        cam = cam * (max_b / side)
        cam[2, 2] = 1.0
        K[a] = cam

    return BopSamples(images, sils, R, t, K, np.asarray(list(few_ids)))


class BopFullFrames(NamedTuple):
    frames: list              # N x (H, W, 3) float32 raw frames in [0, 1]
    masks: list               # N x (H, W) float32 visib masks in {0, 1}
    R: np.ndarray             # (N, 3, 3)
    t: np.ndarray             # (N, 3)
    K: np.ndarray             # (N, 3, 3) UNMODIFIED full-frame intrinsics
    ids: np.ndarray


def load_bop_full_frames(dataset_path: str, objid, few_ids: Sequence[int], mask_str: str = "mask_visib",
                         split_dir: str = "train") -> BopFullFrames:
    """Raw scene frames with their visibility masks, GT poses and
    unmodified intrinsics, for full-frame inference."""
    obj_dir = os.path.join(dataset_path, split_dir, str(objid).zfill(6))
    with open(os.path.join(obj_dir, "scene_camera.json")) as f:
        cam_params = json.load(f)
    with open(os.path.join(obj_dir, "scene_gt.json")) as f:
        scene_gt = json.load(f)

    frames, masks, Rs, ts, Ks, ids = [], [], [], [], [], []
    for im_id in few_ids:
        im_id = int(im_id)
        rgb = _read_image(os.path.join(obj_dir, "rgb", f"{im_id:06d}.png"), rgb=True)
        mask = _read_mask(obj_dir, mask_str, im_id)
        frames.append(rgb.astype(np.float32) / 255.0)
        masks.append((mask > 0).astype(np.float32))
        det = scene_gt[str(im_id)][0]
        Rs.append(np.asarray(det["cam_R_m2c"]).reshape(3, 3))
        ts.append(np.asarray(det["cam_t_m2c"]))
        Ks.append(np.asarray(cam_params[str(im_id)]["cam_K"]).reshape(3, 3))
        ids.append(im_id)
    return BopFullFrames(frames, masks, np.stack(Rs), np.stack(ts), np.stack(Ks), np.asarray(ids))


def load_diameter(dataset_path: str, objid) -> float:
    with open(os.path.join(dataset_path, "models", "models_info.json")) as f:
        return float(json.load(f)[str(objid)]["diameter"])


def load_cad_points(dataset_path: str, objid, max_points: int = 50000) -> np.ndarray:
    """Vertices of the CAD model PLY (ascii or binary)."""
    return read_ply_vertices(os.path.join(dataset_path, "models", f"obj_{int(objid):06d}.ply"), max_points)


_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def read_ply_vertices(path: str, max_points: int = 0) -> np.ndarray:
    """The vertex positions (V, 3) f32 of a PLY file; more than
    ``max_points`` (> 0) are cut to a seeded random subset."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts, fmt, props, in_vertex = 0, "ascii", [], False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_verts = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[1], parts[2]))
        if fmt == "ascii":
            verts = np.asarray([[float(v) for v in f.readline().split()[:3]] for _ in range(n_verts)], np.float32)
        else:
            endian = "<" if "little" in fmt else ">"
            dtype = np.dtype([(name, endian + _PLY_TYPES[t]) for t, name in props])
            data = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype, count=n_verts)
            verts = np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(np.float32)
    if max_points and verts.shape[0] > max_points:
        verts = verts[np.random.default_rng(0).permutation(verts.shape[0])[:max_points]]
    return verts
