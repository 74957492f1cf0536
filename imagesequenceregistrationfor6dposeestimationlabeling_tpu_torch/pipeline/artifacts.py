"""On-disk artifacts of the port (counterpart of pipeline/artifacts.py).

The port's own reader and writer of the reference's format, as ``.npy``
files with the reference's stems, so either package reads what the other
wrote (a test holds them to that).  Per half-sequence experiment
directory ``{UH}_{dataset}_obj_{objid}/``:

  <obj>Cors/a1.npy                      denoised surface cloud
  <obj>Cors/subvert1.npy                its FPS subsample
  <obj>Cors/subnormal1.npy              the subsample's normals
  <obj>Cors/{S}_sampledRayxys/<i>.npy   view i's front-hit ray xys (NDC)
  <obj>Cors/{S}_posVec/<i>.npy          view i's front surface hits
  <obj>Cors/{S}_sampledRayBackxys/<i>.npy
  <obj>Cors/{S}_posVecBack/<i>.npy      view i's back surface hits
  <obj>poseEst/vert1_scaled.npy, feat1_scaled.npy, normals_scaled.npy,
  n_keys.npy                            the bake's keys
"""

from __future__ import annotations

import os

import numpy as np

_VIEW_RAYS = ("sampledRayxys", "posVec", "sampledRayBackxys", "posVecBack")


def cors_dir(exp_dir: str, objid) -> str:
    return os.path.join(exp_dir, f"{objid}Cors")


def pose_dir(exp_dir: str, objid) -> str:
    return os.path.join(exp_dir, f"{objid}poseEst")


def nerf_dir(exp_dir: str, objid) -> str:
    return os.path.join(exp_dir, f"{objid}TLESSObj_Fine")


def save_view_rays(cors: str, render_size: int, view_id: int, xys, pos_vec, back_xys, back_vec):
    """View ``view_id``'s front and back hits with their ray xys."""
    for sub, arr in zip(_VIEW_RAYS, (xys, pos_vec, back_xys, back_vec)):
        d = os.path.join(cors, f"{render_size}_{sub}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{view_id}.npy"), np.asarray(arr))


def load_view_rays(cors: str, render_size: int, view_id: int):
    """(xys, pos_vec, back_xys, back_vec) of view ``view_id``."""
    return tuple(np.load(os.path.join(cors, f"{render_size}_{sub}", f"{view_id}.npy")) for sub in _VIEW_RAYS)


def has_view_rays(cors: str, render_size: int, view_id: int) -> bool:
    return os.path.exists(os.path.join(cors, f"{render_size}_posVec", f"{view_id}.npy"))


def save_array(path_dir: str, name: str, arr):
    os.makedirs(path_dir, exist_ok=True)
    np.save(os.path.join(path_dir, name), np.asarray(arr))


def load_array(path_dir: str, name: str):
    return np.load(os.path.join(path_dir, name))


def load_keys(pose_d: str, trim: bool = True):
    """The baked surface arrays (vert1/feat1/normals_scaled) and the true key
    count.  The bake pads its arrays by cycling points up to a multiple of
    ``FeatConfig.pad_multiple`` and records the true count in
    ``n_keys.npy``; consumers that average over keys (ICP, Chamfer, ADD)
    need the trimmed arrays, the correspondence search takes the padded
    ones (``trim=False``).  Returns (verts, feats, normals or None, n_real)."""
    verts = load_array(pose_d, "vert1_scaled.npy")
    feats = load_array(pose_d, "feat1_scaled.npy")
    normals_p = os.path.join(pose_d, "normals_scaled.npy")
    normals = np.load(normals_p) if os.path.exists(normals_p) else None
    n_keys_p = os.path.join(pose_d, "n_keys.npy")
    n_real = int(np.load(n_keys_p)[0]) if os.path.exists(n_keys_p) else verts.shape[0]
    if trim:
        verts = verts[:n_real]
        feats = feats[:n_real]
        if normals is not None:
            normals = normals[:n_real]
    return verts, feats, normals, n_real
