"""On-disk artifacts of the port (counterpart of pipeline/artifacts.py).

The port's own reader and writer of the reference's format, for the
stages ported so far: the bake's arrays in ``{UH}_{dataset}_obj_{objid}/
<obj>poseEst/`` (vert1_scaled, feat1_scaled, normals_scaled, n_keys), as
``.npy`` files with the reference's stems, so either package reads what
the other wrote (a test holds them to that).  The correspondence stage's
per-view ray files come with its port.
"""

from __future__ import annotations

import os

import numpy as np


def pose_dir(exp_dir: str, objid) -> str:
    return os.path.join(exp_dir, f"{objid}poseEst")


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
