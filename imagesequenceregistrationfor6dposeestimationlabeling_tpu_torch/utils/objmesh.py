"""CAD object wrapper (counterpart of utils/objmesh.py): the model's
vertices, its diameter, and the bounding-sphere normalization."""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data.bop import read_ply_vertices


class Obj(NamedTuple):
    obj_id: int
    vertices: np.ndarray
    diameter: float
    offset: np.ndarray   # bounding-sphere center
    scale: float         # bounding-sphere radius

    def normalize(self, pts: np.ndarray) -> np.ndarray:
        return (pts - self.offset) / self.scale

    def denormalize(self, pts_norm: np.ndarray) -> np.ndarray:
        return pts_norm * self.scale + self.offset


def _bounding_sphere(verts: np.ndarray):
    """Ritter's approximate bounding sphere, grown until it holds every
    vertex."""
    p0 = verts[0]
    p1 = verts[np.argmax(np.linalg.norm(verts - p0, axis=1))]
    p2 = verts[np.argmax(np.linalg.norm(verts - p1, axis=1))]
    center = (p1 + p2) / 2
    radius = np.linalg.norm(p2 - p1) / 2
    for _ in range(3):
        d = np.linalg.norm(verts - center, axis=1)
        i = np.argmax(d)
        if d[i] <= radius * (1 + 1e-9):
            break
        new_r = (radius + d[i]) / 2
        center = center + (verts[i] - center) * ((d[i] - radius) / (2 * d[i]))
        radius = new_r
    d = np.linalg.norm(verts - center, axis=1).max()
    return center, float(max(radius, d))


def load_obj(models_root: str, obj_id: int) -> Obj:
    with open(os.path.join(models_root, "models_info.json")) as f:
        info = json.load(f)
    verts = read_ply_vertices(os.path.join(models_root, f"obj_{obj_id:06d}.ply"))
    center, radius = _bounding_sphere(verts)
    return Obj(obj_id, verts, float(info[str(obj_id)]["diameter"]), center, radius)
