"""Procedural mesh scene (counterpart of data/mesh_scene.py): a no-download
asymmetric blob mesh (an icosphere with a smooth radial deformation)
rendered by ``ops.rasterize.render_mesh`` (z-buffered triangles, a
Lambertian point light at the camera) from N views on a sphere, returned in
the BOP loaders' convention (images, silhouettes, R_bop, t_bop, K), so the
whole pipeline runs on mesh-rendered data too.

The reference renders groups of 32 views under ``lax.map``; here each group
of ``VIEW_BATCH`` views is one batched render on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import mcubes, rasterize

VIEW_BATCH = 8  # views rendered in one batch


def icosphere(subdivisions: int = 3):
    """Unit icosphere: (V, 3) float32 verts, (T, 3) int32 faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(i, j):
            k = (min(i, j), max(i, j))
            if k not in edge_mid:
                m = verts_list[i] + verts_list[j]
                m /= np.linalg.norm(m)
                edge_mid[k] = len(verts_list)
                verts_list.append(m)
            return edge_mid[k]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces.astype(np.int32)


def blob_mesh(subdivisions: int = 3):
    """The asymmetric blob: (verts, faces, per-vertex NOCS-style albedo,
    area-weighted vertex normals), scaled to a ~0.6 radius so the default
    cameras (f = 2.1 S at distance 4) frame it like the analytic object."""
    verts, faces = icosphere(subdivisions)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    r = 1.0 + 0.18 * np.sin(3.0 * x) * np.cos(2.0 * y) + 0.12 * np.sin(2.5 * z + 0.7)
    verts = verts * (0.5 * r[:, None])
    normals = mcubes.vertex_normals(verts.astype(np.float64), faces).astype(np.float32)
    span = verts.max(0) - verts.min(0)
    colors = (verts - verts.min(0)) / np.maximum(span, 1e-6)
    return verts.astype(np.float32), faces, colors.astype(np.float32), normals


def procedural_albedo(p: torch.Tensor) -> torch.Tensor:
    """High-frequency procedural albedo of surface points (..., 3) -> (..., 3):
    phase-warped sinusoids ("marble") mixed with a soft rotated checker,
    features of ~5-20 px at 224^2 and the default framing."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    warp = 0.35 * torch.sin(9.0 * y + 2.0 * torch.cos(7.0 * z))
    m1 = torch.sin(14.0 * x + 3.0 * torch.sin(11.0 * y) + warp)
    m2 = torch.sin(17.0 * (y + 0.6 * z) + 2.0 * torch.cos(13.0 * x))
    u = 0.8 * x + 0.6 * z
    v = 0.8 * y - 0.6 * z
    checker = torch.tanh(6.0 * torch.sin(20.0 * u) * torch.sin(20.0 * v))
    r = 0.55 + 0.30 * m1 + 0.12 * checker
    g = 0.50 + 0.28 * m2 - 0.10 * checker
    b = 0.45 + 0.22 * torch.sin(26.0 * z + 2.0 * m1) + 0.08 * m2
    return torch.stack([r, g, b], dim=-1).clamp(0.02, 1.0)


class MeshScene(NamedTuple):
    images: torch.Tensor   # (N, S, S, 3) in [0, 1]
    sils: torch.Tensor     # (N, S, S) in {0, 1}
    depths: torch.Tensor   # (N, S, S), +inf at misses
    R_bop: torch.Tensor    # (N, 3, 3)
    t_bop: torch.Tensor    # (N, 3)
    K: torch.Tensor        # (N, 3, 3)
    verts: np.ndarray
    faces: np.ndarray
    diameter: float


def make_mesh_scene(n_views: int = 8, image_size: int = 64, generator: torch.Generator | None = None,
                    subdivisions: int = 3, dist: float = 4.0, textured: bool = False, uniforms=None,
                    device=None) -> MeshScene:
    """N rasterized views of the blob mesh with silhouettes, depths and
    BOP-convention poses and intrinsics, on ``device`` (the card unless
    named).  The poses' uniform draws ``uniforms`` (3, N) may be passed in
    (see ``synthetic.random_bop_poses``); otherwise they come from
    ``generator``."""
    device = resolve_device(device)
    S = image_size
    verts, faces, colors, normals = blob_mesh(subdivisions)
    R_bop, t_bop = synthetic.random_bop_poses(n_views, generator, dist, uniforms=uniforms, device=device)
    K = torch.tensor([[2.1 * S, 0.0, S / 2.0], [0.0, 2.1 * S, S / 2.0], [0.0, 0.0, 1.0]], dtype=torch.float32,
                     device=device).expand(n_views, 3, 3).contiguous()
    cams = cam_lib.camera_from_bop(R_bop, t_bop, K, S)
    on = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    mesh = (on(verts), on(faces), on(colors), on(normals))
    albedo_fn = procedural_albedo if textured else None
    parts = [rasterize.render_mesh(*mesh, cams[v0:v0 + VIEW_BATCH], S, albedo_fn=albedo_fn)
             for v0 in range(0, n_views, VIEW_BATCH)]
    images, sils, depths = (torch.cat(x) for x in zip(*parts))
    diameter = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    return MeshScene(images, sils, depths, R_bop, t_bop, K, verts, faces, diameter)
