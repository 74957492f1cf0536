"""Isosurface extraction on the host (counterpart of ops/mcubes.py).

Replaces PyMCubes' ``marching_cubes`` (nerf.py:699-703).  The density grid
is evaluated on the card (render/renderer.py:density_grid, kernel K1); only
the topology extraction runs on the host, in C++ (``native``) with this
numpy version as its fallback and reference.

We use *marching tetrahedra* (6 tets per cube) instead of classic marching
cubes: identical isosurface vertices up to triangulation, no ambiguous
cases, and a tiny case table that vectorizes over the whole grid in numpy.
Shared vertices are deduplicated by their (grid-edge id) key so the output
is a proper indexed mesh usable for vertex normals (genFeat.py:208-212).
"""

from __future__ import annotations

import numpy as np

# Cube corner offsets, index 0..7.
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.int64,
)

# 6-tetrahedron decomposition around the 0-6 diagonal.
_TETS = np.array(
    [
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
        [0, 5, 1, 6],
    ],
    dtype=np.int64,
)

# Tet edges by local vertex pair.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# Case table: for each of 16 inside-masks (bit v set when tet vertex v is
# above the threshold), up to 2 triangles given as tet-edge indices; -1 pads.
_CASES = -np.ones((16, 2, 3), dtype=np.int64)
_CASES[1, 0] = [0, 1, 2]
_CASES[2, 0] = [0, 4, 3]
_CASES[4, 0] = [1, 3, 5]
_CASES[8, 0] = [2, 5, 4]
_CASES[14, 0] = [0, 2, 1]
_CASES[13, 0] = [0, 3, 4]
_CASES[11, 0] = [1, 5, 3]
_CASES[7, 0] = [2, 4, 5]
_CASES[3, 0] = [1, 3, 4]
_CASES[3, 1] = [1, 4, 2]
_CASES[5, 0] = [0, 3, 5]
_CASES[5, 1] = [0, 5, 2]
_CASES[9, 0] = [0, 4, 5]
_CASES[9, 1] = [0, 5, 1]
_CASES[12, 0] = [1, 4, 3]
_CASES[12, 1] = [1, 2, 4]
_CASES[10, 0] = [0, 5, 3]
_CASES[10, 1] = [0, 2, 5]
_CASES[6, 0] = [0, 5, 4]
_CASES[6, 1] = [0, 1, 5]


def marching_tetrahedra(density: np.ndarray, threshold: float, native: bool = True):
    """Extract the `density > threshold` isosurface.

    density: (R, R, R) with D[i, j, k] = value at integer point (i, j, k)
    (axis order x, y, z as produced by renderer.density_grid).

    Returns (verts (V, 3) float32 in index coordinates, tris (T, 3) int64).
    Uses the native C++ kernel when available (native/march_tets.cpp);
    this numpy implementation is the fallback and reference.
    """
    density = np.asarray(density)
    if native:
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.native import march_tets_native

        out = march_tets_native(density, threshold)
        if out is not None:
            return out
    R = density.shape[0]

    # Global grid point ids.
    def pid(p):  # p: (..., 3)
        return (p[..., 0] * R + p[..., 1]) * R + p[..., 2]

    # Cube base coordinates (R-1)^3.
    r = np.arange(R - 1)
    bx, by, bz = np.meshgrid(r, r, r, indexing="ij")
    base = np.stack([bx, by, bz], axis=-1).reshape(-1, 3)  # (C, 3)

    # Only keep cubes whose 8 corners straddle the threshold.
    inside = density > threshold
    # 8-corner inside sums via shifted views
    s = np.zeros((R - 1, R - 1, R - 1), dtype=np.int8)
    for dx, dy, dz in _CORNERS:
        s += inside[dx : R - 1 + dx, dy : R - 1 + dy, dz : R - 1 + dz]
    active = ((s > 0) & (s < 8)).reshape(-1)
    base = base[active]  # (A, 3)
    if base.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    corners = base[:, None, :] + _CORNERS[None]  # (A, 8, 3)
    vals = density[corners[..., 0], corners[..., 1], corners[..., 2]]  # (A, 8)

    # Per tet: vertex positions/values.
    tet_corners = corners[:, _TETS, :]  # (A, 6, 4, 3)
    tet_vals = vals[:, _TETS]  # (A, 6, 4)
    tet_in = tet_vals > threshold
    mask_idx = (
        tet_in[..., 0].astype(np.int64)
        + 2 * tet_in[..., 1]
        + 4 * tet_in[..., 2]
        + 8 * tet_in[..., 3]
    )  # (A, 6)

    tris_case = _CASES[mask_idx]  # (A, 6, 2, 3) tet-edge ids or -1
    valid_tri = tris_case[..., 0] >= 0  # (A, 6, 2)
    a_idx, t_idx, k_idx = np.nonzero(valid_tri)
    tri_edges = tris_case[a_idx, t_idx, k_idx]  # (T, 3) tet-edge ids

    # Edge endpoints as global point ids + interpolated positions.
    ev = _TET_EDGES[tri_edges]  # (T, 3, 2) local tet-vertex pairs
    pc = tet_corners[a_idx, t_idx]  # (T, 4, 3)
    pv = tet_vals[a_idx, t_idx]  # (T, 4)
    t_ar = np.arange(ev.shape[0])[:, None]
    p0 = pc[t_ar, ev[..., 0]]  # (T, 3, 3)
    p1 = pc[t_ar, ev[..., 1]]
    v0 = pv[t_ar, ev[..., 0]]  # (T, 3)
    v1 = pv[t_ar, ev[..., 1]]

    denom = v1 - v0
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = np.clip((threshold - v0) / denom, 0.0, 1.0)[..., None]
    pos = p0.astype(np.float64) + t * (p1 - p0)  # (T, 3 verts, 3)

    # Orient every triangle so its normal points away from the tet's inside
    # vertices (outward for density>threshold solids).  This avoids having
    # to keep the case table winding-consistent by hand.
    tin = tet_in[a_idx, t_idx]  # (T, 4) bool
    w_in = tin.astype(np.float64)
    inside_centroid = (pc * w_in[..., None]).sum(1) / np.maximum(w_in.sum(1, keepdims=True), 1)
    fn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    tri_centroid = pos.mean(1)
    flip = np.sum(fn * (tri_centroid - inside_centroid), axis=-1) < 0
    pos[flip] = pos[flip][:, ::-1]
    p0[flip], p1[flip] = p0[flip][:, ::-1], p1[flip][:, ::-1]
    v0[flip], v1[flip] = v0[flip][:, ::-1], v1[flip][:, ::-1]

    # Dedup by unordered grid-edge key.
    id0 = pid(p0)
    id1 = pid(p1)
    lo = np.minimum(id0, id1)
    hi = np.maximum(id0, id1)
    key = lo * (R**3) + hi  # (T, 3)
    flat_key = key.reshape(-1)
    uniq, inv = np.unique(flat_key, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float64)
    verts[inv] = pos.reshape(-1, 3)
    tris = inv.reshape(-1, 3)
    # drop degenerate triangles (two corners on the same grid edge)
    good = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    return verts.astype(np.float32), tris[good]


def index_to_world(verts: np.ndarray, grid_res: int, exact: bool = False) -> np.ndarray:
    """Map index coords to [-1, 1]^3 world coords.

    The reference uses ``(v - 64) / 64`` for R=128 (nerf.py:701); with
    ``exact=True`` the mapping matches linspace(-1, 1, R) precisely.
    """
    if exact:
        return verts * (2.0 / (grid_res - 1)) - 1.0
    half = grid_res // 2
    return (verts - half) / half


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (replaces trimesh.vertex_normals,
    genFeat.py:208-212)."""
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(verts)
    for i in range(3):
        np.add.at(normals, tris[:, i], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)
