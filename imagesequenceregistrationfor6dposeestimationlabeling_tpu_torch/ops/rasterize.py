"""Rasterizers (counterpart of ops/rasterize.py): the point-splat z-buffer of
object coordinates under a pose, and the z-buffered triangle rasterizer of
the mesh scene.

The z-buffers are ``scatter_reduce_(..., "amin")`` on an ``inf``-filled
buffer (the reference's ``segment_min``); a minimum is exact, so the result
does not depend on the order the card's threads arrive in.
"""

from __future__ import annotations

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp


def segment_min(values: torch.Tensor, segments: torch.Tensor, n_segments: int, empty) -> torch.Tensor:
    """Per segment the least of ``values`` (flat, with their segment ids);
    ``empty`` where a segment has none."""
    out = torch.full((n_segments,), empty, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, segments, values, "amin")


def render_object_coords(pts: torch.Tensor, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor, res: int):
    """(coord image (res, res, 3), mask (res, res)) of the object points
    ``pts`` (m, 3) under the pose (R, t) and intrinsics K: each pixel holds
    the nearest projected point (the lowest index among equal depths); the
    mask is 1 where any point landed."""
    m = pts.shape[0]
    n = res * res
    uv, z = pnp.reproject(R, t, K, pts)
    uv = torch.round(uv)
    inside = ((uv >= 0) & (uv < res)).all(-1) & (z > 0)
    flat = torch.where(inside, (uv[:, 1] * res + uv[:, 0]).to(torch.int64), n)
    inf = torch.full_like(z, float("inf"))
    zbuf = segment_min(torch.where(inside, z, inf), flat, n + 1, float("inf"))
    # the winning point of a pixel: the lowest index among those at its depth
    won = inside & (z <= zbuf[flat] + 1e-9)
    ids = torch.arange(m, device=pts.device)
    idx = segment_min(torch.where(won, ids, m), flat, n + 1, m)[:n]
    hit = idx < m
    coords = torch.where(hit[:, None], pts[idx.clamp(0, m - 1)], torch.zeros((), dtype=pts.dtype, device=pts.device))
    return coords.reshape(res, res, 3), torch.isfinite(zbuf[:n]).to(torch.float32).reshape(res, res)


def render_mesh(verts: torch.Tensor, faces: torch.Tensor, vert_colors: torch.Tensor, vert_normals: torch.Tensor,
                cam: cam_lib.Camera, res: int, light_pos: torch.Tensor | None = None, ambient: float = 0.35,
                diffuse: float = 0.65, px_chunk: int = 2048, albedo_fn=None):
    """Z-buffered triangle rasterizer with Lambertian point-light shading.

    verts (V, 3) world-frame, faces (T, 3) int, per-vertex albedo and unit
    normals (V, 3); ``cam`` one camera or a batch (B).  Every chunk of
    ``px_chunk`` pixels tests all triangles at once (a barycentric inside
    test, ``w >= 0``; degenerate or behind-camera triangles never hit), the
    nearest hit wins (the first triangle among equal depths), and shading
    interpolates normals, positions and albedo with perspective-correct
    barycentrics; ``albedo_fn`` maps interpolated world positions to albedo
    instead.  The light sits at the camera unless ``light_pos`` is given.
    Returns (rgb (..., res, res, 3), sil (..., res, res), depth (..., res,
    res), +inf at misses)."""
    single = cam.R.dim() == 2
    if single:
        cam = cam_lib.Camera(cam.R[None], cam.T[None], cam.focal[None], cam.principal[None], cam.image_size)
    if light_pos is None:
        light_pos = cam_lib.camera_center(cam)
    light_pos = light_pos.expand(cam.R.shape[0], 3)
    faces = faces.to(torch.int64)
    xy_ndc, z = cam_lib.project_points(cam, verts)
    pix = cam_lib.ndc_to_pixel(xy_ndc, res)                    # (B, V, 2)
    v2 = pix[:, faces]                                        # (B, T, 3, 2)
    zf = z[:, faces]                                          # (B, T, 3)
    a, b, c = v2[:, :, 0], v2[:, :, 1], v2[:, :, 2]
    # signed double area of each screen triangle
    area = (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])
    big = area.abs() > 1e-12
    inv_area = torch.where(big, 1.0 / torch.where(big, area, torch.ones_like(area)), torch.zeros_like(area))
    degenerate = ~big | (zf <= 1e-6).any(-1)
    inv_z = 1.0 / zf.clamp_min(1e-6)                          # (B, T, 3)
    col_f, nrm_f, pos_f = vert_colors[faces], vert_normals[faces], verts[faces]   # (T, 3, d)

    centers = torch.arange(res, dtype=torch.float32, device=verts.device) + 0.5
    yy, xx = torch.meshgrid(centers, centers, indexing="ij")
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    rgbs, sils, depths = [], [], []
    for p in torch.split(pts, px_chunk):
        px, py = p[None, :, 0, None], p[None, :, 1, None]     # (1, P, 1)

        def edge(p0, p1):
            return ((p1[..., 0] - p0[..., 0])[:, None, :] * (py - p0[:, None, :, 1])
                    - (p1[..., 1] - p0[..., 1])[:, None, :] * (px - p0[:, None, :, 0]))

        w0 = edge(b, c) * inv_area[:, None, :]                # (B, P, T)
        w1 = edge(c, a) * inv_area[:, None, :]
        w2 = edge(a, b) * inv_area[:, None, :]
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ~degenerate[:, None, :]
        # perspective-correct interpolation: attributes over z interpolated
        # with the screen barycentrics, divided by the interpolated 1 / z
        iz = w0 * inv_z[:, None, :, 0] + w1 * inv_z[:, None, :, 1] + w2 * inv_z[:, None, :, 2]
        zpix = 1.0 / iz.clamp_min(1e-12)
        zmask = torch.where(inside, zpix, torch.full_like(zpix, float("inf")))
        best = torch.argmin(zmask, dim=-1, keepdim=True)      # (B, P, 1)
        hit = zmask.gather(-1, best)[..., 0] < float("inf")
        b0, b1, b2, zb = (w.gather(-1, best)[..., 0] for w in (w0, w1, w2, zpix))
        izv = inv_z.gather(1, best.expand(-1, -1, 3))         # (B, P, 3)
        pb = torch.stack([b0 * izv[..., 0], b1 * izv[..., 1], b2 * izv[..., 2]], -1) * zb[..., None]
        best = best[..., 0]

        def interp(attr_f):                                   # (T, 3, d) -> (B, P, d)
            return torch.einsum("bpk,bpkd->bpd", pb, attr_f[best])

        nrm = interp(nrm_f)
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True).clamp_min(1e-12)
        wpos = interp(pos_f)
        albedo = interp(col_f) if albedo_fn is None else albedo_fn(wpos)
        ldir = light_pos[:, None, :] - wpos
        ldir = ldir / torch.linalg.vector_norm(ldir, dim=-1, keepdim=True).clamp_min(1e-12)
        lam = (nrm * ldir).sum(-1).clamp_min(0.0)
        shade = (albedo * (ambient + diffuse * lam[..., None])).clamp(0.0, 1.0)
        rgbs.append(torch.where(hit[..., None], shade, torch.zeros_like(shade)))
        sils.append(hit.to(torch.float32))
        depths.append(torch.where(hit, zb, torch.full_like(zb, float("inf"))))
    B = cam.R.shape[0]
    rgb = torch.cat(rgbs, 1).reshape(B, res, res, 3)
    sil = torch.cat(sils, 1).reshape(B, res, res)
    depth = torch.cat(depths, 1).reshape(B, res, res)
    return (rgb[0], sil[0], depth[0]) if single else (rgb, sil, depth)
