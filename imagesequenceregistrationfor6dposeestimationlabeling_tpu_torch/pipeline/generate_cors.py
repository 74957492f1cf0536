"""Correspondence precompute (counterpart of pipeline/generate_cors.py).

Per half-sequence, after NeRF training:

1. the surface: the density grid (K1 where enabled), marching tetrahedra
   at ``cfg.density_threshold``, radius-outlier removal -> ``a1.npy``; its
   FPS subsample with outward PCA normals -> ``subvert1.npy`` /
   ``subnormal1.npy``;
2. per training view, rays through the silhouette's pixels: the front
   pass (thresholded EA weights, K1) gives each ray's front hit, kept
   within ``cfg.mesh_filter_dist`` of ``a1`` (K2); the back pass from the
   front hit away from the camera (thresholded back weights, K1) gives the
   back hit, filtered the same way -> ``{S}_posVec`` / ``{S}_posVecBack``
   and their ray xys.

A view is rendered at its own silhouette's ray count, in chunks of at most
``RAY_CHUNK`` rays.  Views whose files exist are skipped, so an interrupted
run resumes where it stopped.  ``CORS_TIMING=1`` prints the sub-stages'
wall times.

With a device ``mesh`` (``parallel.mesh``; ``mesh="auto"``, the default,
is every card when there are several) the surface is extracted on home
and the views are dealt round-robin over the entries: each view's front
and back passes (K1) and mesh filters (K2) run on its entry's device with
that entry's copy of the field, and the views are written in view order.
The artifacts are the single-device run's.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import CorsConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import of_module
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel, mcubes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch, renderer

# rays a density evaluation covers (the reference's chunk)
RAY_CHUNK = 32768


class _Marks:
    """``CORS_TIMING=1``: print the wall seconds since the previous mark."""

    def __init__(self, fmt: str):
        self.fmt = fmt
        self.on = bool(os.environ.get("CORS_TIMING"))
        self.t = time.perf_counter()

    def __call__(self, name: str, dev: torch.device):
        if self.on:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            print(self.fmt.format(name=name, s=now - self.t), flush=True)
            self.t = now


@torch.no_grad()
def extract_surface(field, cfg: CorsConfig, grid_res: int = 128):
    """Density grid -> marching tetrahedra -> radius-outlier removal -> FPS
    subsample + normals.  Returns (mverts, subverts, subnormals) as numpy."""
    dev = next(field.parameters()).device
    mark = _Marks("    surface[{name}]: {s:.3f} s")
    grid = renderer.density_grid_cached(field, grid_res=grid_res).cpu().numpy()
    mark("density_grid", dev)
    verts_idx, _ = mcubes.marching_tetrahedra(grid, cfg.density_threshold)
    mark("march_tets", dev)
    if verts_idx.shape[0] < 10:
        raise RuntimeError(
            f"surface extraction found {verts_idx.shape[0]} vertices at density "
            f"threshold {cfg.density_threshold} — the NeRF has not converged "
            "(train longer / check LR warmup) or the threshold is too high"
        )
    mverts = torch.as_tensor(mcubes.index_to_world(verts_idx, grid_res, exact=True), dtype=torch.float32,
                             device=dev)
    keep = pc.radius_outlier_mask(mverts, cfg.outlier_nb_points, cfg.outlier_radius)
    mverts = mverts[keep]
    mark("radius_outlier", dev)
    if mverts.shape[0] < 10:
        raise RuntimeError(
            f"surface denoising kept {mverts.shape[0]} of {keep.shape[0]} vertices "
            f"(radius-outlier nb_points={cfg.outlier_nb_points}, radius={cfg.outlier_radius}) — the "
            "extracted surface is too sparse for these filters (train the NeRF longer or loosen the filters)"
        )
    n_sub = min(cfg.n_subsurface, mverts.shape[0])
    sub, normals, _ = pc.subsample_surface(mverts, n_sub, normals_k=min(cfg.normals_k, n_sub))
    out = mverts.cpu().numpy(), sub.cpu().numpy(), normals.cpu().numpy()
    mark("fps_normals", dev)
    return out


@torch.no_grad()
def view_surface_hits(field, cam: cam_lib.Camera, pix: torch.Tensor, mverts: torch.Tensor, image_size: int,
                      n_pts: int, min_depth: float, max_depth: float, threshold: float, mesh_dist: float,
                      back_div: float) -> dict:
    """One view's front and back surface hits for the rays through the flat
    row-major pixels ``pix`` (N,), density only (the composited features
    are never used).  Returns {"xys", "pos_vec", "front_valid", "back_vec",
    "back_valid"}, one row a ray."""
    dens_fn = field_kernel.density_eval_fn(field)

    def field_fn(pts, dirs, mode):
        dens = dens_fn(pts)
        return dens, dens

    bundle = cam_lib.rays_at_pixels(cam, pix, image_size, n_pts, min_depth, max_depth)
    _, weights = renderer.render_rays_chunked(field_fn, bundle, mode="density", threshold_mode=True,
                                              threshold=threshold, chunk=RAY_CHUNK)
    pos_vec = raymarch.surface_points(bundle.origins, bundle.directions, bundle.lengths, weights)
    d_mesh, _ = pc.nn_query(pos_vec, mverts)
    front_valid = (weights.sum(-1) > 0) & (d_mesh < mesh_dist)

    back = renderer.back_ray_bundle(bundle, pos_vec, div=back_div)
    back_pts = (cam_lib.ray_points(part) for part in renderer.bundle_chunks(back, RAY_CHUNK))
    dens = torch.cat([dens_fn(pts)[..., 0] for pts in back_pts])
    bw = raymarch.back_weights(dens, threshold_mode=True, threshold=0.05)
    back_vec = raymarch.surface_points(back.origins, back.directions, back.lengths, bw)
    d_mesh_b, _ = pc.nn_query(back_vec, mverts)
    back_valid = front_valid & (bw.sum(-1) > 0) & (d_mesh_b < mesh_dist)
    return {"xys": bundle.xys, "pos_vec": pos_vec, "front_valid": front_valid, "back_vec": back_vec,
            "back_valid": back_valid}


def silhouette_pixels(sil: np.ndarray) -> np.ndarray:
    """Flat row-major indices of a silhouette's pixels (pixel 0 if it has
    none, as the reference renders one ray for an empty view)."""
    idx = np.flatnonzero(np.asarray(sil).reshape(-1) > 0.5)
    return idx if idx.size else np.zeros((1,), np.int64)


def generate_cors(field, R_bop, t_bop, K, sils, out_dir: str, objid, cfg: CorsConfig = CorsConfig(),
                  grid_res: int = 128, image_size: int | None = None, depth_margin: float = 2.0,
                  device=None, mesh="auto") -> str:
    """The whole correspondence precompute of one half into ``out_dir``'s
    ``<objid>Cors/`` directory, whose path it returns.  ``field`` is a
    trained NerfField on ``device`` (the card unless named); R_bop (V, 3,
    3), t_bop (V, 3), K (V, 3, 3) and sils (V, S, S) as numpy arrays or
    tensors, the silhouettes at ``image_size`` (default
    ``cfg.render_size``).  ``mesh`` (home: the field's device, which
    ``device`` defaults to when only a mesh is given) takes the views
    round-robin."""
    mesh, dev = mesh_lib.place(mesh, device)
    dev = of_module(field, dev)
    S = image_size or cfg.render_size
    cors = artifacts.cors_dir(out_dir, objid)
    os.makedirs(cors, exist_ok=True)
    mark = _Marks("  cors[{name}]: {s:.2f} s")
    as_np = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.array(x)  # noqa: E731
    R_bop, t_bop, K, sils = (as_np(x) for x in (R_bop, t_bop, K, sils))

    mverts, sub, subnormals = extract_surface(field, cfg, grid_res)
    mark("extract_surface", dev)
    artifacts.save_array(cors, "a1.npy", mverts)
    artifacts.save_array(cors, "subvert1.npy", sub)
    artifacts.save_array(cors, "subnormal1.npy", subnormals)
    mark("save_surface", dev)

    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    cams = cam_lib.camera_from_bop(as_t(R_bop), as_t(t_bop), as_t(K), S)
    z = np.abs(t_bop[:, 2])
    min_d, max_d = float(z.min() - depth_margin), float(z.max() + depth_margin)
    mverts_t = as_t(mverts)
    pending = [i for i in range(R_bop.shape[0]) if not artifacts.has_view_rays(cors, S, i)]
    # the field and surface on each entry; pending view j on entry j % size
    devs, views = [dev], [(field, mverts_t)]
    if mesh is not None:
        devs, views = mesh.devices, list(zip(mesh_lib.replicate(field, mesh), mesh_lib.broadcast(mverts_t, mesh)))

    def save_view(i, out):
        fv, bv, xys = out["front_valid"], out["back_valid"], out["xys"]
        artifacts.save_view_rays(cors, S, i, xys[fv], out["pos_vec"][fv], xys[bv], out["back_vec"][bv])

    # each view's arrays come to the host once; the writes overlap the
    # later views' device work
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = []
        # a round queues one view on every entry before any comes to the host
        for r0 in range(0, len(pending), len(devs)):
            outs = []
            for i, d, (f, mv) in zip(pending[r0:r0 + len(devs)], devs, views):
                pix = torch.as_tensor(silhouette_pixels(sils[i]), device=d)
                outs.append((i, view_surface_hits(f, mesh_lib.to(cams[i], d), pix, mv, S, cfg.grid_pts_per_ray,
                                                  min_d, max_d, cfg.density_threshold, cfg.mesh_filter_dist,
                                                  cfg.back_len_div)))
            for i, out in outs:
                futs.append(pool.submit(save_view, i, {k: v.cpu().numpy() for k, v in out.items()}))
        mark("views_render", dev)
        for f in futs:
            f.result()
    mark("views_save", dev)
    return cors
