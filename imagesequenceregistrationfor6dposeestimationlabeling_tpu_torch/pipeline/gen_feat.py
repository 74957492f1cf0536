"""Feature baking (counterpart of pipeline/gen_feat.py).

1. sample surface hits over all views, FPS to ``cfg.n_points``,
2. keep |x| < ``cfg.bound``; marching tetrahedra on the density grid at
   ``cfg.mc_threshold`` for normals,
3. keep hits within ``cfg.mesh_dist`` of the mesh, normals from the
   nearest mesh vertex,
4. cycle the points up to a multiple of ``cfg.pad_multiple``,
5. evaluate the feature head, scale to CAD units by diameter / 1.8, and
   write vert1_scaled.npy / feat1_scaled.npy / normals_scaled.npy /
   n_keys.npy through ``artifacts``, the format the reference reads.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import mcubes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FeatConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import eval_features
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, surface_sampling
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer


def gen_feat(
    field,
    R_bop,
    t_bop,
    K,
    sils,
    diameter: float,
    out_dir: str,
    objid,
    cfg: FeatConfig = FeatConfig(),
    image_size: int = 224,
    rays_per_image: int = 50,
    grid_res: int = 128,
    diam_scaling: float = 1.8,
    threshold: float = 0.2,
    generator: torch.Generator | None = None,
    draws=None,
):
    """Bake the surface keys of ``field``; returns (verts_scaled, feats,
    normals) as numpy arrays, padded like the files on disk."""
    pose = artifacts.pose_dir(out_dir, objid)
    os.makedirs(pose, exist_ok=True)
    dev = next(field.parameters()).device

    hits = surface_sampling.sample_surface_hits(
        field, R_bop, t_bop, K, sils, n_loops=cfg.sample_loops, rays_per_image=rays_per_image,
        image_size=image_size, threshold=threshold, generator=generator, draws=draws,
    )
    n_fps = min(cfg.n_points, hits.shape[0])
    pts = hits[pc.farthest_point_sampling(hits, n_fps)]
    pts = pts[pts.abs().amax(-1) < cfg.bound]

    grid = renderer.density_grid_cached(field, grid_res=grid_res)
    verts_idx, tris = mcubes.marching_tetrahedra(grid.cpu().numpy(), cfg.mc_threshold)
    if verts_idx.shape[0] < 4:
        raise RuntimeError(
            f"gen_feat: marching tetrahedra found {verts_idx.shape[0]} vertices at density "
            f"threshold {cfg.mc_threshold} — the field has no surface at this level"
        )
    mverts = mcubes.index_to_world(verts_idx, grid_res, exact=True)
    mnormals = mcubes.vertex_normals(mverts, tris)

    d, nn_idx = pc.nn_query(pts, torch.as_tensor(mverts, dtype=torch.float32, device=dev))
    close = d < cfg.mesh_dist
    pts = pts[close]
    normals = mnormals[nn_idx[close].long().cpu().numpy()]
    if pts.shape[0] == 0:
        raise RuntimeError(
            f"gen_feat: no surface hits within mesh_dist={cfg.mesh_dist} of the mesh — hit "
            "threshold and mc_threshold disagree about where the surface is"
        )

    n_real = pts.shape[0]
    if cfg.pad_multiple > 1:
        target = int(np.ceil(n_real / cfg.pad_multiple) * cfg.pad_multiple)
        reps = np.resize(np.arange(n_real), target)
        pts = pts[torch.as_tensor(reps, device=dev)]
        normals = normals[reps]

    feats = eval_features(field, pts).cpu().numpy()
    pts = pts.cpu().numpy()
    scale = diameter / diam_scaling
    artifacts.save_array(pose, "vert1_scaled.npy", pts * scale)
    artifacts.save_array(pose, "feat1_scaled.npy", feats)
    artifacts.save_array(pose, "normals_scaled.npy", normals)
    artifacts.save_array(pose, "n_keys.npy", np.asarray([n_real]))
    return pts * scale, feats, normals
