"""Disk cache of synthetic scenes (counterpart of data/scene_cache.py).

A scene is deterministic in (seed, views, image size, kind), so reruns
read it from an ``.npz`` instead of rendering it again.  The file names and
the ``.npz`` layout are the reference's: a cache written by either package
reads in the other when its directory is passed.  Each package draws its
own scene from the seed, so a scene generated here is not the reference's
scene of that seed, and the default directory is the port's own
(``.bench_cache/torch``, beside the reference's ``.bench_cache``): a call
with no ``cache_dir`` never reads the other package's scene.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device

_DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                              ".bench_cache", "torch")
KINDS = ("analytic", "mesh", "mesh_tex")


def cache_path(seed: int, n_views: int, image_size: int, cache_dir: str, kind: str = "analytic") -> str:
    prefix = "scene" if kind == "analytic" else f"scene-{kind}"
    return os.path.join(cache_dir, f"{prefix}_{seed}_{n_views}_{image_size}.npz")


def load_scene_cached(seed: int, n_views: int, image_size: int, cache_dir: str | None = None,
                      kind: str = "analytic", device=None):
    """A ``synthetic.SyntheticScene`` on ``device`` (the card unless named),
    read from the cache or generated from a generator seeded with ``seed``
    and cached.  ``kind``: "analytic" (``synthetic.make_scene``), "mesh"
    (the rasterized blob mesh, flat NOCS shading, 4 subdivisions) or
    "mesh_tex" (the same with the procedural texture)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic

    if kind not in KINDS:
        raise ValueError(f"unknown scene kind: {kind!r}")
    device = resolve_device(device)
    cache_dir = cache_dir or _DEFAULT_CACHE
    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(seed, n_views, image_size, cache_dir, kind)
    if os.path.exists(path):
        z = np.load(path)
        on = lambda name: torch.as_tensor(z[name], device=device)  # noqa: E731
        return synthetic.SyntheticScene(on("images"), on("sils"), on("R_bop"), on("t_bop"), on("K"),
                                        float(z["diameter"]))
    generator = torch.Generator(device=device).manual_seed(seed)
    if kind == "analytic":
        scene = synthetic.make_scene(n_views=n_views, image_size=image_size, generator=generator, device=device)
    else:
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene

        ms = mesh_scene.make_mesh_scene(n_views=n_views, image_size=image_size, generator=generator,
                                        subdivisions=4, textured=(kind == "mesh_tex"), device=device)
        scene = synthetic.SyntheticScene(ms.images, ms.sils, ms.R_bop, ms.t_bop, ms.K, ms.diameter)
    # atomic publish: an interrupted or concurrent writer never leaves a
    # truncated .npz behind
    tmp = path + f".tmp.{os.getpid()}.npz"
    np.savez(tmp, images=scene.images.cpu().numpy(), sils=scene.sils.cpu().numpy(),
             R_bop=scene.R_bop.cpu().numpy(), t_bop=scene.t_bop.cpu().numpy(), K=scene.K.cpu().numpy(),
             diameter=scene.diameter)
    os.replace(tmp, path)
    return scene
