#!/usr/bin/env python3
"""Chunked NeRF training through K5 / K6 and through their plain versions
on one CUDA device, for several training seeds: each run's mean loss of
every 10 steps and its fine field's grid max density at the end.  Tells a
systematic difference between the kernels and their plain versions from
the spread of the trajectories themselves: the count of seeds where each
side ends lower, and a two-sided sign test.

    python3 tools/chunked_trajectories.py [--steps 100] [--seeds 1 2 3 4]

The schedule and data are chip_smoke.py's chunked phase: the reference's
large-batch schedule (6 cams x 800 rays, 4,800 rays a step in chunks of
4,096 + 704), full-width field, synthetic half 0 from scene seed 0.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        FieldConfig,
        NerfTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    dev = torch.device(args.device)
    c = chip_smoke.CHUNKED
    scene = synthetic.make_scene(c["n_views"], c["image_size"], torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
    data = (scene.images, scene.sils, scene.R_bop, scene.t_bop, scene.K)
    cfg = FieldConfig(**chip_smoke.FIELD)
    render = RenderConfig(n_rays_per_image=c["n_rays"])
    train = NerfTrainConfig(batch_size=c["batch"], warmup_steps=min(300, args.steps // 3))
    last = {"K5 / K6": [], "plain": []}
    for seed in args.seeds:
        for name in last:
            with chip_smoke.plain_field_color(name == "plain"):
                state, losses = nerf_trainer.train_nerf(*data, cfg, render, train, n_steps=args.steps, seed=seed,
                                                        device=dev)
            losses = np.asarray(losses)
            peak = float(renderer.density_grid_cached(state.fine, grid_res=128).max())
            windows = [round(float(losses[i:i + 10].mean()), 3) for i in range(0, args.steps, 10)]
            print(f"seed {seed}, {name}: mean loss of each 10 steps {windows}; fine grid max density {peak:.4f}",
                  flush=True)
            last[name].append(windows[-1])
    for name, v in last.items():
        print(f"{name}: mean loss of the last 10 steps by seed {v}, mean {float(np.mean(v)):.3f}", flush=True)
    plain_lower, kernels_lower, p = sign_test(last["plain"], last["K5 / K6"])
    print(f"sign test over {len(args.seeds)} seeds: plain lower at {plain_lower}, kernels lower at {kernels_lower} "
          f"(ties {len(args.seeds) - plain_lower - kernels_lower}); two-sided p = {p:.4f}", flush=True)


def sign_test(a, b):
    """(count a < b, count b < a, two-sided exact binomial p with ties
    dropped) for paired samples ``a``, ``b``."""
    import math

    lo = sum(x < y for x, y in zip(a, b))
    hi = sum(y < x for x, y in zip(a, b))
    n = lo + hi
    if n == 0:
        return lo, hi, 1.0
    tail = sum(math.comb(n, i) for i in range(min(lo, hi) + 1)) / 2 ** n
    return lo, hi, min(1.0, 2 * tail)


if __name__ == "__main__":
    main()
