"""The operation counts of SurfEmb's estimator (``drivers/surf_eval.py``),
from the shapes the cell's configuration and traffic state, never from
what the program reports.  An image's FLOPs:

- the ResNet-UNet's forward on one crop (``counts.unet_conv_flops``);
- the distribution's products: 2 e FLOPs a (pixel, key) pair over the
  stride's grid and every key;
- the scoring's projections: every key's point under every evaluated
  pose, 24 FLOPs each (a rigid transform, 9 FMAs; the pinhole, two
  divisions and two FMAs);
- the refiner's denominator: 2 e FLOPs a (pixel, key) pair over every
  pixel of the crop and ``n_denom`` keys;
- its objective evaluations: every pixel of the crop projected (24),
  sampled bilinearly from the query and denominator images (4 taps of
  2 FLOPs a channel) and dotted with its key (2 e), a value-and-gradient
  counted as three evaluations; a BFGS step is one batch of ``TRIALS``
  trials and one value-and-gradient, and the start one more.

K2, the refiner's key lookup (every pixel of the crop against every
key): 9 operations a pair at one operation a lane a clock (132 SMs x 128
lanes x 1.98 GHz), or its bytes (the queries, the points' 16-byte records
and a distance and an index a query) at the memory rate.
"""

from __future__ import annotations

from portbench.harness import counts

PROJECT_FLOPS = 24
TRIALS = 12
K2_OPS = 132 * 128 * 1.98e9
K2_OPS_A_PAIR = 9


def image_flops(cfg: dict, tr: dict) -> dict:
    """An image's FLOPs by stage."""
    s, S, m = cfg["surfemb"], tr["image_size"], tr["n_keys"]
    e = cfg["field"]["feature_dim"]
    n = (S // s["down_sample"]) ** 2
    px = S * S
    evals = s["refine_steps"] * (TRIALS + 3) + 3 if s["refine"] else 0
    return {
        "unet": float(sum(counts.unet_conv_flops(cfg["unet"], 1, S))),
        "distribution": 2.0 * n * m * e,
        "score": float(PROJECT_FLOPS * s["max_pose_evaluations"] * m),
        "denominator": 2.0 * px * s["n_denom"] * e if s["refine"] else 0.0,
        "objective": float(evals * px * (PROJECT_FLOPS + 8 * (e + 1) + 2 * e)),
    }


def k2_least_s(n: int, m: int) -> float:
    """K2's least time for n queries against m points."""
    return max((12 * n + 16 * m + 8 * n) / counts.HBM_BPS, K2_OPS_A_PAIR * n * m / K2_OPS)
