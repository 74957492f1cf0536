#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port: builds the hand-written kernels,
checks each against its plain PyTorch version at the shapes of the path
that runs it, then trains both half-sequence NeRFs, trains one NeRF at a
large ray batch (chunked steps) and drives the serving path at bench
settings on one GPU.

    python3 chip_smoke.py                    # from the repository root, one CUDA device
    python3 chip_smoke.py --nerf-steps 200   # a shorter NeRF phase (the pipeline then trains its own 800)
    python3 chip_smoke.py --chunk-steps 200  # the reference's full large-batch schedule

Phases (any failure raises, and the script exits non-zero):
1. device and toolchain: the card's name and power limit (nvidia-smi),
   torch / CUDA / nvcc versions;
2. build K1-K6 from ``imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch/ops/csrc``,
   then count each kernel's tensor-core instructions (HMMA / HGMMA) in the
   built extension's SASS (``cuobjdump -sass``): every kernel of K1, K4,
   K5 and K6 must have some;
3. per kernel, kernel vs plain version on the card, error, both times and
   the bound (the least time the card could take: bytes over 3.35 TB/s or
   operations over the peak rate of their type, from this run's shapes):
   K1 on the 128^3 grid of a randomly initialised full-width field (and
   its sin / cos embedding stage alone), K4 at
   the train step's shapes (2 halves x 1,200 rays x 64 coarse / 320 fine
   points, full-width random fields, both embeddings, synthetic targets),
   K5 / K6 at a chunk's shapes (one half, 4,096 rays and the ragged 704,
   x 64 / 320 points, both embeddings);
4. NeRF training of both halves (``train_nerf_fused``) at the bench's
   settings: 8 views at 224 px, full-width bf16 field, 400 rays per image,
   batch 3, warmup 266, seed 1, ``--nerf-steps`` steps (default 800), with
   K4's launches counted over exactly that run; then one step with K4
   against one with its plain version from the same state and draws;
5. chunked NeRF training of one half (``train_nerf``) at the reference's
   large-batch schedule (experiments/nerf_schedule.py:40): 6 cams x 800
   rays a step, chunks of 4,096 and 704 rays through K5 / K6,
   ``--chunk-steps`` steps (default 100), with K5's and K6's launches
   counted over exactly that run; the same run through their plain
   versions (loss curves and surfaces reported side by side); a chunked
   step through K5 / K6 against one through their plain versions; exact
   resume through ``train.checkpoint``; each trained fine field's point
   cloud (K1 grid, marching tetrahedra) against the analytic surface;
6. the serving path of the bench (8 views at 224 px, 128^3 grid,
   FeatConfig(mc_threshold=0.05, n_points=20000, sample_loops=3), 8 images
   through InferenceConfig(), ICP with 20 iterations) on a full-width
   planted NerfField and a full-width random ResNetUNet from ``--seed``,
   with each kernel's launches counted over exactly that run;
7. checks of the outputs: shapes, finiteness, keys on the planted shell,
   and ICP from a perturbed ground-truth pose, card against the CPU plain
   path;
8. K2 and K3 against their plain versions at the launch shapes the serve
   run recorded (K2's time summed over its launches, K3's one launch),
   each captured in a CUDA graph and timed with CUDA events over its
   replays; K2 also at 50,000 x 50,000, K3 also with one 224^2 crop
   (5,625 queries) and 8 crops (45,000) against a real object's 80,000
   keys;
9. the bench's chain after NeRF training (``PIPELINE``), on phase 4's
   trained fields: ``generate_cors`` of each half (CorsConfig(density_threshold
   =0.2), 128^3 grid, its sub-stages' times), its hits checked on the mesh
   and each back hit behind its front hit, ``build_negatives`` (20 loops),
   ``train_pose`` (200 steps, the round-5 augmentation, the loss must
   fall), and the serving stages on the trained feature head and CNN, each
   stage's wall time and launches (every kernel of a stage must launch);
   then K1 and K2 against their plain versions at the cors stage's shapes,
   FPS in CUDA graphs against its launch sequence, and ``generate_cors``
   through K1 / K2 against the same call through their plain versions;
10. the port's command-line program (``CLI``) in a temporary root, through
   ``cli.main`` in this process: train-nerf (K4), generate-cors (K1, K2),
   train-pose and gen-feat (K1, K2) of each half, then poses-est (K3),
   inference --dataset tless (K3, K2 through ADD-S), rel-poses,
   choose-image, icp (K2), verify (K2), check and, where Pillow imports,
   video and the image-folder banks; each command's wall time and
   launches; ``check`` once more through ``python -m`` in a subprocess; a
   train-nerf stopped after its step-200 checkpoint and resumed with
   ``--cont`` must equal the straight run bit for bit, and train-pose on a
   copy of the experiment must write bit-identical checkpoints;
11. the CLI's SurfEmb, full-frame and mesh-scene paths (``SURF``): each
   half's train-nerf (K4), generate-cors (K1, K2), train-pose and gen-feat
   on the --synthetic-mesh scene, then half 0's poses-est and inference
   --use-surf-eval at InferenceConfig() (K2 in the refiner; per image the
   seconds of the distribution, P3P with pruning, scoring and refinement,
   the peak device memory, the best score, ADD-S), inference
   --use-surf-eval again (bit-identical poses), poses-est by argmax-PnP
   (K3), and inference --full-frames on raw 640 x 480 frames rendered by
   the port's rasterizer into a BOP tree (K3, K2); K2 at the refiner's
   launch shapes and K3 at a full frame's against their plain versions,
   timed; the cdf at 5,476 x 80,000 against an f64 running sum.

Output: one JSON line with the kernels, then the device JSON as the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

PKG = "imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch"
# file:line of each TPU kernel (the Pallas kernel function) this port replaces
TPU_KERNELS = {
    "density": "imagesequenceregistrationfor6dposeestimationlabeling_tpu/ops/field_kernel.py:304",
    "nn_min": "imagesequenceregistrationfor6dposeestimationlabeling_tpu/ops/pallas_kernels.py:134",
    "corr_argmax": "imagesequenceregistrationfor6dposeestimationlabeling_tpu/ops/pallas_kernels.py:41",
    "bundle_loss": "imagesequenceregistrationfor6dposeestimationlabeling_tpu/ops/field_kernel.py:701",
    "field_color_fwd": "imagesequenceregistrationfor6dposeestimationlabeling_tpu/ops/field_kernel.py:248",
    "field_color_bwd": "imagesequenceregistrationfor6dposeestimationlabeling_tpu/ops/field_kernel.py:481",
}
SOURCES = {
    "density": f"{PKG}/ops/csrc/density.cu",
    "nn_min": f"{PKG}/ops/csrc/nn_min.cu",
    "corr_argmax": f"{PKG}/ops/csrc/corr_argmax.cu",
    "bundle_loss": f"{PKG}/ops/csrc/bundle_loss.cu",
    "field_color_fwd": f"{PKG}/ops/csrc/field_color.cu",
    "field_color_bwd": f"{PKG}/ops/csrc/field_color.cu",
}
# the device functions of each kernel in the built extension (K4 and K6 are
# two each: the tile kernel and the weight-grad contraction kernel they share)
DEVICE_FUNCTIONS = {
    "density": ("density_kernel",),
    "nn_min": ("nn_min_kernel", "nn_min_merge_kernel"),
    "corr_argmax": ("corr_argmax_kernel", "corr_argmax_merge_kernel"),
    "bundle_loss": ("bundle_loss_kernel", "dw_kernel"),
    "field_color_fwd": ("field_color_fwd_kernel",),
    "field_color_bwd": ("field_color_bwd_kernel", "dw_kernel"),
}
# their products must run on the tensor cores
TENSOR_CORE_KERNELS = ("density", "bundle_loss", "field_color_fwd", "field_color_bwd")
# one H100 SXM (NVIDIA's data sheet, dense): device memory bytes/s, bf16
# tensor-core and f32 FLOP/s (an FMA counted as two), for the bounds; and
# at its 1.98 GHz boost clock on 132 SMs: unfused f32 operations a second
# (one a lane a clock, 128 lanes an SM) and special-function results (an
# exponential: 16 an SM a clock)
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
F32_LANE_OPS, SFU_OPS = 132 * 128 * 1.98e9, 132 * 16 * 1.98e9
# K4: loss sums (relative), EA weights (absolute), each grad block scaled by
# its max |g|.  K5: dens and rgb (absolute), the share of bf16 residual
# values that are not bit-equal, and each head against the plain head
# applied to K5's own rounded input (dens: h1, rgb: c1; f32 sums in another
# order), a head moving by more than 1e-4 only where that input differs
# (the tensor cores' sum order flips bf16 roundings); K6 as K4's grads
# K1: max abs, and the share of densities off by more than 1e-4 (the tensor
# cores sum each k-16 step's products in another order than the plain
# version's f32 chain, which flips more bf16 roundings of h1: 1.05e-3 at
# 128^3 on the H100, 2e-3 allowed).  The chunked step's fine grads against a
# plain step that resamples its own fine depths: flipped bf16 roundings of
# the coarse densities move the depths (3.58e-2 of each grad's max at init
# on the H100, 1.27e-1 after 100 steps); the replayed depths hold the rest
# to grad_scaled.  K2: bit-identical.  K3: conf, max abs (its f64 running
# sum reads 1.907e-06 at every timed shape on the H100; an f32 running sum
# read 1.335e-05 at 45,000 x 80,000)
TOL = {"density": 2e-2, "density_share": 2e-3, "nn_min": 0.0, "corr_argmax": 5e-6, "loss_rel": 1e-3, "w_abs": 1e-3,
       "grad_scaled": 3e-2, "color_abs": 2e-2, "res_share": 1e-2, "head_own": 1e-5, "fine_own_depths": 1e-1}
# the bench's serving settings (bench.py run_pipeline, full-size branch)
SERVE = {"n_views": 8, "image_size": 224, "grid_res": 128, "n_infer": 8, "n_points": 20000,
         "sample_loops": 3, "icp_iters": 20}
FIELD = {"act_dtype": "bfloat16"}  # FieldConfig defaults otherwise: 60 harmonics, 256 hidden
SERVE_KERNELS = ("density", "nn_min", "corr_argmax")
# the bench's NeRF settings (bench.py:239-254): 3 cams x 400 rays per half and
# step, warmup min(300, 800 // 3), seed 1
TRAIN = {"n_views": 8, "image_size": 224, "n_rays": 400, "batch": 3, "warmup": 266, "seed": 1}
# the reference's large-batch schedule (experiments/nerf_schedule.py:40) for
# one half: 6 cams x 800 rays a step (4,800 rays: chunks of 4,096 and 704),
# warmup min(300, steps // 3), seed 1; the resume check's step count
CHUNKED = {"n_views": 8, "image_size": 224, "n_rays": 800, "batch": 6, "seed": 1, "resume_steps": 10}
# K5 / K6 at a chunk's shapes, (rays, points): a full chunk and the ragged
# last chunk of a 4,800-ray step, each of the coarse and the fine pass
FIELD_COLOR_SHAPES = [(4096, 64), (4096, 320), (704, 64), (704, 320)]
# K2 beside the serve's launches: two 50,000-point clouds, masked
NN_SHAPE = (50_000, 50_000)
# K3 (queries, keys, width) beside the serve's own launch: one 224^2 crop at
# stride 3 (5,625 queries) and a batch of 8 crops, against a real object's
# FeatConfig.n_points = 80,000 keys
CORR_SHAPES = [(5_625, 80_000, 12), (45_000, 80_000, 12)]


# the bench's chain after NeRF training (bench.py run_pipeline, full-size
# branch): generate_cors with CorsConfig(density_threshold=0.2) for each
# half, 20 loops of negatives at threshold 0.2 (seed 0), 200 descriptor
# steps (seed 1, warmup 100) with the round-5 augmentation (jitter x 2,
# distractors p 0.5: the batch's rolled views), then the serving stages on
# the trained field and CNN; NeRF training is TRAIN's at 800 steps
PIPELINE = {"nerf_steps": 800, "pose_steps": 200, "neg_loops": 20, "neg_threshold": 0.2, "neg_seed": 0,
            "pose_seed": 1, "cors": {"density_threshold": 0.2}, "pose": {"warmup_steps": 100},
            "aug": {"crop_res": 224, "min_mask_sum": 10.0, "p_distractor": 0.5, "scale_jitter": 0.15,
                    "trans_frac": 0.2}}
# the command-line program's phase: the synthetic scene's 8 views a half, a
# full-width bf16 field (the field kernels), 400 NeRF steps a half (the CLI's
# checkpoint every 100), 100 descriptor steps, the CLI's defaults otherwise;
# the resume check stops its run after the step-200 checkpoint
CLI = {"views": 8, "nerf_steps": 400, "pose_steps": 100, "resume_at": 200, "flags": []}
# the CLI's SurfEmb, full-frame and mesh-scene paths (``surf_path``): the
# --synthetic-mesh scene's 8 views a half (1,280 triangles), the CLI phase's
# depth (400 NeRF steps a half, 100 descriptor steps), the surf-eval commands
# at InferenceConfig() (224 px crops: 5,476 cells, 10,000 hypotheses, 1,000
# scored, 50 BFGS steps), 8 raw 640 x 480 frames of the other half for
# --full-frames, rendered at the scene's focal length for 224 px crops with
# the object shifted off-centre (scene units); the cdf checked at a crop's
# cells x FeatConfig.n_points keys, no draw of the port's cdf may move; the
# bake gives the mesh scene ~6,000 keys, so one image also runs, and K2 is
# also checked, at FeatConfig.n_points = 80,000 keys ("full_keys")
SURF = {"views": 8, "nerf_steps": 400, "pose_steps": 100, "frames": 8, "frame_size": (640, 480), "crop": 224,
        "shift": (0.9, -0.6), "cdf_shape": (5_476, 80_000), "cdf_moved_max": 0.0, "full_keys": 80_000, "flags": []}


def log(msg: str):
    print(msg, flush=True)


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, reps: int = 3):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events; returns (ms, result of the warm-up)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def graph_ms(fn, reps: int = 20):
    """Mean device milliseconds of the launches ``fn()`` makes: captured
    once in a CUDA graph after one warm-up call, the graph replayed
    ``reps`` times between CUDA events, so that no host time falls between
    the launches; returns (ms, result of the warm-up)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def sass_phase(ext_path: str) -> dict:
    """HMMA / HGMMA instructions per kernel in the built extension's SASS."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(cuda_home, "bin", "cuobjdump")
    sass = subprocess.run([tool if os.path.exists(tool) else "cuobjdump", "-sass", ext_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    per_function, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            per_function[current] = 0
        elif current is not None and ("HMMA" in line or "HGMMA" in line):
            per_function[current] += 1
    counts = {}
    for name, functions in DEVICE_FUNCTIONS.items():
        counts[name] = {}
        for fn in functions:
            hits = [n for k, n in per_function.items() if fn in k]
            if len(hits) != 1:
                raise AssertionError(f"SASS: expected one device function named like {fn}, found {len(hits)}")
            counts[name][fn] = hits[0]
    log("tensor-core instructions (HMMA / HGMMA) in SASS: " + json.dumps(counts))
    for name in TENSOR_CORE_KERNELS:
        if not all(counts[name].values()):
            raise AssertionError(f"{name}: a kernel of it has no tensor-core instruction in its SASS")
    return counts


def bound(n_bytes: float, n_ops: float, rate: float):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    t_bytes, t_ops = 1e3 * n_bytes / HBM_BPS, 1e3 * n_ops / rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nn_bound(n: int, m: int, masked: bool = False):
    """K2's bound: points (and mask) read, dist and index written; 3
    differences, 3 products, 2 sums and a compare a pair, unfused f32, one
    lane-clock each."""
    return bound(12 * (n + m) + 4 * m * masked + 8 * n, 9 * n * m, F32_LANE_OPS)


def corr_bound(n: int, m: int, e: int):
    """K3's bound: queries and keys read, index and conf written; the
    logits' e FFMAs a pair (2 e FLOP at the f32 peak) or one exponential a
    pair on the special-function unit, whichever takes longer."""
    b = bound(4 * e * (n + m) + 8 * n, 2 * n * m * e, F32_FLOPS)
    t_exp = 1e3 * n * m / SFU_OPS
    return (t_exp, "operations") if t_exp > b[0] else b


def field_flops(E: int, nh: int) -> dict:
    """bf16 product FLOPs a point of the field kernels, by shapes: the
    forward (trunk and colour products), the backward (the two cotangent
    products and the four weight-grad contractions), and a ray's direction
    part (forward) or its grads (backward)."""
    return {"fwd": 4 * E * nh + 4 * nh * nh, "bwd": 4 * E * nh + 8 * nh * nh, "ray": 4 * E * nh}


def weight_bytes(E: int, nh: int) -> int:
    """f32 bytes of the 13 weight blocks (or of their grads)."""
    return 4 * (4 * E * nh + 2 * nh * nh + 7 * nh + 4)


def result(err, ms, plain_ms, bound_pair, library_ms=None) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_pair[0], "bound_by": bound_pair[1],
            "library_ms": library_ms}


def density_phase(dev, seed: int):
    """K1 against its plain version at the bake's shape."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel

    # K1: the 128^3 density grid of a randomly initialised full-width field
    # (direct embedding, 60 harmonics, 256 hidden), so that both embedding
    # halves and every trunk unit reach the compared output.  The density
    # bias goes to 0: the init's -1.5 leaves every density near 1e-5, in
    # softplus's far tail, where a wrong trunk barely shows
    cfg = FieldConfig(**FIELD)
    field = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(seed))
    torch.nn.init.zeros_(field.density_layer.bias)
    field = field.to(dev)
    t = torch.linspace(-1.0, 1.0, 128, device=dev)
    pts = torch.stack(torch.meshgrid(t, t, t, indexing="ij"), -1).reshape(-1, 3).contiguous()
    w = field_kernel.density_weights(field)
    ladder, beta = field_kernel.ladder_of(cfg), cfg.softplus_beta
    ms, got = cuda_ms(lambda: field_kernel.density_cuda(pts, w, ladder, beta))
    plain_ms, want = cuda_ms(lambda: torch.cat([field_kernel.density_plain(p, w, ladder, beta)
                                                for p in torch.split(pts, 262144)]), reps=1)
    again = field_kernel.density_cuda(pts, w, ladder, beta)
    embed_ms, _ = cuda_ms(lambda: field_kernel.density_embed_cuda(pts, w, ladder, beta))
    err = (got - want).abs()
    frac = float((err > 1e-4).float().mean())
    same = bool(torch.equal(got, again))
    n, E, nh = pts.shape[0], w[1].shape[0], w[3].shape[0]
    b = bound(n * 16 + 4 * (2 * E * nh + nh * nh + 3 * nh + 1), n * (4 * E * nh + 2 * nh * nh), BF16_FLOPS)
    log(f"K1 density  N={n} H=60 hidden=256, random field (density min {float(want.min()):.4f} "
        f"mean {float(want.mean()):.4f} max {float(want.max()):.4f}): max_abs_err {float(err.max()):.3e} "
        f"(tol {TOL['density']}), share > 1e-4: {frac:.2e} (tol {TOL['density_share']}); second launch "
        f"bit-identical: {same}; kernel {ms:.3f} ms "
        f"(its sin / cos embedding alone {embed_ms:.3f} ms), plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]})")
    if not (float(err.max()) <= TOL["density"] and frac < TOL["density_share"] and float(want.std()) > 1e-3 and same):
        raise AssertionError("K1 disagrees with its plain version")
    return result(float(err.max()), ms, plain_ms, b)


def launch_counts():
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel, point_kernels

    return {
        "density": field_kernel.density_cuda.launches,
        "nn_min": point_kernels.nn_min_cuda.launches,
        "corr_argmax": point_kernels.correspondence_argmax_cuda.launches,
        "bundle_loss": field_kernel.bundle_loss_cuda.launches,
        "field_color_fwd": field_kernel.field_color_fwd_cuda.launches,
        "field_color_bwd": field_kernel.field_color_bwd_cuda.launches,
    }


def reset_launch_counts():
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel, point_kernels

    field_kernel.density_cuda.launches = 0
    point_kernels.nn_min_cuda.launches = 0
    point_kernels.correspondence_argmax_cuda.launches = 0
    field_kernel.bundle_loss_cuda.launches = 0
    field_kernel.field_color_fwd_cuda.launches = 0
    field_kernel.field_color_bwd_cuda.launches = 0


def profile_run(run, path: str, what: str):
    """``run()`` once more under torch.profiler: device time by kernel to
    ``path``, and the card's busy share of the wall seconds ``run`` returns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = run()
    events = prof.key_averages()
    # device-side events only (kernels, copies): CPU ops repeat their kernels' time
    busy_ms = sum(e.self_device_time_total for e in events if e.device_type != DeviceType.CPU) / 1e3
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"profiled {what}: device busy {busy_ms:.1f} ms of {1e3 * wall_s:.1f} ms "
        f"({100 * busy_ms / (1e3 * wall_s):.1f}%), kernel table in {path}")


def train_inputs(dev, seed: int):
    """The two synthetic halves at the bench's NeRF size, stacked on a
    leading half axis, on the card."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic

    halves = [synthetic.make_scene(TRAIN["n_views"], TRAIN["image_size"],
                                   torch.Generator(device=dev).manual_seed(seed + uh), device=dev) for uh in (0, 1)]
    return {f: torch.stack([getattr(h, f) for h in halves]) for f in ("images", "sils", "R_bop", "t_bop", "K")}


def step_rays(data, dev, seed: int, render):
    """One train step's rays and targets for both halves: the first batch
    of each half's schedule, draws from per-half generators."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.grid_sample import (
        sample_images_at_mc_locs,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    B, n, S = TRAIN["batch"], TRAIN["n_rays"], TRAIN["image_size"]
    H, N = 2, B * n
    min_d, max_d = nerf_trainer.depth_bounds(data["t_bop"].reshape(-1, 3).cpu().numpy())
    cam = cam_lib.camera_from_bop(data["R_bop"][:, :B], data["t_bop"][:, :B], data["K"][:, :B], S)
    gens = [torch.Generator(device=dev).manual_seed(seed + h) for h in range(H)]
    xys, u, u_pdf = nerf_trainer.draw(gens, B, render, dev)
    bundle = cam_lib.monte_carlo_rays(cam, n, render.n_pts_coarse, min_d, max_d, xys=xys, u=u)
    flat_xy = xys.reshape(H * B, n, 2)
    col = sample_images_at_mc_locs(data["images"][:, :B].reshape(H * B, S, S, 3), flat_xy).reshape(H, N, 3)
    sil = sample_images_at_mc_locs(data["sils"][:, :B].reshape(H * B, S, S, 1), flat_xy).reshape(H, N, 1)
    d = bundle.directions.reshape(H, N, 3)
    tgt = torch.cat([col, sil, torch.ones_like(sil), torch.zeros_like(col)], -1).contiguous()
    return dict(o=bundle.origins.reshape(H, N, 3), d=d, lengths=bundle.lengths.reshape(H, N, -1), u_pdf=u_pdf,
                dn=(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)).contiguous(), tgt=tgt,
                cam=cam, min_d=min_d, max_d=max_d, draws=(xys, u, u_pdf))


def compare_bundle(tag: str, got, want, again):
    """K4's outputs against its plain version's, and a second launch's."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel

    (gk, lk, wk), (gp, lp, wp) = got, want
    loss_rel = float(((lk - lp).abs() / lp.abs().clamp_min(1e-12)).max())
    w_err = float((wk - wp).abs().max()) if wk is not None else 0.0
    errs = {name: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)
            for name, a, b in zip(field_kernel.LOSS_BLOCKS, gk, gp)}
    worst = max(errs, key=errs.get)
    same = (all(torch.equal(a, b) for a, b in zip(gk, again[0])) and torch.equal(lk, again[1])
            and (wk is None or torch.equal(wk, again[2])))
    log(f"  {tag}: ce/se kernel {lk.flatten().tolist()} plain {lp.flatten().tolist()} (max rel err {loss_rel:.2e}); "
        f"w max abs err {w_err:.2e}; grad max err / block max |g| {errs[worst]:.2e} ({worst}); "
        f"second launch bit-identical: {same}")
    if not (loss_rel <= TOL["loss_rel"] and w_err <= TOL["w_abs"] and errs[worst] <= TOL["grad_scaled"] and same):
        raise AssertionError(f"K4 disagrees with its plain version ({tag})")
    return errs[worst]


def bundle_loss_phase(dev, seed: int):
    """K4 against its plain version at the train step's own shapes: both
    halves in one launch, the coarse pass (64 points, with the EA weights)
    and the fine pass (320 points, resampled from the kernel's weights),
    full-width random fields (density bias 0), both embeddings, targets
    from the synthetic scene.  Returns the worst scaled grad error and the
    times and bound of the direct embedding's two passes (one step)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        FieldConfig,
        NerfTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch

    render = RenderConfig(n_rays_per_image=TRAIN["n_rays"])
    train = NerfTrainConfig()
    r = step_rays(train_inputs(dev, seed), dev, seed, render)
    o, d, lengths, N = r["o"], r["d"], r["lengths"], r["d"].shape[1]
    worst, step_ms, step_bytes, step_ops = 0.0, {}, 0, 0
    for embed in ("direct", "grouped"):
        cfg = FieldConfig(**FIELD, embed_method=embed)
        fields = []
        for h in range(2):
            f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(seed + 10 + h))
            torch.nn.init.zeros_(f.density_layer.bias)
            fields.append(f.to(dev))
        weights = tuple(torch.stack(b) for b in zip(*(fk.loss_weights(f) for f in fields)))
        fm = torch.from_numpy(fk.fmat_of(cfg)).to(dev)
        rest = (r["dn"], r["tgt"], fm, weights, fk.ladder_of(cfg), cfg.softplus_beta, train.huber_scaling,
                train.loss_scale / N)
        z = {"coarse": lengths}
        for tag in ("coarse", "fine"):
            pts = (o[:, :, None] + d[:, :, None] * z[tag][..., None]).contiguous()
            want_w = tag == "coarse"
            ms, got = cuda_ms(lambda: fk.bundle_loss_cuda(pts, *rest, want_w))
            plain_ms, want = cuda_ms(lambda: fk.bundle_loss_plain(pts, *rest, want_w), reps=1)
            again = fk.bundle_loss_cuda(pts, *rest, want_w)
            # the function's work: the field forward once, the backward's
            # products and contractions (the kernel's recompute of the
            # forward is its own choice and not counted)
            H, E, nh = pts.shape[0], weights[0].shape[1], weights[2].shape[-1]
            n_pts, ff = pts.shape[0] * N * pts.shape[2], field_flops(E, nh)
            n_bytes = n_pts * (12 + 4 * want_w) + H * N * (12 + 32) + 2 * H * weight_bytes(E, nh)
            n_ops = n_pts * (ff["fwd"] + ff["bwd"]) + H * N * 2 * ff["ray"]
            b = bound(n_bytes, n_ops, BF16_FLOPS)
            log(f"K4 bundle_loss {embed} {tag}: 2 halves x {N} rays x {pts.shape[2]} points; kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}, {n_ops / 1e12:.3f} TFLOP)")
            if embed == "direct":
                step_bytes, step_ops = step_bytes + n_bytes, step_ops + n_ops
            worst = max(worst, compare_bundle(f"{embed} {tag}", got, want, again))
            step_ms[(embed, tag)] = (ms, plain_ms)
            if want_w:
                z["fine"] = raymarch.importance_resample(lengths, got[2], render.n_pts_fine, u=r["u_pdf"])
            del got, want, again
    ms = step_ms[("direct", "coarse")][0] + step_ms[("direct", "fine")][0]
    plain_ms = step_ms[("direct", "coarse")][1] + step_ms[("direct", "fine")][1]
    b = bound(step_bytes, step_ops, BF16_FLOPS)
    log(f"K4 per train step (direct, coarse + fine): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms "
        f"({b[1]}); worst grad error / block max |g| over all passes {worst:.2e} (tol {TOL['grad_scaled']})")
    return result(worst, ms, plain_ms, b)


def kernel_step_vs_plain_step(states, data, dev, seed: int, render, train, tag: str, whole_step: bool):
    """One train step with K4 and one with its plain version, from copies
    of the same states, on the same batch and draws.  The coarse fields'
    grads must agree.  The fine pass resamples its depths from the coarse
    weights, and the inverse cdf magnifies their differences where a cdf
    segment is thin, which is rare at a fresh init and common on a trained
    surface: ``whole_step`` holds the loss, the fine grads and the updated
    params to the bars as well; otherwise they are reported."""
    import copy

    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    r = step_rays(data, dev, seed, render)
    B = TRAIN["batch"]
    args = (r["cam"], data["images"][:, :B].contiguous(), data["sils"][:, :B].contiguous(),
            nerf_trainer.make_optimizer(train), render, train, r["min_d"], r["max_d"])
    a = [copy.deepcopy(st) for st in states]
    b = [copy.deepcopy(st) for st in states]
    lr = nerf_trainer.make_optimizer(train).learning_rate(states[0].opt.count)
    a, loss_a, _ = nerf_trainer.train_step(a, *args, draws=r["draws"])
    kernel_op = fk.bundle_loss_op
    fk.bundle_loss_op = fk.bundle_loss_plain     # this step only: the plain version on the card
    try:
        b, loss_b, _ = nerf_trainer.train_step(b, *args, draws=r["draws"])
    finally:
        fk.bundle_loss_op = kernel_op
    sync(dev)
    loss_rel = float(((loss_a - loss_b).abs() / loss_b.abs()).max())
    err = {"coarse": 0.0, "fine": 0.0}
    param_err = 0.0
    for sa, sb in zip(a, b):
        for which in err:
            for (_, pa), (_, pb) in zip(nerf_trainer.trainable(getattr(sa, which)),
                                        nerf_trainer.trainable(getattr(sb, which))):
                g = float((pa.grad - pb.grad).abs().max()) / max(float(pb.grad.abs().max()), 1e-3)
                err[which] = max(err[which], g)
                param_err = max(param_err, float((pa.detach() - pb.detach()).abs().max()))
    # what the fine pass saw: depths resampled from each version's coarse weights
    cfg = FieldConfig(**FIELD)
    pts = (r["o"][:, :, None] + r["d"][:, :, None] * r["lengths"][..., None]).contiguous()
    weights = tuple(torch.stack(x) for x in zip(*(fk.loss_weights(st.coarse) for st in states)))
    fm = torch.from_numpy(fk.fmat_of(cfg)).to(dev)
    rest = (r["dn"], r["tgt"], fm, weights, fk.ladder_of(cfg), cfg.softplus_beta, train.huber_scaling, 1.0, True)
    z = [raymarch.importance_resample(r["lengths"], op(pts, *rest)[2], render.n_pts_fine, u=r["u_pdf"])
         for op in (fk.bundle_loss_cuda, fk.bundle_loss_plain)]
    dz = (z[0] - z[1]).abs()
    log(f"train step at the {tag} state, K4 vs plain from the same state and draws: loss {loss_a.tolist()} vs "
        f"{loss_b.tolist()} (max rel err {loss_rel:.2e}); grad max err / tensor max |g|: coarse fields "
        f"{err['coarse']:.2e}, fine fields {err['fine']:.2e}; params after the step max abs diff {param_err:.2e} "
        f"(rate {lr:.2e}); fine depths resampled from the two versions' coarse weights: max diff "
        f"{float(dz.max()):.2e}, share > 1e-4: {float((dz > 1e-4).float().mean()):.2e}")
    ok = err["coarse"] <= TOL["grad_scaled"]
    if whole_step:
        ok = ok and loss_rel <= TOL["loss_rel"] and err["fine"] <= TOL["grad_scaled"] and param_err <= 2.01 * lr
    if not ok:
        raise AssertionError(f"the train step through K4 disagrees with the step through its plain version ({tag})")


def train_path(dev, seed: int, n_steps: int, profile: str | None = None):
    """train_nerf_fused on both synthetic halves at the bench's settings;
    K4's launches are counted over exactly the measured run."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        FieldConfig,
        NerfTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    data = train_inputs(dev, seed)
    cfg = FieldConfig(**FIELD)
    render = RenderConfig(n_rays_per_image=TRAIN["n_rays"])
    train = NerfTrainConfig(warmup_steps=TRAIN["warmup"], batch_size=TRAIN["batch"])
    args = (data["images"], data["sils"], data["R_bop"], data["t_bop"], data["K"], cfg, render, train)

    def run(steps: int):
        sync(dev)
        t0 = time.perf_counter()
        out = nerf_trainer.train_nerf_fused(*args, n_steps=steps, seed=TRAIN["seed"], device=dev)
        sync(dev)
        return out, time.perf_counter() - t0

    _, cold_s = run(1)
    reset_launch_counts()
    (states, losses), wall_s = run(n_steps)
    counts = launch_counts()
    first, last = losses[:, :10].mean(1), losses[:, -10:].mean(1)
    log(f"NeRF training, 2 halves x {n_steps} steps ({TRAIN['batch']} cams x {TRAIN['n_rays']} rays, "
        f"{render.n_pts_coarse} + {render.n_pts_coarse + render.n_pts_fine} points): cold first step {1e3 * cold_s:.1f} ms; warm {1e3 * wall_s / n_steps:.2f} ms per step "
        f"({wall_s:.2f} s); bundle_loss launches {counts['bundle_loss']}; mean loss of the first 10 steps "
        f"{np.round(first, 3).tolist()}, of the last 10 {np.round(last, 3).tolist()}")
    if counts["bundle_loss"] != 2 * n_steps:
        raise AssertionError(f"expected 2 bundle_loss launches per step, counted {counts['bundle_loss']}")
    if not (np.isfinite(losses).all() and (last < first).all()):
        raise AssertionError("training losses are not finite or do not fall")
    fresh = [nerf_trainer.init_state(cfg, train, torch.Generator().manual_seed(TRAIN["seed"] + h), device=dev)
             for h in range(2)]
    kernel_step_vs_plain_step(fresh, data, dev, seed + 100, render, train, "initial", whole_step=True)
    kernel_step_vs_plain_step(states, data, dev, seed + 100, render, train, f"step-{n_steps}", whole_step=False)
    if profile:
        profile_run(lambda: run(20)[1], profile + ".train.txt", "20 training steps")
    return counts, wall_s, states


def chunk_rays(dev, R: int, P: int, seed: int):
    """One half's rays through the object's box from a sphere of radius 4:
    points (1, R, P, 3) at sorted depths in [2, 6], unit dirs (1, R, 3)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randn((1, R, 3), generator=g, device=dev)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.1 * torch.randn((1, R, 3), generator=g, device=dev)
    lengths = torch.sort(2.0 + 4.0 * torch.rand((1, R, P), generator=g, device=dev), -1).values
    pts = (o[:, :, None] + d[:, :, None] * lengths[..., None]).contiguous()
    return pts, (d / d.norm(dim=-1, keepdim=True)).contiguous()


def field_color_phase(dev, seed: int):
    """K5 and K6 against their plain versions at a chunk's shapes
    (``FIELD_COLOR_SHAPES``, one half), full-width random fields (density
    bias 0), both embeddings.  K6 runs on K5's own records and outputs with
    random cotangents.  Returns {name: result}, the
    times summed over the four shapes of the direct embedding: one
    4,800-ray chunked step's launches (2 chunks x 2 passes)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk

    worst = {"field_color_fwd": 0.0, "field_color_bwd": 0.0}
    step_ms = {"field_color_fwd": [0.0, 0.0], "field_color_bwd": [0.0, 0.0]}
    work = {"field_color_fwd": [0, 0], "field_color_bwd": [0, 0]}  # bytes, operations of one chunked step
    chunk_ms = {}  # (rays, name) -> kernel ms of the chunk's two passes, direct embedding
    for embed in ("direct", "grouped"):
        cfg = FieldConfig(**FIELD, embed_method=embed)
        field = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(seed + 20))
        torch.nn.init.zeros_(field.density_layer.bias)
        weights = tuple(b[None] for b in fk.loss_weights(field.to(dev)))
        fm = torch.from_numpy(fk.fmat_of(cfg)).to(dev)
        ladder, beta = fk.ladder_of(cfg), cfg.softplus_beta
        for R, P in FIELD_COLOR_SHAPES:
            pts, dn = chunk_rays(dev, R, P, seed + R + P)
            fwd = (pts, dn, fm, weights, ladder, beta)
            ms, (dk, rk, res_k) = cuda_ms(lambda: fk.field_color_fwd_cuda(*fwd), reps=10)
            plain_ms, (dp, rp, res_p) = cuda_ms(lambda: fk.field_color_fwd_plain(*fwd), reps=1)
            dk2, rk2, res_k2 = fk.field_color_fwd_cuda(*fwd)
            err = max(float((dk - dp).abs().max()), float((rk - rp).abs().max()))
            res_share = max(float((res_k[k] != res_p[k]).float().mean()) for k in fk.RESIDUALS)
            # each head reads one rounded residual (dens h1, rgb c1): from
            # K5's own it must agree to f32 sums, and move by more than 1e-4
            # only where that residual differs from the plain version's
            own_heads = fk.field_color_heads(res_k, weights, beta)
            heads = {"dens": (dk, dp, "h1", own_heads[0]), "rgb": (rk, rp, "c1", own_heads[1])}
            off, flip, own, unexplained = {}, {}, {}, 0
            for name, (got, want, src, from_own) in heads.items():
                moved = ((got - want).abs() > 1e-4).any(-1)
                flipped = (res_k[src] != res_p[src]).any(-1)
                off[name], flip[src] = float(moved.float().mean()), float(flipped.float().mean())
                own[name] = float((got - from_own).abs().max())
                unexplained += int((moved & ~flipped).sum())
            del heads, own_heads, moved, flipped, from_own
            same = (torch.equal(dk, dk2) and torch.equal(rk, rk2)
                    and all(torch.equal(res_k[k], res_k2[k]) for k in fk.RESIDUALS))
            del dp, rp, res_p, dk2, rk2, res_k2
            log(f"K5 field_color_fwd {embed} {R} rays x {P} points (dens std {float(dk.std()):.3f}): dens / rgb max abs "
                f"err {err:.3e} (tol {TOL['color_abs']}); residuals not bit-equal {res_share:.2e} (tol "
                f"{TOL['res_share']}); points off > 1e-4: dens {off['dens']:.2e}, rgb {off['rgb']:.2e}; points whose "
                f"h1 / c1 is not bit-equal {flip['h1']:.2e} / {flip['c1']:.2e}; off where the residual is equal: "
                f"{unexplained}; dens / rgb from K5's own h1 / c1 max abs err {own['dens']:.2e} / {own['rgb']:.2e} "
                f"(tol {TOL['head_own']}); second launch bit-identical: {same}; kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms")
            if not (err <= TOL["color_abs"] and res_share <= TOL["res_share"] and same
                    and max(own.values()) <= TOL["head_own"] and unexplained == 0 and float(dk.std()) > 1e-3):
                raise AssertionError(f"K5 disagrees with its plain version ({embed}, {R} x {P})")
            worst["field_color_fwd"] = max(worst["field_color_fwd"], err)
            g = torch.Generator(device=dev).manual_seed(seed + R)
            bwd = (dn, fm, weights, res_k, dk, rk, torch.randn(dk.shape, generator=g, device=dev),
                   torch.randn(rk.shape, generator=g, device=dev), ladder, beta)
            bms, gk = cuda_ms(lambda: fk.field_color_bwd_cuda(*bwd), reps=10)
            plain_bms, gp = cuda_ms(lambda: fk.field_color_bwd_plain(*bwd), reps=1)
            gk2 = fk.field_color_bwd_cuda(*bwd)
            errs = {name: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)
                    for name, a, b in zip(fk.LOSS_BLOCKS, gk, gp)}
            bad = max(errs, key=errs.get)
            same = all(torch.equal(a, b) for a, b in zip(gk, gk2))
            log(f"K6 field_color_bwd {embed} {R} rays x {P} points: grad max err / block max |g| {errs[bad]:.2e} ({bad}, "
                f"tol {TOL['grad_scaled']}); second launch bit-identical: {same}; kernel {bms:.3f} ms, "
                f"plain {plain_bms:.3f} ms")
            if not (errs[bad] <= TOL["grad_scaled"] and same):
                raise AssertionError(f"K6 disagrees with its plain version ({embed}, {R} x {P})")
            worst["field_color_bwd"] = max(worst["field_color_bwd"], errs[bad])
            if embed == "direct":
                for name, pair in (("field_color_fwd", (ms, plain_ms)), ("field_color_bwd", (bms, plain_bms))):
                    step_ms[name] = [a + b for a, b in zip(step_ms[name], pair)]
                    chunk_ms[(R, name)] = chunk_ms.get((R, name), 0.0) + pair[0]
                E, nh = weights[0].shape[1], weights[2].shape[-1]
                ff = field_flops(E, nh)
                # a point's residual row of the record (es | ec, E padded to
                # Ep, then h1 | h2 | c1) and its cotangents dh1 | dh2 | dc1
                row, cot = 2 * (2 * fk._pad_rows(E) + 3 * 256), 2 * 3 * 256
                # K5 reads points and writes dens, rgb and the residual row;
                # K6 reads the row, writes and reads the cotangents and reads
                # dens, rgb and their cotangents
                fwd_work = (R * P * (12 + 16 + row) + R * 12 + weight_bytes(E, nh), R * P * ff["fwd"] + R * ff["ray"])
                bwd_work = (R * P * (row + 2 * cot + 32) + R * 12 + 2 * weight_bytes(E, nh),
                            R * P * ff["bwd"] + R * ff["ray"])
                for name, pair in (("field_color_fwd", fwd_work), ("field_color_bwd", bwd_work)):
                    work[name] = [a + b for a, b in zip(work[name], pair)]
            del dk, rk, res_k, bwd, gk, gp, gk2
    bounds = {name: bound(*work[name], BF16_FLOPS) for name in work}
    for R in sorted({r for r, _ in FIELD_COLOR_SHAPES}, reverse=True):
        log(f"K5 / K6 per {R}-ray chunk (direct, 64 + 320 points): K5 {chunk_ms[(R, 'field_color_fwd')]:.3f} ms, "
            f"K6 {chunk_ms[(R, 'field_color_bwd')]:.3f} ms")
    log(f"K5 / K6 per chunked step (direct, 4,096 + 704 rays x (64 + 320) points): K5 kernel "
        f"{step_ms['field_color_fwd'][0]:.3f} ms, plain "
        f"{step_ms['field_color_fwd'][1]:.3f} ms, bound {bounds['field_color_fwd'][0]:.3f} ms "
        f"({bounds['field_color_fwd'][1]}); K6 kernel {step_ms['field_color_bwd'][0]:.3f} ms, plain "
        f"{step_ms['field_color_bwd'][1]:.3f} ms, bound {bounds['field_color_bwd'][0]:.3f} ms "
        f"({bounds['field_color_bwd'][1]})")
    return {name: result(worst[name], *step_ms[name], bounds[name]) for name in worst}


@contextlib.contextmanager
def plain_field_color(on: bool = True):
    """While open (and ``on``), ``FieldColor`` runs K5 / K6's plain
    versions, on the card too."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk

    ops = fk.field_color_fwd_op, fk.field_color_bwd_op
    if on:
        fk.field_color_fwd_op, fk.field_color_bwd_op = fk.field_color_fwd_plain, fk.field_color_bwd_plain
    try:
        yield
    finally:
        fk.field_color_fwd_op, fk.field_color_bwd_op = ops


def chunked_step_vs_plain_step(state, data, dev, render, train, tag: str, whole_step: bool):
    """One chunked train step through K5 / K6 and one through their plain
    versions, from copies of the same state, on the first batch of the
    schedule with the same draws; then the plain step once more on the
    fine depths the kernel step resampled (replayed).  The fine pass
    resamples its depths from each version's coarse weights, and the
    inverse cdf magnifies their differences (a few flipped bf16 roundings
    of the coarse densities at init, ulps everywhere on a trained surface),
    so the fine grads of the first pair differ by more than the kernels do.
    ``whole_step`` holds the first pair's loss and coarse grads to the bars,
    its fine grads to ``fine_own_depths``, and the replayed pair's loss and
    both fields' grads to the bars; otherwise they are reported."""
    import copy

    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    images, sils, R_bop, t_bop, K = data
    n, S, bs = images.shape[0], images.shape[1], CHUNKED["batch"]
    idx = torch.as_tensor(nerf_trainer.half_schedule(n, bs, 1, CHUNKED["seed"])[0], device=dev)
    cams = cam_lib.camera_from_bop(R_bop, t_bop, K, S)
    cam = cam_lib.Camera(cams.R[idx][None], cams.T[idx][None], cams.focal[idx][None], cams.principal[idx][None], S)
    min_d, max_d = nerf_trainer.depth_bounds(t_bop.cpu().numpy())
    draws = nerf_trainer.draw([nerf_trainer.step_generator(CHUNKED["seed"], 0, dev)], bs, render, dev)
    args = (cam, images[idx][None], sils[idx][None], nerf_trainer.make_optimizer(train), render, train, min_d, max_d)
    resample = raymarch.importance_resample

    def step(plain: bool, replay=None):
        """The step and the fine depths it used (each chunk's), which are
        ``replay``'s where given."""
        depths = []

        def resampled(*a, **k):
            depths.append(next(replay) if replay is not None else resample(*a, **k))
            return depths[-1]

        raymarch.importance_resample = resampled
        try:
            with plain_field_color(plain):
                (st,), loss, _ = nerf_trainer.train_step([copy.deepcopy(state)], *args, draws=draws)
        finally:
            raymarch.importance_resample = resample
        return st, loss, depths

    a, loss_a, depths = step(False)
    b, loss_b, _ = step(True)
    c, loss_c, _ = step(True, iter(depths))
    sync(dev)
    loss_rel, err = {}, {}
    for pair, (x, lx) in (("own", (b, loss_b)), ("replayed", (c, loss_c))):
        loss_rel[pair] = float((loss_a - lx).abs().max() / lx.abs().max())
        for which in ("coarse", "fine"):
            err[pair, which] = max(float((pa.grad - pb.grad).abs().max()) / max(float(pb.grad.abs().max()), 1e-3)
                                   for (_, pa), (_, pb) in zip(nerf_trainer.trainable(getattr(a, which)),
                                                               nerf_trainer.trainable(getattr(x, which))))
    log(f"chunked train step at the {tag} state, K5 / K6 vs plain from the same state and draws: loss "
        f"{float(loss_a[0]):.6f} vs {float(loss_b[0]):.6f} (rel err {loss_rel['own']:.2e}); grad max err / tensor "
        f"max |g|: coarse {err['own', 'coarse']:.2e}, fine {err['own', 'fine']:.2e}; the plain step on the kernel "
        f"step's fine depths: loss rel err {loss_rel['replayed']:.2e}, grads coarse {err['replayed', 'coarse']:.2e}, "
        f"fine {err['replayed', 'fine']:.2e}")
    ok = (loss_rel["own"] <= TOL["loss_rel"] and err["own", "coarse"] <= TOL["grad_scaled"]
          and err["own", "fine"] <= TOL["fine_own_depths"] and loss_rel["replayed"] <= TOL["loss_rel"] and max(err["replayed", w] for w in ("coarse", "fine"))
          <= TOL["grad_scaled"])
    if whole_step and not ok:
        raise AssertionError(f"the chunked step through K5 / K6 disagrees with the step through their plain "
                             f"versions ({tag})")


def chunked_train_path(dev, seed: int, n_steps: int, profile: str | None = None):
    """``train_nerf`` on synthetic half 0 at the reference's large-batch
    schedule (``CHUNKED``): K5's and K6's launches counted over exactly the
    measured run, a kernel step against a plain step, exact resume through
    ``train.checkpoint``, and the trained fine field's point cloud.  The
    same run through K5 / K6's plain versions is a second witness of the
    trajectory: its loss curve and surface are reported beside the
    kernels' (single steps agree within the bars, many steps need not)."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        FieldConfig,
        NerfTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint, nerf_trainer

    c = CHUNKED
    scene = synthetic.make_scene(c["n_views"], c["image_size"], torch.Generator(device=dev).manual_seed(seed),
                                 device=dev)
    data = (scene.images, scene.sils, scene.R_bop, scene.t_bop, scene.K)
    cfg = FieldConfig(**FIELD)
    render = RenderConfig(n_rays_per_image=c["n_rays"])
    train = NerfTrainConfig(batch_size=c["batch"], warmup_steps=min(300, n_steps // 3))
    n_chunks = -(-c["batch"] * c["n_rays"] // nerf_trainer.RAY_CHUNK)

    def run(steps: int, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = nerf_trainer.train_nerf(*data, cfg, render, train, n_steps=steps, seed=c["seed"], device=dev, **kw)
        sync(dev)
        return out, time.perf_counter() - t0

    _, cold_s = run(1)
    reset_launch_counts()
    (state, losses), wall_s = run(n_steps)
    counts = launch_counts()
    losses = np.asarray(losses)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    with plain_field_color():
        (plain_state, plain_losses), plain_s = run(n_steps)
    plain_losses = np.asarray(plain_losses)
    log(f"chunked NeRF training, 1 half x {n_steps} steps ({c['batch']} cams x {c['n_rays']} rays = "
        f"{c['batch'] * c['n_rays']} rays in {n_chunks} chunks, {render.n_pts_coarse} + "
        f"{render.n_pts_coarse + render.n_pts_fine} points): cold first step {1e3 * cold_s:.1f} ms; warm "
        f"{1e3 * wall_s / n_steps:.2f} ms per step ({wall_s:.2f} s); launches field_color_fwd "
        f"{counts['field_color_fwd']}, field_color_bwd {counts['field_color_bwd']}, bundle_loss "
        f"{counts['bundle_loss']}; mean loss of the first 10 steps {first:.3f}, of the last 10 {last:.3f}")
    want = 2 * n_chunks * n_steps
    if not (counts["field_color_fwd"] == counts["field_color_bwd"] == want and counts["bundle_loss"] == 0):
        raise AssertionError(f"expected {want} launches of each of K5 and K6 and none of K4, counted {counts}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError("chunked training losses are not finite or do not fall")
    windows = {name: [round(float(x[i:i + 10].mean()), 3) for i in range(0, n_steps, 10)]
               for name, x in (("K5 / K6", losses), ("plain", plain_losses))}
    apart = np.nonzero(np.abs(losses - plain_losses) > 1e-3 * np.abs(plain_losses))[0]
    log(f"the same {n_steps} chunked steps through K5 / K6's plain versions: warm {1e3 * plain_s / n_steps:.2f} ms per "
        f"step; mean loss of each 10 steps, K5 / K6 {windows['K5 / K6']}, plain {windows['plain']}; first step whose "
        f"losses differ by more than 1e-3 rel: {int(apart[0]) + 1 if apart.size else None}")
    if not (np.isfinite(plain_losses).all() and plain_losses[-10:].mean() < plain_losses[:10].mean()):
        raise AssertionError("chunked training through the plain versions: losses not finite or not falling")

    fresh = nerf_trainer.init_state(cfg, train, torch.Generator().manual_seed(c["seed"]), device=dev)
    chunked_step_vs_plain_step(fresh, data, dev, render, train, "initial", whole_step=True)
    chunked_step_vs_plain_step(state, data, dev, render, train, f"step-{n_steps}", whole_step=False)

    # exact resume: N steps against N / 2, save_state, load_state, resume to N
    n_res = c["resume_steps"]
    (full, full_losses), _ = run(n_res)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        (_, head), _ = run(n_res // 2, on_checkpoint=lambda st, i: checkpoint.save_latest(ckpt_dir, st))
        resumed = checkpoint.load_state(os.path.join(ckpt_dir, checkpoint.STATE), cfg, device=dev)
        (end, tail), _ = run(n_res, resume_state=resumed)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    same = (head + tail == full_losses and end.step == full.step == n_res and end.opt.count == full.opt.count
            and all(torch.equal(x, y) for x, y in zip(nerf_trainer.train_params(end) + end.opt.mu + end.opt.nu,
                                                      nerf_trainer.train_params(full) + full.opt.mu + full.opt.nu)))
    log(f"exact resume: {n_res} steps against {n_res // 2} + save_state / load_state + {n_res - n_res // 2}: params, "
        f"Adam moments and losses of steps {n_res // 2 + 1}-{n_res} bit-identical: {same}")
    if not same:
        raise AssertionError("a resumed chunked run differs from the uninterrupted one")

    # each trained fine field's point cloud against the analytic surface (reported)
    gt, ok = synthetic.analytic_surface_points(20000, torch.Generator(device=dev).manual_seed(9), device=dev)
    for name, st in (("", state), (", through the plain versions", plain_state)):
        t0 = time.perf_counter()
        verts, tris = nerf_trainer.extract_point_cloud(st.fine, threshold=0.03, grid_res=128)
        peak = float(renderer.density_grid_cached(st.fine, grid_res=128).max())
        cham = float("nan")
        if verts.shape[0]:
            sub = verts[np.random.default_rng(0).permutation(verts.shape[0])[:20000]]
            cham = float(pc.chamfer_distance(torch.as_tensor(sub, dtype=torch.float32, device=dev), gt[ok]))
        log(f"extract_point_cloud of the step-{n_steps} fine field{name} at 128^3 (threshold 0.03, grid max density "
            f"{peak:.4f}): {verts.shape[0]} vertices, {tris.shape[0]} triangles, Chamfer to the analytic surface "
            f"{cham:.4f} (object diameter {scene.diameter:.3f}; {time.perf_counter() - t0:.2f} s)")
    if profile:
        profile_run(lambda: run(20)[1], profile + ".chunked.txt", "20 chunked training steps")
    return counts, 1e3 * wall_s / n_steps


def icp_check(dev, upper, lower, cad, R_gt, t_gt, diameter: float, scale: float):
    """Registration of the baked keys from a known small perturbation of the
    ground-truth pose, on the card and on the CPU plain path: ICP must find
    inliers, move the pose, and agree between the two."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import rotations
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import registration

    # start pose: GT composed with a 3-degree rotation and a 0.02 * scale shift
    axis = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
    dR = rotations.rotvec_to_matrix(torch.as_tensor(axis * np.deg2rad(3.0), dtype=torch.float32)).numpy()
    R0, t0 = R_gt @ dR, t_gt + 0.02 * scale * axis.astype(np.float32)
    R_start, t_start = (x.numpy() for x in rotations.invert_pose(torch.as_tensor(R0), torch.as_tensor(t0)))
    args = (upper, lower[::5], R_gt, t_gt, R0, t0, cad[::5])
    kw = dict(diameter=diameter, icp_threshold=0.2 * scale, icp_iters=SERVE["icp_iters"])
    on_gpu = registration.register_halves(*args, device=dev, **kw)
    on_cpu = registration.register_halves(*args, device="cpu", **kw)
    moved = float(np.abs(on_gpu["t"] - t_start).max() + np.abs(on_gpu["R"] - R_start).max())
    d_R = float(np.abs(on_gpu["R"] - on_cpu["R"]).max())
    d_t = float(np.abs(on_gpu["t"] - on_cpu["t"]).max())
    d_c = abs(on_gpu["chamfer"] - on_cpu["chamfer"])
    log(f"ICP from a perturbed GT pose ({upper.shape[0]} keys onto {lower[::5].shape[0]} CAD points): fitness "
        f"card {on_gpu['fitness']:.3f} / CPU {on_cpu['fitness']:.3f}, inlier rmse {on_gpu['inlier_rmse']:.5f}, "
        f"pose moved {moved:.3e}; card vs CPU |dR| {d_R:.2e}, |dt| {d_t:.2e}, |d chamfer| {d_c:.2e}")
    if not (on_gpu["fitness"] > 0.5 and on_cpu["fitness"] > 0.5 and moved > 1e-4):
        raise AssertionError("ICP from a perturbed GT pose found too few inliers or did not move")
    if not (d_R < 1e-3 and d_t < 1e-3 * scale and d_c < 1e-4 * max(1.0, on_cpu["chamfer"])):
        raise AssertionError("ICP on the card disagrees with the CPU plain path")


SERVE_OUTPUTS = ("verts_scaled", "feats", "verts_real", "n_real", "adds", "pred_R", "pred_t", "R_gt", "t_gt", "best",
                 "chamfers", "cad", "upper", "lower", "out", "stages")


def serve_stages(dev, seed: int, field, cnn, scene0, scene1, out_dir: str, tag: str) -> dict:
    """One run of the bench's serving stages (bake -> inference -> ADD ->
    verification -> ICP) with ``field`` and ``cnn``: scene0's keys baked,
    scene1's first ``SERVE["n_infer"]`` images posed.  Returns the outputs
    named in ``SERVE_OUTPUTS``, "stages" the wall seconds of each stage."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FeatConfig, InferenceConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import normalize_image
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import (
        artifacts,
        gen_feat,
        inference,
        registration,
    )

    img, grid, n_inf = SERVE["image_size"], SERVE["grid_res"], SERVE["n_infer"]
    diam = scene0.diameter
    scale = diam / 1.8
    t_start = time.perf_counter()
    exp0 = os.path.join(out_dir, "0_synth_obj_1")
    verts_scaled, feats, normals = gen_feat.gen_feat(
        field, scene0.R_bop, scene0.t_bop, scene0.K, scene0.sils, diam, exp0, 1,
        FeatConfig(mc_threshold=0.05, n_points=SERVE["n_points"], sample_loops=SERVE["sample_loops"]),
        image_size=img, grid_res=grid,
        threshold=0.2, generator=torch.Generator(device=dev).manual_seed(seed),
    )
    sync(dev)
    t_bake = time.perf_counter()

    imgs_n = normalize_image(scene1.images[:n_inf])
    Ks_fixed = scene1.K[:n_inf].clone()
    Ks_fixed[:, 0:2, 2] -= 0.5  # pixel-center convention, as the bench
    pred_R, pred_t = inference.run_sequence(cnn, imgs_n, scene1.sils[:n_inf], Ks_fixed, verts_scaled, feats,
                                            cfg=InferenceConfig(), seed=seed, batch=n_inf, device=dev)
    # metrics use the true (pre-pad) keys, as the bench does
    verts_real, _, _, n_real = artifacts.load_keys(artifacts.pose_dir(exp0, 1))
    R_gt = scene1.R_bop[:n_inf]
    t_gt = scene1.t_bop[:n_inf] * scale
    adds = metrics.add_metric(torch.as_tensor(verts_real, device=dev), R_gt, t_gt,
                              torch.as_tensor(pred_R, device=dev), torch.as_tensor(pred_t, device=dev))
    adds = adds.cpu().numpy()
    sync(dev)
    t_inf = time.perf_counter()

    sub_cloud = verts_real[:: max(verts_real.shape[0] // 4000, 1)]
    best, chamfers = registration.verify_consecutive(sub_cloud, R_gt, t_gt, pred_R, pred_t, device=dev)
    cad_pts, ok = synthetic.analytic_surface_points(20000, torch.Generator(device=dev).manual_seed(9), device=dev)
    cad = (cad_pts[ok] * scale).cpu().numpy()
    upper = verts_real[:20000]
    lower = cad[cad[:, 2] < 2]
    out = registration.register_halves(upper, lower, R_gt[best].cpu().numpy(), t_gt[best].cpu().numpy(),
                                       pred_R[best], pred_t[best], cad, diameter=diam * scale,
                                       icp_threshold=0.2 * scale, icp_iters=SERVE["icp_iters"], device=dev)
    sync(dev)
    t_end = time.perf_counter()

    stages = {"bake_s": t_bake - t_start, "infer_s": t_inf - t_bake, "icp_s": t_end - t_inf,
              "serve_s": t_end - t_start}
    log(f"serve stages ({tag}): " + json.dumps(stages))
    log(f"keys {n_real} (padded {verts_scaled.shape[0]}), ADD per image {np.round(adds, 4).tolist()} "
        f"(median {float(np.median(adds)):.4f}, bar {0.1 * diam * scale:.4f}), verify best {best}, "
        f"chamfer {out['chamfer']:.5f} (ok {out['correct']}), ICP fitness {out['fitness']:.3f}")
    return dict(zip(SERVE_OUTPUTS, (verts_scaled, feats, verts_real, n_real, adds, pred_R, pred_t, R_gt, t_gt, best,
                                    chamfers, cad, upper, lower, out, stages)))


def serve_path(dev, seed: int, out_dir: str, profile: str | None = None):
    """The bench's bake -> inference -> ADD -> verification -> ICP stages.
    With ``profile``, a further run under torch.profiler writes its kernel
    table there and logs the device's busy share."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet

    n_views, img, n_inf = SERVE["n_views"], SERVE["image_size"], SERVE["n_infer"]
    t0 = time.perf_counter()
    halves = [synthetic.make_scene(n_views, img, torch.Generator(device=dev).manual_seed(seed + uh), device=dev)
              for uh in (0, 1)]
    cfg = FieldConfig(**FIELD)
    field = NerfField(cfg)
    field.load_state_dict(convert.params_from_jax(convert.planted_field_params(cfg, seed)))
    field = field.to(dev).eval()
    cnn = ResNetUNet().reset_parameters(torch.Generator().manual_seed(seed)).to(dev).eval()
    sync(dev)
    log(f"setup (scenes, weights) {time.perf_counter() - t0:.2f} s")
    scene0, scene1 = halves
    diam = scene0.diameter
    scale = diam / 1.8

    def once(tag: str):
        out = serve_stages(dev, seed, field, cnn, scene0, scene1, out_dir, tag)
        return tuple(out[k] for k in SERVE_OUTPUTS)

    once("cold: first call, cuDNN and allocator warm-up")
    # the measured run: launch counts cover exactly this run of the path;
    # K2's and K3's launch shapes (queries, references or keys, masked) are
    # recorded on the way through, for their timings and bounds
    reset_launch_counts()
    with recorded_launches() as shapes:
        (verts_scaled, feats, verts_real, n_real, adds, pred_R, pred_t, R_gt, t_gt, best, chamfers,
         cad, upper, lower, out, stages) = once("warm")
    counts = {k: launch_counts()[k] for k in SERVE_KERNELS}
    log("launches in the serve run: " + json.dumps(counts))
    log(f"K2 launch shapes in the serve run (queries, references, masked: launches): "
        f"{ {str(k): shapes['nn_min'].count(k) for k in sorted(set(shapes['nn_min']))} }; K3's (queries, keys, "
        f"width): {shapes['corr_argmax']}")
    if profile:
        profile_run(lambda: once("profiled")[-1]["serve_s"], profile, "serve run")

    # ---- checks of what came out
    if not (n_real > 0 and feats.shape == (verts_scaled.shape[0], 12) and np.isfinite(feats).all()):
        raise AssertionError("baked keys have the wrong shape or are not finite")
    radius = np.linalg.norm(verts_real / scale, axis=-1)
    log(f"baked key radius (unscaled): min {radius.min():.4f} median {np.median(radius):.4f} max {radius.max():.4f}")
    if not (0.4 < np.median(radius) < 0.6 and radius.max() < 0.75):
        raise AssertionError("baked keys are not on the planted shell of radius ~0.5")
    if not (np.isfinite(pred_R).all() and np.isfinite(pred_t).all() and np.isfinite(adds).all()):
        raise AssertionError("non-finite poses or ADD")
    orth = np.abs(np.einsum("nij,nkj->nik", pred_R, pred_R) - np.eye(3)).max()
    if orth > 1e-3:
        raise AssertionError(f"predicted rotations are not orthonormal ({orth:.2e})")
    if not (np.isfinite(out["chamfer"]) and len(chamfers) == n_inf - 1):
        raise AssertionError("registration produced no finite Chamfer distance")
    icp_check(dev, upper, lower, cad, R_gt[best].cpu().numpy(), t_gt[best].cpu().numpy(), diam * scale, scale)
    fps_timing(torch.as_tensor(verts_real / scale, device=dev), "the bake's keys")
    if not all(c > 0 for c in counts.values()):
        raise AssertionError(f"a kernel of the serving path never launched: {counts}")
    return counts, stages, shapes


def fps_timing(pts, what: str, reps: int = 5):
    """Farthest-point sampling of all of ``pts``, timed on the host clock
    ``reps`` times each with its selections in CUDA graphs (as the port runs
    it on the card) and as a launch sequence a selection; the two must
    select the same points."""
    import numpy as np

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc

    times, idx = {}, {}
    block = pc.FPS_GRAPH_BLOCK
    for name, b in (("graphs", block), ("launches", 0)):
        pc.FPS_GRAPH_BLOCK = b
        try:
            ms = []
            for _ in range(reps):
                sync(pts.device)
                t0 = time.perf_counter()
                idx[name] = pc.farthest_point_sampling(pts, pts.shape[0])
                sync(pts.device)
                ms.append(1e3 * (time.perf_counter() - t0))
        finally:
            pc.FPS_GRAPH_BLOCK = block
        times[name] = ms
    same = bool((idx["graphs"] == idx["launches"]).all())
    log(f"FPS of {pts.shape[0]} points ({what}, host clock, {reps} runs each): CUDA graphs of {block} selections "
        f"{np.round(times['graphs'], 1).tolist()} ms, a launch sequence a selection "
        f"{np.round(times['launches'], 1).tolist()} ms; same selections: {same}")
    if not same:
        raise AssertionError("FPS through CUDA graphs selects other points than its launch sequence")
    return float(np.median(times["graphs"])), float(np.median(times["launches"]))


def nn_check(dev, g, n: int, m: int, masked: bool, what: str = ""):
    """K2 at one shape on random inputs from ``g``: against its plain
    version and a second launch, bit for bit (raises otherwise), timed as a
    CUDA graph replay.  Returns (ms, plain ms, bound, inputs, plain
    result)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk

    q = torch.randn((n, 3), generator=g, device=dev)
    r = torch.randn((m, 3), generator=g, device=dev)
    mask = torch.rand((m,), generator=g, device=dev) > 0.1 if masked else None
    ms, (d_k, i_k) = graph_ms(lambda: pk.nn_min_cuda(q, r, mask))
    plain_ms, (d_p, i_p) = cuda_ms(lambda: pk.nn_min_plain(q, r, mask), reps=1)
    d_2, i_2 = pk.nn_min_cuda(q, r, mask)
    same = torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    again = torch.equal(d_2, d_k) and torch.equal(i_2, i_k)
    b = nn_bound(n, m, masked)
    log(f"K2 nn_min {what}{n} x {m}{' masked' if masked else ''} ({pk.launch_plan(n, m, dev, 'nn_min')[0]} splits): "
        f"bit-identical to plain {same}, second launch {again}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b[0]:.4f} ms ({b[1]})")
    if not (same and again):
        raise AssertionError(f"K2 disagrees with its plain version or itself at {what}{n} x {m}")
    return ms, plain_ms, b, (q, r, mask), (d_p, i_p)


def corr_check(dev, g, n: int, m: int, e: int, what: str = ""):
    """K3 at one shape on random inputs from ``g``: conf within
    TOL["corr_argmax"] of its plain version, indices equal but at logit
    ties, a second launch bit for bit (raises otherwise), timed as a CUDA
    graph replay.  Returns (conf error, ms, plain ms, bound)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk

    q = torch.randn((n, e), generator=g, device=dev)
    k = torch.randn((m, e), generator=g, device=dev)
    ms, (i_k, c_k) = graph_ms(lambda: pk.correspondence_argmax_cuda(q, k))
    plain_ms, (i_p, c_p) = cuda_ms(lambda: pk.correspondence_argmax_plain(q, k), reps=1)
    i_2, c_2 = pk.correspondence_argmax_cuda(q, k)
    err = float((c_k - c_p).abs().max())
    diff = i_k != i_p
    tie_gap = float(((q[diff] * k[i_k[diff].long()]).sum(-1)
                     - (q[diff] * k[i_p[diff].long()]).sum(-1)).abs().max()) if bool(diff.any()) else 0.0
    again = torch.equal(i_2, i_k) and torch.equal(c_2, c_k)
    b = corr_bound(n, m, e)
    log(f"K3 corr {what}{n} x {m} x {e} ({pk.launch_plan(n, m, dev, 'corr_argmax')[0]} splits): conf max_abs_err "
        f"{err:.3e} (tol {TOL['corr_argmax']}), index mismatches {int(diff.sum())} (logit gap {tie_gap:.2e}), "
        f"second launch bit-identical {again}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms "
        f"({b[1]})")
    if not (err <= TOL["corr_argmax"] and float(diff.float().mean()) < 1e-3 and tie_gap < 1e-5 and again):
        raise AssertionError(f"K3 disagrees with its plain version or itself at {what}{n} x {m} x {e}")
    return err, ms, plain_ms, b


def point_kernel_phase(dev, seed: int, shapes: dict):
    """K2 and K3 against their plain versions on random inputs: K2 at every
    launch shape the serve run recorded (``shapes``, from ``serve_path``),
    each bit-identical to the plain version and to a second launch, its
    time summed over the run's launches replayed as one CUDA graph, and at
    50,000 x 50,000; K3 at the serve's launch shape and at ``CORR_SHAPES``.
    Returns {name: result} over the serve run's launches."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk

    g = torch.Generator(device=dev).manual_seed(seed)
    nn_slots, corr_slots = pk.slots(dev.index, "nn_min"), pk.slots(dev.index, "corr_argmax")
    log(f"blocks the card holds at once (SMs x occupancy): K2 {nn_slots}, K3 {corr_slots}; queries a block "
        f"{cuda_build.kernels().point_queries_per_block()}")
    results = {}

    inputs, per_shape, want = {}, {}, {}
    for s in sorted(set(shapes["nn_min"])):
        ms, plain_ms, _, inputs[s], want[s] = nn_check(dev, g, *s)
        per_shape[s] = (ms, plain_ms)
    launches = shapes["nn_min"]
    ms, outs = graph_ms(lambda: [pk.nn_min_cuda(*inputs[s]) for s in launches])
    plain_ms = sum(per_shape[s][1] for s in launches)
    bounds = [nn_bound(*s) for s in launches]
    b = (sum(t for t, _ in bounds), "operations" if all(by == "operations" for _, by in bounds) else "bytes")
    # the graph's launches against the plain version at each launch's shape
    err = max(float((d - want[s][0]).abs().max()) for s, (d, _) in zip(launches, outs))
    idx_same = all(torch.equal(i, want[s][1]) for s, (_, i) in zip(launches, outs))
    results["nn_min"] = result(err, ms, plain_ms, b)
    log(f"K2 over the serve run's {len(launches)} launches (one CUDA graph): dist max_abs_err {err:.3e} (tol "
        f"{TOL['nn_min']}), indices equal {idx_same}; kernel {ms:.3f} ms (per-shape times summed "
        f"{sum(per_shape[s][0] for s in launches):.3f}), plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms summed ({b[1]})")
    if not (err <= TOL["nn_min"] and idx_same):
        raise AssertionError("K2 disagrees with its plain version over the serve run's launches")
    del inputs, want, outs

    n, m = NN_SHAPE
    q = torch.randn((n, 3), generator=g, device=dev)
    r = torch.randn((m, 3), generator=g, device=dev)
    mask = torch.rand((m,), generator=g, device=dev) > 0.1
    ms, (d_k, i_k) = cuda_ms(lambda: pk.nn_min_cuda(q, r, mask), reps=10)
    plain_ms, (d_p, i_p) = cuda_ms(lambda: pk.nn_min_plain(q, r, mask), reps=1)
    d_2, i_2 = pk.nn_min_cuda(q, r, mask)
    same = torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    again = torch.equal(d_2, d_k) and torch.equal(i_2, i_k)
    b = nn_bound(n, m, True)
    log(f"K2 nn_min {n} x {m} masked ({pk.launch_plan(n, m, dev, 'nn_min')[0]} splits): bit-identical to plain "
        f"{same}, second launch {again}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]})")
    if not (same and again):
        raise AssertionError(f"K2 disagrees with its plain version or itself at {n} x {m}")
    del q, r, mask, d_k, i_k, d_p, i_p, d_2, i_2

    corr = {s: corr_check(dev, g, *s) for s in sorted(set(shapes["corr_argmax"])) + CORR_SHAPES}
    launches = shapes["corr_argmax"]
    b = (sum(corr[s][3][0] for s in launches), corr[launches[0]][3][1])
    results["corr_argmax"] = result(max(corr[s][0] for s in launches), sum(corr[s][1] for s in launches),
                                    sum(corr[s][2] for s in launches), b)
    return results


@contextlib.contextmanager
def recorded_launches():
    """While open, the sizes (points) of K1's launches and the shapes of
    K2's (queries, references, masked) and K3's (queries, keys, width) on
    the card are appended to the yielded dict (recorded at the ops'
    dispatch)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk

    shapes = {"density": [], "nn_min": [], "corr_argmax": []}
    ops = fk.density_op, pk.nn_min, pk.correspondence_argmax

    def density(pts, *rest):
        if pts.device.type == "cuda" and pts.shape[0]:
            shapes["density"].append(pts.shape[0])
        return ops[0](pts, *rest)

    def nn_min(query, ref, ref_mask=None):
        if query.device.type == "cuda" and query.shape[0]:
            shapes["nn_min"].append((query.shape[0], ref.shape[0], ref_mask is not None))
        return ops[1](query, ref, ref_mask)

    def corr(queries, keys):
        if queries.device.type == "cuda" and queries.shape[0]:
            shapes["corr_argmax"].append((queries.shape[0], keys.shape[0], keys.shape[1]))
        return ops[2](queries, keys)

    fk.density_op, pk.nn_min, pk.correspondence_argmax = density, nn_min, corr
    try:
        yield shapes
    finally:
        fk.density_op, pk.nn_min, pk.correspondence_argmax = ops


@contextlib.contextmanager
def plain_density_and_nn():
    """While open, K1 and K2 run their plain versions, on the card too."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk

    k1, k2 = fk.density_cuda, pk.nn_min_cuda
    fk.density_cuda, pk.nn_min_cuda = fk.density_plain, pk.nn_min_plain
    try:
        yield
    finally:
        fk.density_cuda, pk.nn_min_cuda = k1, k2


def view_geometry(scene, view: int, image_size: int, dev):
    """(camera, silhouette pixels, min depth, max depth) of one view, as
    generate_cors takes them."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import generate_cors

    cam = cam_lib.camera_from_bop(scene.R_bop, scene.t_bop, scene.K, image_size)[view]
    pix = torch.as_tensor(generate_cors.silhouette_pixels(scene.sils[view].cpu().numpy()), device=dev)
    z = scene.t_bop[:, 2].abs().cpu().numpy()
    return cam, pix, float(z.min() - 2.0), float(z.max() + 2.0)


def ray_pixels(xys, S: int):
    """Flat pixel index of each NDC ray center."""
    import numpy as np

    col = np.rint((1.0 - xys[:, 0]) * S / 2.0 - 0.5).astype(np.int64)
    row = np.rint((1.0 - xys[:, 1]) * S / 2.0 - 0.5).astype(np.int64)
    return row * S + col


def check_cors_hits(cors: str, scene, cfg, S: int, dev):
    """What generate_cors wrote for one half: every front and back hit
    within ``mesh_filter_dist`` of a1 (K2's plain version, on the card),
    every back hit behind its front hit along its back ray (the direction
    -camera origin; the back ray starts at the front hit, so a back hit may
    sit on it), and no nearer the camera.  Returns the counts of front and
    back hits."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts

    a1 = torch.as_tensor(artifacts.load_array(cors, "a1.npy"), device=dev)
    origins = cam_lib.camera_center(cam_lib.camera_from_bop(scene.R_bop, scene.t_bop, scene.K, S)).cpu().numpy()
    n_front = n_back = at_front = 0
    worst_d, least_t, least_gain = 0.0, np.inf, np.inf
    for v in range(scene.R_bop.shape[0]):
        xys, pos, bxys, back = artifacts.load_view_rays(cors, S, v)
        for hits in (pos, back):
            if hits.shape[0]:
                d, _ = pk.nn_min_plain(torch.as_tensor(hits, device=dev), a1)
                worst_d = max(worst_d, float(d.max()))
        row = dict(zip(ray_pixels(xys, S).tolist(), range(xys.shape[0])))
        front = pos[[row[q] for q in ray_pixels(bxys, S).tolist()]]
        o = origins[v]
        u = -o / np.linalg.norm(o)
        if back.shape[0]:
            t = (back - front) @ u
            least_t, at_front = min(least_t, float(t.min())), at_front + int((t == 0).sum())
            gain = np.linalg.norm(back - o, axis=-1) - np.linalg.norm(front - o, axis=-1)
            least_gain = min(least_gain, float(gain.min()))
        n_front, n_back = n_front + pos.shape[0], n_back + back.shape[0]
    log(f"  {cors}: {n_front} front / {n_back} back hits; farthest from a1 {worst_d:.4f} (filter "
        f"{cfg.mesh_filter_dist}); least step behind the front hit along the back ray {least_t:.4f} ({at_front} back "
        f"hits on their front hit: the back pass's only sample above 0.05 is its first), least gain in distance from "
        f"the camera {least_gain:.4f}")
    if not (n_front > 0 and n_back > 0 and worst_d < cfg.mesh_filter_dist and least_t >= 0.0 and least_gain >= 0.0):
        raise AssertionError(f"correspondence hits off the mesh, or a back hit not behind its front hit ({cors})")
    return n_front, n_back


def cors_kernel_checks(dev, field, scene, cors: str, cfg, S: int, shapes: dict, counts: dict) -> dict:
    """K1 and K2 against their plain versions at the shapes the cors stage
    gave them: K1 at view 0's front pass (its silhouette's rays x
    ``grid_pts_per_ray`` points, one launch), K2 at view 0's front mesh
    filter (those rays' hits against the unpadded a1), bit-identical."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, generate_cors

    sizes = {n: shapes["density"].count(n) for n in sorted(set(shapes["density"]))}
    nn_shapes = {str(k): shapes["nn_min"].count(k) for k in sorted(set(shapes["nn_min"]))}
    log(f"cors stage launches: K1 {counts['density']} (points: launches {sizes}), K2 {counts['nn_min']} "
        f"(queries, references, masked: launches {nn_shapes})")
    cam, pix, lo, hi = view_geometry(scene, 0, S, dev)
    pts = cam_lib.ray_points(cam_lib.rays_at_pixels(cam, pix, S, cfg.grid_pts_per_ray, lo, hi)).reshape(-1, 3)
    pts = pts.contiguous()
    w, ladder, beta = fk.density_weights(field), fk.ladder_of(field.cfg), float(field.cfg.softplus_beta)
    ms, got = cuda_ms(lambda: fk.density_cuda(pts, w, ladder, beta), reps=5)
    plain_ms, want = cuda_ms(lambda: torch.cat([fk.density_plain(p, w, ladder, beta)
                                                for p in torch.split(pts, 262144)]), reps=1)
    err = (got - want).abs()
    share = float((err > 1e-4).float().mean())
    flips = int(((got > cfg.density_threshold) != (want > cfg.density_threshold)).sum())
    same = torch.equal(got, fk.density_cuda(pts, w, ladder, beta))
    n, E, nh = pts.shape[0], w[1].shape[0], w[3].shape[0]
    b1 = bound(n * 16 + 4 * (2 * E * nh + nh * nh + 3 * nh + 1), n * (4 * E * nh + 2 * nh * nh), BF16_FLOPS)
    log(f"K1 density at view 0's front pass ({pix.shape[0]} rays x {cfg.grid_pts_per_ray} = {n} points, trained "
        f"fine field): max_abs_err {float(err.max()):.3e} (tol {TOL['density']}), share > 1e-4 {share:.2e} (tol "
        f"{TOL['density_share']}), points on the other side of the threshold {flips}; second launch bit-identical "
        f"{same}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b1[0]:.3f} ms ({b1[1]})")
    if not (float(err.max()) <= TOL["density"] and share < TOL["density_share"] and same):
        raise AssertionError("K1 disagrees with its plain version at the cors stage's front pass")
    del pts, got, want, err

    a1 = torch.as_tensor(artifacts.load_array(cors, "a1.npy"), device=dev)
    hits = generate_cors.view_surface_hits(field, cam, pix, a1, S, cfg.grid_pts_per_ray, lo, hi,
                                           cfg.density_threshold, cfg.mesh_filter_dist, cfg.back_len_div)["pos_vec"]
    hits = hits.contiguous()
    k_ms, (d_k, i_k) = graph_ms(lambda: pk.nn_min_cuda(hits, a1))
    p_ms, (d_p, i_p) = cuda_ms(lambda: pk.nn_min_plain(hits, a1), reps=1)
    same2 = torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    b2 = nn_bound(hits.shape[0], a1.shape[0])
    log(f"K2 nn_min at view 0's mesh filter ({hits.shape[0]} front hits x {a1.shape[0]} surface points, "
        f"{pk.launch_plan(hits.shape[0], a1.shape[0], dev, 'nn_min')[0] if dev.type == 'cuda' else '-'} splits): "
        f"bit-identical to plain {same2}; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b2[0]:.4f} ms ({b2[1]})")
    if not same2:
        raise AssertionError("K2 disagrees with its plain version at the cors stage's mesh filter")


def threshold_flips(field, cam, pix, S: int, cfg, lo: float, hi: float, back_hits) -> "torch.Tensor":
    """Per ray through ``pix``: does some sample's density fall on one side
    of its pass's threshold through K1 and on the other through its plain
    version (the front pass at ``cfg.density_threshold``; the back pass at
    0.05 from each of ``back_hits``, front hits of those rays)?"""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer

    w, ladder, beta = fk.density_weights(field), fk.ladder_of(field.cfg), float(field.cfg.softplus_beta)
    front = cam_lib.rays_at_pixels(cam, pix, S, cfg.grid_pts_per_ray, lo, hi)

    def flips(bundle, thr):
        pts = cam_lib.ray_points(bundle).reshape(-1, 3).contiguous()
        k = fk.density_cuda(pts, w, ladder, beta)
        p = torch.cat([fk.density_plain(c, w, ladder, beta) for c in torch.split(pts, 262144)])
        return ((k > thr) != (p > thr)).reshape(pix.shape[0], -1).any(-1)

    out = flips(front, cfg.density_threshold)
    for hits in back_hits:
        out |= flips(renderer.back_ray_bundle(front, hits, cfg.back_len_div), 0.05)
    return out


def cors_vs_plain(dev, field, scene, cors: str, cfg, S: int, out_dir: str):
    """generate_cors of one half again with K1 and K2's plain versions (on the
    card): per view the same rays kept, with the same front and back hits
    bit for bit, except rays where some sample's density lies on the two
    sides of its pass's threshold through K1 and through the plain version
    (``threshold_flips``; K2 is bit-identical to its plain version, so the
    mesh filters add no flip of their own)."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, generate_cors

    t0 = time.perf_counter()
    with plain_density_and_nn():
        plain = generate_cors.generate_cors(field, scene.R_bop, scene.t_bop, scene.K, scene.sils,
                                            os.path.join(out_dir, "plain"), 1, cfg, grid_res=SERVE["grid_res"],
                                            image_size=S, device=dev)
    sync(dev)
    plain_s = time.perf_counter() - t0
    n_same = n_diff = 0
    count_diff, moved = [], 0.0
    for v in range(scene.R_bop.shape[0]):
        runs = [artifacts.load_view_rays(d, S, v) for d in (cors, plain)]
        front = [dict(zip(ray_pixels(r[0], S).tolist(), r[1])) for r in runs]
        back = [dict(zip(ray_pixels(r[2], S).tolist(), r[3])) for r in runs]
        odd = set()
        for a, b in (front, back):
            both = set(a) & set(b)
            diff = {q for q in both if not np.array_equal(a[q], b[q])}
            moved = max([moved] + [float(np.abs(a[q] - b[q]).max()) for q in diff])
            odd |= (set(a) ^ set(b)) | diff
            n_same += len(both - diff)
        count_diff.append((len(front[0]) - len(front[1]), len(back[0]) - len(back[1])))
        if odd:
            cam, _, lo, hi = view_geometry(scene, v, S, dev)
            pix = np.asarray(sorted(odd))
            have = threshold_flips(field, cam, torch.as_tensor(pix, device=dev), S, cfg, lo, hi, [])
            # a ray whose front pass does not flip has the same front hit (and
            # mesh filter) in both runs, and is kept by both: its back pass
            both = [i for i, q in enumerate(pix) if q in front[0] and q in front[1]]
            if both:
                hb = [torch.as_tensor(np.stack([f[q] for q in pix[both]]), device=dev) for f in front]
                have[torch.as_tensor(both, device=dev)] |= threshold_flips(
                    field, cam, torch.as_tensor(pix[both], device=dev), S, cfg, lo, hi, hb)
            if not bool(have.all()):
                raise AssertionError(f"generate_cors through K1 / K2 and through their plain versions differ at "
                                     f"view {v} on rays with no threshold flip: {pix[~have.cpu().numpy()][:10]}")
            n_diff += len(odd)
    log(f"generate_cors of half 0 through K1 / K2's plain versions ({plain_s:.2f} s): {n_same} front / back hits "
        f"bit-identical to the kernels' run; {n_diff} rays differ, each with a sample's density on the two sides of "
        f"its pass's threshold through K1 and through the plain version (largest hit move {moved:.4f}); per view "
        f"(front, back) count differences {count_diff}")
    return n_same, n_diff


def pipeline_path(dev, seed: int, out_dir: str, trained=None):
    """The bench's chain on the card: NeRF training of both halves (or
    ``trained`` = (states, wall seconds, launch counts) of that run), then
    generate_cors of each half, negatives, descriptor training, and the
    serving stages on the trained feature head and CNN.  Each stage's
    launches are counted over exactly that stage."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        CorsConfig,
        FieldConfig,
        NerfTrainConfig,
        PoseTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import (
        artifacts,
        generate_cors,
        surface_sampling,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment, nerf_trainer, pose_trainer

    P, S, V = PIPELINE, TRAIN["image_size"], TRAIN["n_views"]
    halves = [synthetic.make_scene(V, S, torch.Generator(device=dev).manual_seed(seed + uh), device=dev)
              for uh in (0, 1)]
    stages, counts = {}, {}
    if trained is not None:
        states, stages["nerf_s"], counts["nerf"] = trained
    else:
        stacked = [torch.stack([getattr(h, f) for h in halves]) for f in ("images", "sils", "R_bop", "t_bop", "K")]
        cfg = FieldConfig(**FIELD)
        train = NerfTrainConfig(warmup_steps=TRAIN["warmup"], batch_size=TRAIN["batch"])
        reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        states, _ = nerf_trainer.train_nerf_fused(*stacked, cfg, RenderConfig(n_rays_per_image=TRAIN["n_rays"]), train,
                                                  n_steps=P["nerf_steps"], seed=TRAIN["seed"], device=dev)
        sync(dev)
        stages["nerf_s"], counts["nerf"] = time.perf_counter() - t0, launch_counts()

    cors_cfg = CorsConfig(**P["cors"])
    timing = os.environ.get("CORS_TIMING")
    os.environ["CORS_TIMING"] = "1"
    reset_launch_counts()
    try:
        with recorded_launches() as shapes:
            t0 = time.perf_counter()
            cors_dirs = [generate_cors.generate_cors(states[uh].fine, h.R_bop, h.t_bop, h.K, h.sils,
                                                     os.path.join(out_dir, f"{uh}_synth_obj_1"), 1, cors_cfg,
                                                     grid_res=SERVE["grid_res"], image_size=S, device=dev)
                         for uh, h in enumerate(halves)]
            sync(dev)
            stages["cors_s"] = time.perf_counter() - t0
    finally:
        if timing is None:
            del os.environ["CORS_TIMING"]
        else:
            os.environ["CORS_TIMING"] = timing
    counts["cors"] = launch_counts()
    cors_rays = [int(sum(artifacts.load_view_rays(d, S, i)[1].shape[0] for i in range(V))) for d in cors_dirs]
    log(f"cors_s {stages['cors_s']:.3f} s: cors_rays {cors_rays} (front hits of each half's {V} views)")
    for d, h in zip(cors_dirs, halves):
        check_cors_hits(d, h, cors_cfg, S, dev)

    h0, h1 = halves
    pose_cfg = PoseTrainConfig(**P["pose"])
    a1 = artifacts.load_array(cors_dirs[0], "a1.npy")
    reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    neg = pose_trainer.build_negatives(states[0].fine, h0.R_bop, h0.t_bop, h0.K, h0.sils, a1, pose_cfg,
                                       image_size=S, n_loops=P["neg_loops"], threshold=P["neg_threshold"],
                                       generator=torch.Generator(device=dev).manual_seed(P["neg_seed"]), device=dev)
    sync(dev)
    stages["neg_s"], counts["neg"] = time.perf_counter() - t0, launch_counts()
    log(f"neg_s {stages['neg_s']:.3f} s: n_neg {neg.shape[0]} (surface-hit loops {P['neg_loops']}, a1 "
        f"{a1.shape[0]} points)")

    aug_cfg = augment.AugmentConfig(**P["aug"])
    bank = pose_trainer.load_ray_bank(cors_dirs[0], S, V, device=dev)

    def run_pose(n: int):
        sync(dev)
        t = time.perf_counter()
        out = pose_trainer.train_pose(states[0].fine, h0.images, h0.sils, bank, neg, cfg=pose_cfg, aug_cfg=aug_cfg,
                                      n_steps=n, seed=P["pose_seed"], device=dev)
        sync(dev)
        return out, time.perf_counter() - t

    _, cold_s = run_pose(1)
    reset_launch_counts()
    (pstate, losses), stages["pose_s"] = run_pose(P["pose_steps"])
    counts["pose"] = launch_counts()
    losses = np.asarray(losses)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    trunk_same = torch.equal(pstate.field.trunk1.weight, states[0].fine.trunk1.weight)
    head_moved = not torch.equal(pstate.field.feature_layer.out.weight, states[0].fine.feature_layer.out.weight)
    log(f"pose_s {stages['pose_s']:.3f} s: {P['pose_steps']} descriptor steps ({min(pose_cfg.batch_size, V)} views x "
        f"{pose_cfg.sample_size} samples, {bank.pos_vec.shape[1]} bank rows a view), warm "
        f"{1e3 * stages['pose_s'] / P['pose_steps']:.2f} ms per step, cold first step {1e3 * cold_s:.1f} ms; mean "
        f"loss of the first 10 steps {first:.6f}, of the last 10 {last:.6f}; NeRF trunk unchanged {trunk_same}, "
        f"feature head moved {head_moved}")
    if not (np.isfinite(losses).all() and last < first and trunk_same and head_moved):
        raise AssertionError("descriptor training: losses not finite or not falling, or the wrong parameters moved")

    reset_launch_counts()
    served = serve_stages(dev, seed, pstate.field, pstate.cnn, h0, h1, os.path.join(out_dir, "serve"),
                          "the trained chain")
    counts["serve"] = launch_counts()
    stages.update({k: served["stages"][k] for k in ("bake_s", "infer_s", "icp_s")})
    diam, scale = h0.diameter, h0.diameter / 1.8
    adds = served["adds"]
    quality = {"pose_correct": int((adds < 0.1 * diam * scale).sum()), "median_add": float(np.median(adds)),
               "chamfer": float(served["out"]["chamfer"]), "cors_rays": cors_rays, "n_neg": int(neg.shape[0]),
               "n_keys": int(served["n_real"])}
    log("pipeline stages (s): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    log("pipeline outputs: " + json.dumps(quality))
    if not (np.isfinite(adds).all() and np.isfinite(served["pred_R"]).all() and np.isfinite(quality["chamfer"])
            and np.isfinite(served["feats"]).all()):
        raise AssertionError("the trained chain produced non-finite outputs")
    wanted = {"nerf": ("bundle_loss",), "cors": ("density", "nn_min"), "neg": ("density", "nn_min"),
              "serve": ("density", "nn_min", "corr_argmax")}
    log("launches per stage: " + json.dumps({k: {n: v[n] for n in names} for k, (names, v) in
                                             ((k, (names, counts[k])) for k, names in wanted.items())}))
    for stage, names in wanted.items():
        if not all(counts[stage][n] > 0 for n in names):
            raise AssertionError(f"a kernel of the {stage} stage never launched: {counts[stage]}")

    hits = surface_sampling.sample_surface_hits(
        states[0].fine, h0.R_bop, h0.t_bop, h0.K, h0.sils, n_loops=P["neg_loops"], rays_per_image=50, image_size=S,
        threshold=P["neg_threshold"], generator=torch.Generator(device=dev).manual_seed(P["neg_seed"]))
    fps_timing(hits, "the negatives' surface hits", reps=3)
    cors_kernel_checks(dev, states[0].fine, h0, cors_dirs[0], cors_cfg, S, shapes, counts["cors"])
    cors_vs_plain(dev, states[0].fine, h0, cors_dirs[0], cors_cfg, S, out_dir)


def _state_tensors(path: str) -> list:
    """Every tensor and number of a ``torch.save`` checkpoint, in order."""
    import torch

    out = []
    for v in torch.load(path, map_location="cpu", weights_only=True).values():
        if isinstance(v, dict):
            out += list(v.values())
        elif isinstance(v, list):
            out += v
        else:
            out.append(torch.tensor(v))
    return out


def same_checkpoints(a: str, b: str, names) -> bool:
    import torch

    for name in names:
        ta, tb = _state_tensors(os.path.join(a, name)), _state_tensors(os.path.join(b, name))
        if len(ta) != len(tb) or not all(torch.equal(x, y) for x, y in zip(ta, tb)):
            return False
    return True


class StopTraining(Exception):
    pass


def cli_path(dev, root: str) -> dict:
    """The port's command-line program on the card (``CLI``): each half's
    train-nerf (K4), generate-cors (K1, K2), train-pose and gen-feat (K1,
    K2), then half 0's serving and registration commands, each through
    ``cli.main`` in this process with the kernels' launches counted over
    exactly that command; ``check`` through ``python -m`` in a subprocess;
    an interrupted and resumed train-nerf against the straight run, and
    train-pose on a copy of the experiment against the first, bit for bit.
    Returns {command: launches}."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import cli
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment, checkpoint
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import viz

    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    log(f"CLI phase: Pillow importable: {have_pil}")
    c = CLI
    t_phase = time.perf_counter()

    def base(r, uh):
        return ["--objid", "1", "--dataset", "tless", "--UH", str(uh), "--root", r, "--synthetic", "--synthetic-views",
                str(c["views"]), "--act-dtype", "bfloat16", "--field-preset", "full", "--viz-every", "0",
                "--log-every", "0", *c["flags"]]

    launches, walls = {}, {}

    def run(tag, argv):
        reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        cli.main(argv)
        sync(dev)
        walls[tag], launches[tag] = time.perf_counter() - t0, launch_counts()
        log(f"  cli {tag}: {walls[tag]:.3f} s, launches " + json.dumps(
            {k: v for k, v in launches[tag].items() if v}))

    exp = lambda r, uh: os.path.join(r, f"{uh}_tless_obj_1")  # noqa: E731
    main_root, copy_root, cut_root = (os.path.join(root, n) for n in ("main", "copy", "cut"))
    for uh in (1, 0):
        run(f"train-nerf UH{uh}", ["train-nerf", *base(main_root, uh), "--steps", str(c["nerf_steps"])])
    for uh in (1, 0):
        run(f"generate-cors UH{uh}", ["generate-cors", *base(main_root, uh)])
        if uh == 0:
            shutil.copytree(exp(main_root, 0), exp(copy_root, 0))
        run(f"train-pose UH{uh}", ["train-pose", *base(main_root, uh), "--steps", str(c["pose_steps"])])
        run(f"gen-feat UH{uh}", ["gen-feat", *base(main_root, uh)])
    for cmd, extra in (("poses-est", []), ("inference", []), ("rel-poses", ["--cal-gt", "--cal-pred"]),
                       ("choose-image", []), ("icp", []), ("verify", []), ("check", [])):
        run(cmd, [cmd, *base(main_root, 0), *extra])
    if have_pil:
        run("video", ["video", *base(main_root, 0), "--frames", "4"])

    # the module entry point itself, in a subprocess
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"{PKG}.cli", "check", *base(main_root, 0)], capture_output=True,
                         text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0 or "MISSING" in out.stdout or "vert1_scaled.npy" not in out.stdout:
        raise AssertionError(f"python -m {PKG}.cli check failed ({out.returncode}): {out.stdout}{out.stderr}")
    log(f"  cli check through python -m: {time.perf_counter() - t0:.3f} s (a new process)")

    # exact resume: stopped after the mid-run checkpoint, resumed with --cont
    save_latest = checkpoint.save_latest

    def stop_after(directory, state):
        save_latest(directory, state)
        if state.step == c["resume_at"]:
            raise StopTraining

    checkpoint.save_latest = stop_after
    try:
        cli.main(["train-nerf", *base(cut_root, 1), "--steps", str(c["nerf_steps"])])
        raise AssertionError(f"train-nerf did not stop at its step-{c['resume_at']} checkpoint")
    except StopTraining:
        pass
    finally:
        checkpoint.save_latest = save_latest
    run("train-nerf UH1 --cont", ["train-nerf", *base(cut_root, 1), "--steps", str(c["nerf_steps"]), "--cont"])
    nerf = lambda r: artifacts.nerf_dir(exp(r, 1), 1)  # noqa: E731
    resumed = same_checkpoints(nerf(main_root), nerf(cut_root), (checkpoint.STATE,))

    # reproducible descriptor training: the same command on a copy
    run("train-pose UH0 (copy)", ["train-pose", *base(copy_root, 0), "--steps", str(c["pose_steps"])])
    pose = lambda r: artifacts.pose_dir(exp(r, 0), 1)  # noqa: E731
    repeat = same_checkpoints(pose(main_root), pose(copy_root),
                              (checkpoint.STATE, checkpoint.ENCODER, checkpoint.LATEST))
    repeat &= bool(np.array_equal(np.load(os.path.join(pose(main_root), "negVec.npy")),
                                  np.load(os.path.join(pose(copy_root), "negVec.npy"))))
    log(f"CLI phase: train-nerf stopped after step {c['resume_at']} and resumed with --cont equals the straight "
        f"{c['nerf_steps']}-step run bit for bit: {resumed}; train-pose on a copy of the experiment writes "
        f"bit-identical checkpoints and negatives: {repeat}")

    if have_pil:
        banks = os.path.join(root, "banks")
        g = torch.Generator().manual_seed(0)
        for i in range(3):
            img = torch.zeros((64, 80, 3))
            img[10 + i: 50, 12: 60 + i] = torch.rand((40 - i, 48 + i, 3), generator=g)
            viz.save_image(os.path.join(banks, f"{i}.png"), img.numpy())
        bg = augment.load_background_bank(banks, 224)
        dis_rgb, dis_mask = augment.load_distractor_bank(banks, 224)
        shutil.copytree(exp(copy_root, 0), exp(os.path.join(root, "banked"), 0))
        run("train-pose UH0 --bg-dir --distractor-dir", ["train-pose", *base(os.path.join(root, "banked"), 0),
                                                         "--steps", "3", "--bg-dir", banks, "--distractor-dir", banks])
        log(f"  banks: backgrounds {tuple(bg.shape)}, distractors {tuple(dis_rgb.shape)} / {tuple(dis_mask.shape)}")

    pred_R = np.load(os.path.join(exp(main_root, 0), "1pred_R.npy"))
    keys = artifacts.load_keys(pose(main_root))
    outputs_ok = (pred_R.shape == (c["views"], 3, 3) and np.isfinite(pred_R).all() and keys[0].shape[0] > 0
                  and np.isfinite(keys[1]).all())
    log(f"CLI phase: {time.perf_counter() - t_phase:.1f} s in all; per command (s): "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    wanted = {"train-nerf UH1": ("bundle_loss",), "train-nerf UH0": ("bundle_loss",),
              "generate-cors UH1": ("density", "nn_min"), "generate-cors UH0": ("density", "nn_min"),
              "gen-feat UH1": ("density", "nn_min"), "gen-feat UH0": ("density", "nn_min"),
              "icp": ("nn_min",), "verify": ("nn_min",), "poses-est": ("corr_argmax",),
              "inference": ("corr_argmax", "nn_min")}
    missing = {k: [n for n in names if not launches[k][n]] for k, names in wanted.items()}
    missing = {k: v for k, v in missing.items() if v}
    if missing or not (resumed and repeat and outputs_ok):
        raise AssertionError(f"CLI phase: kernels that never launched {missing}; exact resume {resumed}; "
                             f"reproducible train-pose {repeat}; finite outputs of the right shapes {outputs_ok}")
    return launches


def timed_cli(dev, argv) -> tuple:
    """(wall seconds, kernel launches) of ``cli.main(argv)`` in this process."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import cli

    reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    cli.main(argv)
    sync(dev)
    return time.perf_counter() - t0, launch_counts()


def write_full_frames(dev, ds: str, ids) -> dict:
    """A BOP-layout tless object 1 under ``ds`` from the port's own
    ``render_mesh``: the other half's (UH 1) mesh-scene views of ``ids``
    rendered again as raw ``SURF["frame_size"]`` frames at the scene's focal
    length, the object shifted off-centre by ``SURF["shift"]`` (scene
    units), with rgb, mask and mask_visib PNGs, scene_gt (translations in the
    loader's units, t x diameter / 1.8, as the trained experiment's baked
    cloud), scene_camera, models_info (the CAD cloud's diameter) and an
    ascii PLY of the blob's vertices in those units.  Returns the GT."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import rasterize
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import viz

    c = SURF
    W, H = c["frame_size"]
    n = len(ids)
    # the --synthetic-mesh loader's half 1 (generator seeded with UH), at the
    # smoke's crop size for its focal length
    S = c["crop"]
    scene = mesh_scene.make_mesh_scene(n_views=c["views"], image_size=S,
                                       generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    scale = scene.diameter / 1.8
    R = scene.R_bop[:n]
    t = scene.t_bop[:n] + torch.tensor([*c["shift"], 0.0], device=dev)
    f = float(scene.K[0, 0, 0])
    K = torch.tensor([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]], device=dev)
    verts, faces, colors, normals = (torch.as_tensor(x, device=dev) for x in mesh_scene.blob_mesh())
    cams = cameras.camera_from_bop(R, t, K.expand(n, 3, 3), W)
    rgb, sil, _ = rasterize.render_mesh(verts, faces, colors, normals, cams, W, px_chunk=8192)
    rgb, sil = rgb[:, :H].cpu().numpy(), sil[:, :H].cpu().numpy()
    obj = os.path.join(ds, "train", "000001")
    gts, cams_json = {}, {}
    t_gt = (t * scale).cpu().numpy()
    for a, i in enumerate(ids):
        viz.save_image(os.path.join(obj, "rgb", f"{int(i):06d}.png"), rgb[a])
        for sub in ("mask", "mask_visib"):
            viz.save_image(os.path.join(obj, sub, f"{int(i):06d}_000000.png"), sil[a])
        gts[str(int(i))] = [{"cam_R_m2c": R[a].reshape(-1).tolist(), "cam_t_m2c": t_gt[a].tolist(), "obj_id": 1}]
        cams_json[str(int(i))] = {"cam_K": K.reshape(-1).tolist()}
    with open(os.path.join(obj, "scene_gt.json"), "w") as fh:
        json.dump(gts, fh)
    with open(os.path.join(obj, "scene_camera.json"), "w") as fh:
        json.dump(cams_json, fh)
    cad = scene.verts * scale
    os.makedirs(os.path.join(ds, "models"), exist_ok=True)
    diameter = float(np.linalg.norm(cad.max(0) - cad.min(0)))
    with open(os.path.join(ds, "models", "models_info.json"), "w") as fh:
        json.dump({"1": {"diameter": diameter}}, fh)
    with open(os.path.join(ds, "models", "obj_000001.ply"), "w") as fh:
        fh.write(f"ply\nformat ascii 1.0\nelement vertex {len(cad)}\nproperty float x\nproperty float y\n"
                 f"property float z\nend_header\n" + "".join(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in cad))
    area = sil.reshape(n, -1).sum(1)
    log(f"  full frames: {n} frames {W} x {H}, object pixels {int(area.min())}-{int(area.max())}, CAD diameter "
        f"{diameter:.4f}")
    border = sil[:, 0].sum() + sil[:, -1].sum() + sil[:, :, 0].sum() + sil[:, :, -1].sum()
    if not (area.min() > 5e-3 * W * H and border == 0):
        raise AssertionError("the full frames do not hold the whole object")
    return {"R": R.cpu().numpy(), "t": t_gt, "K": K.cpu().numpy(), "diameter": diameter}


def cdf_drift(dev, seed: int, n: int, m: int, n_draws: int = 40_000) -> dict:
    """The SurfEmb cdf at n pixels x m keys (random queries and keys of the
    trained descriptors' norm, sigmoid mask probabilities, alpha 1.5): the
    share of ``n_draws`` uniform draws whose index moves, against an f64
    running sum of the same f32 entries, for the port's two-level f64 cdf
    and for a single f32 ``torch.cumsum`` (the reference's expression)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf as pes

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((n, 12), generator=g, device=dev)
    k = torch.randn((m, 12), generator=g, device=dev)
    q, k = 3 * q / q.norm(dim=-1, keepdim=True), 3 * k / k.norm(dim=-1, keepdim=True)
    mask_prob = torch.sigmoid(4 * torch.randn((n,), generator=g, device=dev))
    u = torch.rand((n_draws,), generator=g, device=dev)
    _, cdf = pes.correspondence_distribution(q, k, mask_prob, 1.5)
    got = pes.inverse_cdf(cdf, u)
    del cdf
    flat = torch.empty((n, m), device=dev)
    for r0 in range(0, n, pes.ROW_CHUNK):
        rows = slice(r0, r0 + pes.ROW_CHUNK)
        with no_tf32():
            logits = q[rows] @ k.T
        flat[rows] = (torch.exp(torch.log_softmax(logits, 1)) * mask_prob[rows, None]) ** 1.5
    flat = flat.view(-1)
    c64 = torch.cumsum(flat.double(), 0)
    want = torch.searchsorted(c64 / c64[-1], u.double()).clamp_max(n * m - 1)
    del c64
    c32 = torch.cumsum(flat, 0)
    f32 = torch.searchsorted(c32 / c32[-1], u).clamp_max(n * m - 1)
    out = {"port": float((got != want).float().mean()), "f32": float((f32 != want).float().mean()),
           "f32_total_rel": float((c32[-1].double() - flat.double().sum()).abs() / flat.double().sum())}
    del flat, c32
    return out


def sharp_features(p):
    """A high-frequency injective descriptor of surface points, norm 3."""
    import torch

    f = torch.cat([torch.sin(14.0 * p), torch.cos(11.0 * p), torch.sin(17.0 * p.flip(-1)), 2.0 * p], -1)
    return 3.0 * f / f.norm(dim=-1, keepdim=True)


def ideal_view(pts, S: int):
    """A planted pose of the blob's points ``pts`` (M, 3), the camera of an S
    px crop on it and the ideal maps of that view (S, S, 13): the sharp
    keys of each pixel's nearest point and mask logits (+6 on the object,
    -6 off it).  Returns (R, t, K, maps) on the points' device."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import rotvec_to_matrix
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.rasterize import render_object_coords

    dev = pts.device
    R = rotvec_to_matrix(torch.tensor([0.3, -0.2, 0.4], device=dev))
    t = torch.tensor([0.05, -0.03, 4.0], device=dev)
    K = torch.tensor([[2.1 * S, 0.0, S / 2 - 0.5], [0.0, 2.1 * S, S / 2 - 0.5], [0.0, 0.0, 1.0]], device=dev)
    coords, mask = render_object_coords(pts, R, t, K, S)
    maps = torch.cat([sharp_features(coords) * mask[..., None], (mask * 12.0 - 6.0)[..., None]], -1)
    return R, t, K, maps


def ideal_cnn(maps):
    """A CNN stand-in: ``maps`` (S, S, 13) for any image."""
    import torch

    class IdealMaps(torch.nn.Module):
        def forward(self, images):
            return maps[None].expand(images.shape[0], *maps.shape)

    return IdealMaps()


def surf_full_width(dev, seed: int, m: int) -> dict:
    """One SurfEmb image at InferenceConfig() against ``m`` baked keys: the
    ideal query map and mask of a 224 px view of ``m`` points drawn on the
    blob mesh (sharp keys), warm, with its stage seconds and peak device
    memory; returns its stage log and the pose's distance from the planted
    one."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference

    g = torch.Generator(device=dev).manual_seed(seed)
    verts, faces, _, normals = (torch.as_tensor(x, device=dev) for x in mesh_scene.blob_mesh())
    tri = faces[torch.randint(0, faces.shape[0], (m,), generator=g, device=dev).long()].long()
    bary = -torch.log(torch.rand((m, 3), generator=g, device=dev))
    bary = bary / bary.sum(-1, keepdim=True)
    pts = (bary[..., None] * verts[tri]).sum(1)
    nrm = (bary[..., None] * normals[tri]).sum(1)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    S = 224
    R, t, K, maps = ideal_view(pts, S)
    image = torch.zeros((S, S, 3), device=dev)
    args = (ideal_cnn(maps), image, K, pts, nrm, sharp_features(pts), 1.2)
    inference.estimate_pose_surfemb(*args, generator=g)
    inference.STAGE_LOG = []
    try:
        R_e, t_e, _ = inference.estimate_pose_surfemb(*args, generator=g)
        stages = inference.STAGE_LOG[0]
    finally:
        inference.STAGE_LOG = None
    return {**stages, "dR": float((R_e - R).abs().max()), "dt": float((t_e - t).abs().max())}


def surf_kernel_checks(dev, seed: int, shapes: dict):
    """K2 at every launch shape the refiner recorded and K3 at a full
    frame's launch shape (``nn_check`` / ``corr_check``)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    for s in sorted(set(shapes["nn_min"])):
        nn_check(dev, g, *s, what="at the refiner's shape ")
    for s in sorted(set(shapes["corr_argmax"])):
        corr_check(dev, g, *s, what="at a full frame's shape ")


def surf_path(dev, root: str) -> dict:
    """The CLI's SurfEmb, full-frame and mesh-scene paths on the card
    (``SURF``), through ``cli.main`` in this process: train-nerf,
    generate-cors, train-pose and gen-feat of each half on the
    --synthetic-mesh scene (K4, K1, K2); poses-est and inference
    --use-surf-eval of half 0 at InferenceConfig() (K2 in the refiner),
    each image's stage seconds, peak device memory, best score and ADD-S,
    then inference --use-surf-eval again (bit-identical poses) and
    poses-est without it (argmax-PnP, K3); inference --full-frames on raw
    frames written by ``write_full_frames`` (K3, K2); then the kernels at
    the slice's shapes and the cdf at the full shape.  Returns {command:
    launches}."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import cli
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import bop
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, inference

    c = SURF
    t_phase = time.perf_counter()
    main_root, ff_root, bop_root = (os.path.join(root, n) for n in ("main", "ff", "bop"))

    def base(uh):
        return ["--objid", "1", "--dataset", "tless", "--UH", str(uh), "--root", main_root, "--synthetic-mesh",
                "--synthetic-views", str(c["views"]), "--act-dtype", "bfloat16", "--field-preset", "full",
                "--viz-every", "0", "--log-every", "0", *c["flags"]]

    launches, walls = {}, {}

    def run(tag, argv):
        walls[tag], launches[tag] = timed_cli(dev, argv)
        log(f"  surf {tag}: {walls[tag]:.3f} s, launches " + json.dumps({k: v for k, v in launches[tag].items() if v}))

    for uh in (1, 0):
        run(f"train-nerf UH{uh}", ["train-nerf", *base(uh), "--steps", str(c["nerf_steps"])])
    for uh in (1, 0):
        run(f"generate-cors UH{uh}", ["generate-cors", *base(uh)])
        run(f"train-pose UH{uh}", ["train-pose", *base(uh), "--steps", str(c["pose_steps"])])
        run(f"gen-feat UH{uh}", ["gen-feat", *base(uh)])

    exp = os.path.join(main_root, "0_tless_obj_1")
    pose_d = artifacts.pose_dir(exp, 1)
    verts, _, _, n_real = artifacts.load_keys(pose_d, trim=False)
    args0 = cli.build_parser().parse_args(["inference", *base(0)])
    _, _, R_gt, t_gt, _, diam = cli.load_other_half(args0, args0.image_size or 224)
    verts_m = torch.as_tensor(verts[:n_real], dtype=torch.float32, device=dev)
    log(f"  surf: {verts.shape[0]} keys ({n_real} baked), diameter {diam:.4f}")

    def adds_of(R, t):
        return [float(metrics.adds_metric(verts_m, *(torch.as_tensor(x, dtype=torch.float32, device=dev)
                                                     for x in (R_gt[i], t_gt[i], R[i], t[i]))))
                for i in range(len(R))]

    estimate = inference.estimate_pose_surfemb
    poses = []

    def recording(*a, **kw):
        out = estimate(*a, **kw)
        poses.append((out[0].cpu(), out[1].cpu()))
        return out

    def surf_eval(tag, argv):
        inference.STAGE_LOG = []
        try:
            run(tag, argv)
            log_ = inference.STAGE_LOG
        finally:
            inference.STAGE_LOG = None
        return log_

    inference.estimate_pose_surfemb = recording
    try:
        with recorded_launches() as refine_shapes:
            est_log = surf_eval("poses-est --use-surf-eval", ["poses-est", *base(0), "--use-surf-eval"])
        surf_R = np.load(os.path.join(exp, "1pred_R.npy"))
        surf_t = np.load(os.path.join(exp, "1pred_t.npy"))
        inf_log = surf_eval("inference --use-surf-eval", ["inference", *base(0), "--use-surf-eval"])
        first, poses[:] = list(poses), []
        surf_eval("inference --use-surf-eval (again)", ["inference", *base(0), "--use-surf-eval"])
        again = list(poses)
    finally:
        inference.estimate_pose_surfemb = estimate
    run("poses-est (argmax-PnP)", ["poses-est", *base(0)])
    pnp_R, pnp_t = np.load(os.path.join(exp, "1pred_R.npy")), np.load(os.path.join(exp, "1pred_t.npy"))
    surf_adds, pnp_adds = adds_of(surf_R, surf_t), adds_of(pnp_R, pnp_t)
    for tag, stage_log in (("poses-est", est_log), ("inference", inf_log)):
        for i, st in enumerate(stage_log):
            log(f"  surf {tag} image {i}: distribution {st['distribution']:.4f} s, P3P + pruning {st['p3p']:.4f} s, "
                f"scoring {st['scoring']:.4f} s, refinement {st['refinement']:.4f} s, peak device memory "
                f"{st.get('peak_bytes', 0) / 2 ** 30:.3f} GiB, best score {st['best_score']:.5f}"
                + (f", ADD-S {surf_adds[i]:.5f} (argmax-PnP {pnp_adds[i]:.5f}; 0.1 x diameter {0.1 * diam:.5f})"
                   if tag == "poses-est" else ""))
    same = len(first) == len(again) == c["views"] and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(first, again))
    log(f"  surf: inference --use-surf-eval repeated from the same seed gives bit-identical poses: {same}; ADD-S < 0.1 "
        f"x diameter: SurfEmb {sum(a < 0.1 * diam for a in surf_adds)} of {len(surf_adds)}, argmax-PnP "
        f"{sum(a < 0.1 * diam for a in pnp_adds)} of {len(pnp_adds)}")

    # raw frames of the other half for --full-frames, beside a copy of the experiment
    ids = bop.half_sequence_ids("tless", 1)[:c["frames"]]
    write_full_frames(dev, os.path.join(bop_root, "tless"), ids)
    shutil.copytree(exp, os.path.join(ff_root, "0_tless_obj_1"))
    ff_args = ["inference", "--objid", "1", "--dataset", "tless", "--UH", "0", "--root", ff_root, "--bop-root",
               bop_root, "--full-frames", "--fsamps", str(c["frames"]), *c["flags"]]
    with recorded_launches() as ff_shapes:
        run("inference --full-frames", ff_args)
    listed = open(os.path.join(ff_root, "0_tless_obj_1", "1correctly_predicted_list.txt")).read().split()
    log(f"  surf: inference --full-frames: {len(listed)} of {c['frames']} frames correct")

    shapes = {"nn_min": refine_shapes["nn_min"], "corr_argmax": ff_shapes["corr_argmax"][:1]}
    # the refiner's queries: every pixel of a crop
    S_Q = c["crop"] ** 2
    log(f"  surf: K2 launch shapes of the refiner (queries, references, masked: launches): "
        f"{ {str(k): shapes['nn_min'].count(k) for k in sorted(set(shapes['nn_min']))} }; K3 of a full frame "
        f"(queries, keys, width): {shapes['corr_argmax']}")
    surf_kernel_checks(dev, 0, {"nn_min": shapes["nn_min"] + [(S_Q, c["full_keys"], False)],
                                "corr_argmax": shapes["corr_argmax"]})
    full = surf_full_width(dev, 0, c["full_keys"])
    log(f"  surf: one image against {c['full_keys']} keys (InferenceConfig(), warm): distribution "
        f"{full['distribution']:.4f} s, P3P + pruning {full['p3p']:.4f} s, scoring {full['scoring']:.4f} s, refinement "
        f"{full['refinement']:.4f} s, peak device memory {full.get('peak_bytes', 0) / 2 ** 30:.3f} GiB; pose off the "
        f"planted one by {full['dR']:.2e} in R, {full['dt']:.2e} in t")
    n, m = c["cdf_shape"]
    drift = cdf_drift(dev, 0, n, m)
    log(f"  surf: the cdf at {n} x {m}: share of {40_000} draws whose index moves against an f64 running sum: the "
        f"port's two-level f64 cdf {drift['port']:.2e}, a single f32 torch.cumsum {drift['f32']:.2e} (its total "
        f"off by {drift['f32_total_rel']:.2e} relative)")

    log(f"surf phase: {time.perf_counter() - t_phase:.1f} s in all; per command (s): "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    finite = all(np.isfinite(x).all() for x in (surf_R, surf_t, pnp_R, pnp_t)) and np.isfinite(surf_adds).all()
    wanted = {"train-nerf UH1": ("bundle_loss",), "train-nerf UH0": ("bundle_loss",),
              "generate-cors UH1": ("density", "nn_min"), "generate-cors UH0": ("density", "nn_min"),
              "gen-feat UH1": ("density", "nn_min"), "gen-feat UH0": ("density", "nn_min"),
              "poses-est --use-surf-eval": ("nn_min",), "inference --use-surf-eval": ("nn_min",),
              "poses-est (argmax-PnP)": ("corr_argmax",), "inference --full-frames": ("corr_argmax", "nn_min")}
    missing = {k: [x for x in names if not launches[k][x]] for k, names in wanted.items()}
    missing = {k: v for k, v in missing.items() if v}
    finite &= bool(np.isfinite([full["dR"], full["dt"]]).all())
    if missing or not (same and finite and drift["port"] <= c["cdf_moved_max"]):
        raise AssertionError(f"surf phase: kernels that never launched {missing}; repeat bit-identical {same}; "
                             f"finite poses {finite}; cdf draws moved {drift['port']}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", metavar="PATH",
                        help="also profile one serve run (kernel table to PATH) and 20 training steps (PATH.train.txt)")
    parser.add_argument("--nerf-steps", type=int, default=PIPELINE["nerf_steps"],
                        help="NeRF training steps (the bench's 800; the pipeline phase reuses the trained fields when "
                             "it is 800, and trains its own 800 steps otherwise)")
    parser.add_argument("--chunk-steps", type=int, default=100,
                        help="chunked NeRF training steps at the large-batch schedule (the reference runs 200)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, PKG)):
        print(f"chip_smoke: the package {PKG} is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    nvcc_v = _run([nvcc if os.path.exists(nvcc) else "nvcc", "--version"]).splitlines()[-1]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc_v}, python {sys.version.split()[0]}")

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    ext = cuda_build.kernels()
    log(f"built K1-K6 for sm_90a in {time.perf_counter() - t0:.1f} s ({cuda_build.BUILD_DIR})")
    sass_phase(ext.__file__)

    phases = {"density": density_phase(dev, args.seed), "bundle_loss": bundle_loss_phase(dev, args.seed)}
    phases.update(field_color_phase(dev, args.seed))
    train_counts, train_s, train_states = train_path(dev, args.seed, args.nerf_steps, args.profile)
    chunked_counts, _ = chunked_train_path(dev, args.seed, args.chunk_steps, args.profile)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        counts, _, shapes = serve_path(dev, args.seed, out_dir, args.profile)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    phases.update(point_kernel_phase(dev, args.seed, shapes))
    trained = (train_states, train_s, train_counts) if args.nerf_steps == PIPELINE["nerf_steps"] else None
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    try:
        pipeline_path(dev, args.seed, out_dir, trained)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        cli_path(dev, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_surf_")
    try:
        surf_launches = surf_path(dev, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    counts["bundle_loss"] = train_counts["bundle_loss"]
    counts.update({k: chunked_counts[k] for k in ("field_color_fwd", "field_color_bwd")})
    # the surf phase's commands' launches join the paths' counts
    for per_command in surf_launches.values():
        for name, n in per_command.items():
            counts[name] += n
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # no single PyTorch call computes any of these functions: library_ms is null
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name], "replaces": TPU_KERNELS[name],
                "launches": counts[name], **r} for name, r in phases.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
