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
   x 64 / 320 points, both embeddings); K4-K6 once for each activation
   dtype: the float32 variants (``_act32``, ``FieldConfig()``'s default)
   against their float32 plain twins, their loss, EA weights and heads the
   bf16 variants' bit for bit;
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
   cloud (K1 grid, marching tetrahedra) against the analytic surface; then
   a float32-activation field: 10 steps through K5 / K6's float32 variants
   (launches counted) and a step of it against the plain versions;
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
   ``cli.main`` in this process: train-nerf (K4; and half 1's once more at
   the default --act-dtype float32, which must launch K4's float32 variant
   and no other of K4-K6), generate-cors (K1, K2),
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
   timed; the cdf at 5,476 x 80,000 against an f64 running sum;
12. the chain of phase 9 with the softplus MLP feature head (``NOSIREN``,
   ``FieldConfig(siren=False)``, 360 -> 256 -> 12): a SIREN and a
   non-SIREN field from the same trunk, density and colour weights trained
   50 steps on the same draws end with bit-identical non-feature
   parameters; 400 NeRF steps a half (K4), the head bit-identical after
   them; generate_cors (K1, K2), negatives (K1, K2), 100 descriptor steps
   (the loss must fall), the bake (K1, K2), inference (K3), verification
   and ICP (K2); the baked keys strictly inside (0, 1); stage times, warm
   ms a descriptor step (``utils.profiling.StepTimer``) and ADD;
13. the multi-device layer (``MESH``, ``parallel/mesh.py``): on a mesh of
   the one card twice, or of every card where there are several, each
   entry point that takes a mesh against the same call without one, each
   stage's wall seconds both ways and its launches on the mesh by kernel
   and device (every kernel of a stage on every device, at the count its
   split gives): 4 fused NeRF steps, each run on the mesh from the
   unsharded run's state before it (summed grads, loss and params against
   the unsharded step's), then ``train_nerf_fused`` 100 steps (K4 on each
   entry's rays) and K4 on each entry's share of one step against its
   plain version on that entry's device; 2 such forced chunked steps, K5 /
   K6 on each entry's chunks against their plain versions there, then
   chunked ``train_nerf`` 10 steps; ``generate_cors`` of half 0
   (bit-identical artifacts; K1, K2 per entry); ``nn_query`` at its mesh
   filter's shape (bit-identical); ``verify_consecutive`` and
   ``register_halves`` (K2); ``run_sequence`` on 8 images (UNet, K3 and
   RANSAC per entry), then K3 on each entry's share against its plain
   version; 20 ``train_pose`` steps, twice on the mesh bit-identical, and
   2 forced descriptor steps on 4 views over 3 entries (2 + 1 + 1); one
   SurfEmb image's hypotheses with ``hyp_mesh``.

Phases 1-12 measure one card: inside them ``mesh="auto"`` resolves to no
mesh, on a host with several cards too.

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
# K4-K6's float32-activation variants (a field's act_dtype "float32",
# FieldConfig()'s default): their own tile kernels and launch names, the
# same TPU kernels replaced, the same sources
ACT32 = {"bundle_loss": "bundle_loss_act32", "field_color_fwd": "field_color_fwd_act32",
         "field_color_bwd": "field_color_bwd_act32"}
TPU_KERNELS.update({v: TPU_KERNELS[k] for k, v in ACT32.items()})
SOURCES = {
    "density": f"{PKG}/ops/csrc/density.cu",
    "nn_min": f"{PKG}/ops/csrc/nn_min.cu",
    "corr_argmax": f"{PKG}/ops/csrc/corr_argmax.cu",
    "bundle_loss": f"{PKG}/ops/csrc/bundle_loss.cu",
    "field_color_fwd": f"{PKG}/ops/csrc/field_color.cu",
    "field_color_bwd": f"{PKG}/ops/csrc/field_color.cu",
}
SOURCES.update({v: SOURCES[k] for k, v in ACT32.items()})
# the device functions of each kernel in the built extension (K4 and K6 are
# two each: the tile kernel and the weight-grad contraction kernel they
# share; each float32-activation variant has a tile kernel of its own)
DEVICE_FUNCTIONS = {
    "density": ("density_kernel",),
    "nn_min": ("nn_min_kernel", "nn_min_merge_kernel"),
    "corr_argmax": ("corr_argmax_kernel", "corr_argmax_merge_kernel"),
    "bundle_loss": ("bundle_loss_kernel", "dw_kernel"),
    "field_color_fwd": ("field_color_fwd_kernel",),
    "field_color_bwd": ("field_color_bwd_kernel", "dw_kernel"),
    "bundle_loss_act32": ("bundle_loss_act32_kernel", "dw_kernel"),
    "field_color_fwd_act32": ("field_color_fwd_act32_kernel",),
    "field_color_bwd_act32": ("field_color_bwd_act32_kernel", "dw_kernel"),
}
# their products must run on the tensor cores
TENSOR_CORE_KERNELS = ("density", "bundle_loss", "field_color_fwd", "field_color_bwd", *ACT32.values())
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
# warmup min(300, steps // 3), seed 1; the resume check's step count and
# the steps of the float32-activation field's run (K5 / K6's variants)
CHUNKED = {"n_views": 8, "image_size": 224, "n_rays": 800, "batch": 6, "seed": 1, "resume_steps": 10,
           "act32_steps": 10}
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
PIPELINE = {"nerf_steps": 800, "pose_steps": 200, "timed_pose_steps": 12, "neg_loops": 20, "neg_threshold": 0.2,
            "neg_seed": 0, "pose_seed": 1, "cors": {"density_threshold": 0.2}, "pose": {"warmup_steps": 100},
            "aug": {"crop_res": 224, "min_mask_sum": 10.0, "p_distractor": 0.5, "scale_jitter": 0.15,
                    "trans_frac": 0.2}}
# the command-line program's phase: the synthetic scene's 8 views a half, a
# full-width bf16 field (the field kernels; and one train-nerf at the CLI's
# default float32 activations, K4's variant), 400 NeRF steps a half (the CLI's
# checkpoint every 100), 100 descriptor steps, the CLI's defaults otherwise;
# the resume check stops its run after the step-200 checkpoint
CLI = {"views": 8, "nerf_steps": 400, "pose_steps": 100, "resume_at": 200, "flags": []}
# the CLI phase's train-nerf of half 1 at the CLI's default --act-dtype
CLI_DEFAULT_ACT = "train-nerf UH1 --act-dtype float32 (default)"
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
# the chain with the softplus MLP feature head (FieldConfig(siren=False), 360
# -> 256 -> 12 at full width): the synthetic scene of bench.py:239-254 (8 views
# a half at 224 px, 3 cams x 400 rays), the CLI phase's depth (400 NeRF steps a
# half, warmup min(300, 400 // 3), 100 descriptor steps), the pipeline phase's
# settings otherwise; the head's no-effect check trains both heads 50 steps
NOSIREN = {"nerf_steps": 400, "warmup": 133, "pose_steps": 100, "same_steps": 50}

# the mesh phase (``mesh_path``): the entry points that take a device mesh,
# each run on the mesh and unsharded from the same inputs.  With one card
# the mesh holds it twice (every shard's launches on it), with k >= 2 cards
# it is ``make_mesh(k)``.  NeRF training at TRAIN's settings (both halves,
# 3 cams x 400 rays: 4 forced steps, then 100 steps), the chunked step at
# CHUNKED's (4,800 rays: 2 forced steps, then 10 steps), generate_cors of
# half 0 on the train phase's field, K2 at its mesh-filter shape,
# verification and ICP, 8 images of inference, 20 descriptor steps at the
# chain's settings and 2 forced steps on 4 views over 3 entries (2 + 1 +
# 1), and one SurfEmb image's hypotheses at InferenceConfig() against
# 6,144 keys.  A forced step runs on the mesh from the unsharded run's
# state before it (``forced_steps``), so each sharded step is held to one
# unsharded step whatever the steps before it did
MESH = {"nerf_steps": 100, "forced_steps": 4, "forced_chunk_steps": 2, "forced_pose_steps": 2, "chunk_steps": 10,
        "pose_steps": 20, "n_infer": 8, "icp_iters": 20, "surf_keys": 6_144}
# the reference's bars for its sharded-against-single checks
# (tests/test_parallel_pipeline.py): NeRF losses rtol 1e-4, params rtol 1e-3
# / atol 2e-5, descriptor losses rtol 5e-3, poses rtol 1e-4 / atol 1e-5,
# ICP 1e-4.  A forced step's loss is held to rtol 1e-4, its summed grads to
# 1e-4 of each tensor's max |g| plus 1e-5 of every grad's max (the shards
# sum in another f32 order than one launch; a shard weighted wrongly moves
# its whole share), and its params to the reference's bar but where the
# unsharded grad is within the grads' bar of 0: Adam's update (~ the rate
# times sign(g) early on) may go the other way there, so those elements
# are held to twice the step's rate (``step_matches``).  A forced step
# moves a param by about its rate (2e-5 at NeRF's first step, 1.5e-7 at
# the descriptor's), at or under the reference's atol, so the grads carry
# most of the check.  The forced descriptor steps run the full-width CNN
# in f32: in bf16 it convolves 1, 2 or 4 views per entry, cuDNN picks its
# algorithm by shape, and the bf16 roundings part the summed grads by
# 6.2e-2 and 1.3e-1 of a tensor's max at steps 1 and 2 (one H100, the
# losses 1e-8 apart), more than a share weighted wrongly (1/3 for 1/2 or
# 1/4) would show against.  The whole runs: the sign flips
# feed the fine pass's resampled depths and the runs part step by step
# (the losses of a free 4-step run by 1.4e-4 rel at step 4 on 4 cards,
# against the reference's 1e-4 bar, and by 10.3 of a ~300 loss within 100
# steps, as K5 / K6 and their plain versions part in the chunked phase): a
# run is held by its first loss, the mean of its last steps (within 10 %)
# and Adam's bound on its params (within 2.01 x the summed rates), and the
# step where its losses part and the share of params outside the
# reference's bar are reported
MESH_TOL = {"loss": 1e-4, "param_rtol": 1e-3, "param_atol": 2e-5, "last_mean": 0.1, "rates": 2.01, "grad": 1e-4,
            "pose_loss": 5e-3, "pose_R": 1e-5, "pose_t": 1e-4, "icp": 1e-4}


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


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches, by kernel name."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel, point_kernels

    return {"density": field_kernel.density_cuda, "nn_min": point_kernels.nn_min_cuda,
            "corr_argmax": point_kernels.correspondence_argmax_cuda, "bundle_loss": field_kernel.bundle_loss_cuda,
            "field_color_fwd": field_kernel.field_color_fwd_cuda, "field_color_bwd": field_kernel.field_color_bwd_cuda}


def launch_counts():
    """Each kernel's launches since the last reset, by launch name: K4-K6's
    float32-activation variants apart from the bf16 ones."""
    return {name: w.by_name.get(name, 0) for base, w in kernel_wrappers().items()
            for name in (base, *([ACT32[base]] if base in ACT32 else []))}


def reset_launch_counts():
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build

    for w in kernel_wrappers().values():
        cuda_build.reset(w)


def profile_run(run, path: str, what: str):
    """``run()`` once more under torch.profiler (``utils.profiling.trace``,
    its Chrome trace into ``path``.trace/): device time by kernel to
    ``path``, and the card's busy share of the wall seconds ``run`` returns."""
    from torch.autograd import DeviceType

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import profiling

    with profiling.trace(path + ".trace") as prof:
        wall_s = run()
    events = prof.key_averages()
    # device-side events only (kernels, copies): CPU ops repeat their kernels' time
    busy_ms = sum(e.self_device_time_total for e in events if e.device_type != DeviceType.CPU) / 1e3
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"profiled {what}: device busy {busy_ms:.1f} ms of {1e3 * wall_s:.1f} ms "
        f"({100 * busy_ms / (1e3 * wall_s):.1f}%), kernel table in {path}")


def train_inputs(dev, seed: int, halves=None):
    """The two synthetic halves at the bench's NeRF size (``halves``, or
    ``synthetic_halves`` of ``seed``), stacked on a leading half axis, on
    the card."""
    import torch

    halves = halves or synthetic_halves(dev, seed)
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


def bundle_loss_phase(dev, seed: int, act_dtype: str):
    """K4 (the variant of ``act_dtype``) against its plain version at the
    train step's own shapes: both halves in one launch, the coarse pass (64
    points, with the EA weights) and the fine pass (320 points, resampled
    from the kernel's weights), full-width random fields (density bias 0),
    both embeddings, targets from the synthetic scene; the float32
    variant's loss and EA weights must be the bf16 variant's bit for bit
    (one forward).  Returns the worst scaled grad error and the times and
    bound of the direct embedding's two passes (one step)."""
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
    name = ACT32["bundle_loss"] if act_dtype == "float32" else "bundle_loss"
    for embed in ("direct", "grouped"):
        cfg = FieldConfig(**{**FIELD, "act_dtype": act_dtype}, embed_method=embed)
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
            ms, got = cuda_ms(lambda: fk.bundle_loss_cuda(pts, *rest, want_w, act_dtype))
            plain_ms, want = cuda_ms(lambda: fk.bundle_loss_plain(pts, *rest, want_w, act_dtype), reps=1)
            again = fk.bundle_loss_cuda(pts, *rest, want_w, act_dtype)
            if act_dtype != "bfloat16":
                _, loss16, w16 = fk.bundle_loss_cuda(pts, *rest, want_w, "bfloat16")
                if not (torch.equal(got[1], loss16) and (w16 is None or torch.equal(got[2], w16))):
                    raise AssertionError(f"{name}: loss or EA weights differ from the bf16 variant's ({embed} {tag})")
                del loss16, w16
            # the function's work: the field forward once, the backward's
            # products and contractions (the kernel's recompute of the
            # forward is its own choice and not counted)
            H, E, nh = pts.shape[0], weights[0].shape[1], weights[2].shape[-1]
            n_pts, ff = pts.shape[0] * N * pts.shape[2], field_flops(E, nh)
            n_bytes = n_pts * (12 + 4 * want_w) + H * N * (12 + 32) + 2 * H * weight_bytes(E, nh)
            n_ops = n_pts * (ff["fwd"] + ff["bwd"]) + H * N * 2 * ff["ray"]
            b = bound(n_bytes, n_ops, BF16_FLOPS)
            log(f"K4 {name} {embed} {tag}: 2 halves x {N} rays x {pts.shape[2]} points; kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}, {n_ops / 1e12:.3f} TFLOP)"
                + ("; loss and EA weights the bf16 variant's bit for bit" if act_dtype != "bfloat16" else ""))
            if embed == "direct":
                step_bytes, step_ops = step_bytes + n_bytes, step_ops + n_ops
            worst = max(worst, compare_bundle(f"{name} {embed} {tag}", got, want, again))
            step_ms[(embed, tag)] = (ms, plain_ms)
            if want_w:
                z["fine"] = raymarch.importance_resample(lengths, got[2], render.n_pts_fine, u=r["u_pdf"])
            del got, want, again
    ms = step_ms[("direct", "coarse")][0] + step_ms[("direct", "fine")][0]
    plain_ms = step_ms[("direct", "coarse")][1] + step_ms[("direct", "fine")][1]
    b = bound(step_bytes, step_ops, BF16_FLOPS)
    log(f"K4 {name} per train step (direct, coarse + fine): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{b[0]:.3f} ms ({b[1]}); worst grad error / block max |g| over all passes {worst:.2e} (tol "
        f"{TOL['grad_scaled']})")
    return result(worst, ms, plain_ms, b)


def kernel_step_vs_plain_step(states, data, dev, seed: int, render, train, tag: str, whole_step: bool):
    """One train step with K4 and one with its plain version, from copies
    of the same states, on the same batch and draws.  The coarse fields'
    grads must agree.  The fine pass resamples its depths from the coarse
    weights, and the inverse cdf magnifies their differences where a cdf
    segment is thin, which is rare at a fresh init and common on a trained
    surface: ``whole_step`` holds the loss, the fine grads and the updated
    params to the bars as well; otherwise they are reported.  The fine pass
    itself is held on the depths resampled from K4's coarse weights: K4
    against its plain version there on the fine fields (``compare_bundle``).
    Returns the largest grad error held (max err / tensor max |g|)."""
    import copy

    import torch

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
    cfg = states[0].coarse.cfg
    pts = (r["o"][:, :, None] + r["d"][:, :, None] * r["lengths"][..., None]).contiguous()
    weights = tuple(torch.stack(x) for x in zip(*(fk.loss_weights(st.coarse) for st in states)))
    fm = torch.from_numpy(fk.fmat_of(cfg)).to(dev)
    rest = (r["dn"], r["tgt"], fm, weights, fk.ladder_of(cfg), cfg.softplus_beta, train.huber_scaling, 1.0, True,
            cfg.act_dtype)
    z = [raymarch.importance_resample(r["lengths"], op(pts, *rest)[2], render.n_pts_fine, u=r["u_pdf"])
         for op in (fk.bundle_loss_cuda, fk.bundle_loss_plain)]
    dz = (z[0] - z[1]).abs()
    fine_pts = (r["o"][:, :, None] + r["d"][:, :, None] * z[0][..., None]).contiguous()
    fine_w = tuple(torch.stack(x) for x in zip(*(fk.loss_weights(st.fine) for st in states)))
    fine_rest = (*rest[:3], fine_w, *rest[4:-2], False, cfg.act_dtype)
    fine_own = compare_bundle(f"{tag} state's fine pass on K4's resampled depths",
                              *(op(fine_pts, *fine_rest) for op in (fk.bundle_loss_cuda, fk.bundle_loss_plain,
                                                                     fk.bundle_loss_cuda)))
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
    return max(fine_own, *(err.values() if whole_step else [err["coarse"]]))


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


def field_color_pair(fwd, g, what: str, reps: int = 10):
    """K5 on ``fwd`` (its wrapper's arguments, the activation dtype last)
    against its plain version and a second launch, then K6 on K5's own
    records and outputs with random cotangents from ``g`` likewise; raises
    unless both are within their bounds.  The float32 variant's residuals
    h1, h2, c1 are compared rounded to bf16, as the bf16 variant stores
    them (f32 sums in another order move each f32 value), and its heads
    must be the bf16 variant's bit for bit.  Returns (K5's dens / rgb max
    abs err, K6's grad max err / block max |g|, (K5 ms, plain ms), (K6 ms,
    plain ms), (dens, rgb))."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk

    dn, fm, weights, ladder, beta, act = fwd[1:]
    ms, (dk, rk, res_k) = cuda_ms(lambda: fk.field_color_fwd_cuda(*fwd), reps=reps)
    plain_ms, (dp, rp, res_p) = cuda_ms(lambda: fk.field_color_fwd_plain(*fwd), reps=1)
    dk2, rk2, res_k2 = fk.field_color_fwd_cuda(*fwd)
    if act != "bfloat16":
        d16, r16, _ = fk.field_color_fwd_cuda(*fwd[:-1], "bfloat16")
        if not (torch.equal(dk, d16) and torch.equal(rk, r16)):
            raise AssertionError(f"K5's float32 variant: dens / rgb differ from the bf16 variant's ({what})")
        del d16, r16
    err = max(float((dk - dp).abs().max()), float((rk - rp).abs().max()))
    rounded = {k: (res_k[k].to(torch.bfloat16), res_p[k].to(torch.bfloat16)) for k in fk.RESIDUALS}
    res_share = max(float((a != b).float().mean()) for a, b in rounded.values())
    # each head reads one rounded residual (dens h1, rgb c1): from K5's own
    # it must agree to f32 sums, and move by more than 1e-4 only where that
    # residual differs from the plain version's
    own_heads = fk.field_color_heads(res_k, weights, beta)
    heads = {"dens": (dk, dp, "h1", own_heads[0]), "rgb": (rk, rp, "c1", own_heads[1])}
    off, flip, own, unexplained = {}, {}, {}, 0
    for name, (got, want, src, from_own) in heads.items():
        moved = ((got - want).abs() > 1e-4).any(-1)
        flipped = (rounded[src][0] != rounded[src][1]).any(-1)
        off[name], flip[src] = float(moved.float().mean()), float(flipped.float().mean())
        own[name] = float((got - from_own).abs().max())
        unexplained += int((moved & ~flipped).sum())
    del heads, own_heads, moved, flipped, from_own, rounded
    same = (torch.equal(dk, dk2) and torch.equal(rk, rk2)
            and all(torch.equal(res_k[k], res_k2[k]) for k in fk.RESIDUALS))
    del dp, rp, res_p, dk2, rk2, res_k2
    log(f"K5 {fk._variant('field_color_fwd', act == 'float32')} {what} (dens std {float(dk.std()):.3f}): dens / rgb "
        f"max abs err {err:.3e} (tol "
        f"{TOL['color_abs']}); residuals not bit-equal {res_share:.2e} (tol {TOL['res_share']}); points off > 1e-4: "
        f"dens {off['dens']:.2e}, rgb {off['rgb']:.2e}; points whose h1 / c1 is not bit-equal {flip['h1']:.2e} / "
        f"{flip['c1']:.2e}; off where the residual is equal: {unexplained}; dens / rgb from K5's own h1 / c1 max abs "
        f"err {own['dens']:.2e} / {own['rgb']:.2e} (tol {TOL['head_own']}); second launch bit-identical: {same}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if not (err <= TOL["color_abs"] and res_share <= TOL["res_share"] and same
            and max(own.values()) <= TOL["head_own"] and unexplained == 0 and float(dk.std()) > 1e-3):
        raise AssertionError(f"K5 disagrees with its plain version ({what})")
    bwd = (dn, fm, weights, res_k, dk, rk, torch.randn(dk.shape, generator=g, device=dk.device),
           torch.randn(rk.shape, generator=g, device=dk.device), ladder, beta, act)
    bms, gk = cuda_ms(lambda: fk.field_color_bwd_cuda(*bwd), reps=reps)
    plain_bms, gp = cuda_ms(lambda: fk.field_color_bwd_plain(*bwd), reps=1)
    gk2 = fk.field_color_bwd_cuda(*bwd)
    errs = {name: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)
            for name, a, b in zip(fk.LOSS_BLOCKS, gk, gp)}
    bad = max(errs, key=errs.get)
    same = all(torch.equal(a, b) for a, b in zip(gk, gk2))
    log(f"K6 {fk._variant('field_color_bwd', act == 'float32')} {what}: grad max err / block max |g| {errs[bad]:.2e} "
        f"({bad}, tol "
        f"{TOL['grad_scaled']}); second launch bit-identical: {same}; kernel {bms:.3f} ms, plain {plain_bms:.3f} ms")
    if not (errs[bad] <= TOL["grad_scaled"] and same):
        raise AssertionError(f"K6 disagrees with its plain version ({what})")
    return err, errs[bad], (ms, plain_ms), (bms, plain_bms), (dk, rk)


def field_color_phase(dev, seed: int, act_dtype: str):
    """K5 and K6 (the variants of ``act_dtype``) against their plain
    versions at a chunk's shapes (``FIELD_COLOR_SHAPES``, one half),
    full-width random fields (density bias 0), both embeddings.  K6 runs on
    K5's own records and outputs with random cotangents.  Returns {launch
    name: result}, the times summed over the four shapes of the direct
    embedding: one 4,800-ray chunked step's launches (2 chunks x 2
    passes)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk

    worst = {"field_color_fwd": 0.0, "field_color_bwd": 0.0}
    step_ms = {"field_color_fwd": [0.0, 0.0], "field_color_bwd": [0.0, 0.0]}
    work = {"field_color_fwd": [0, 0], "field_color_bwd": [0, 0]}  # bytes, operations of one chunked step
    chunk_ms = {}  # (rays, name) -> kernel ms of the chunk's two passes, direct embedding
    for embed in ("direct", "grouped"):
        cfg = FieldConfig(**{**FIELD, "act_dtype": act_dtype}, embed_method=embed)
        field = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(seed + 20))
        torch.nn.init.zeros_(field.density_layer.bias)
        weights = tuple(b[None] for b in fk.loss_weights(field.to(dev)))
        fm = torch.from_numpy(fk.fmat_of(cfg)).to(dev)
        ladder, beta = fk.ladder_of(cfg), cfg.softplus_beta
        for R, P in FIELD_COLOR_SHAPES:
            pts, dn = chunk_rays(dev, R, P, seed + R + P)
            fwd = (pts, dn, fm, weights, ladder, beta, act_dtype)
            err, bad_err, (ms, plain_ms), (bms, plain_bms), (dk, rk) = field_color_pair(
                fwd, torch.Generator(device=dev).manual_seed(seed + R), f"{embed} {R} rays x {P} points")
            worst["field_color_fwd"] = max(worst["field_color_fwd"], err)
            worst["field_color_bwd"] = max(worst["field_color_bwd"], bad_err)
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
            del dk, rk
    bounds = {name: bound(*work[name], BF16_FLOPS) for name in work}
    act = ", float32 activations" if act_dtype == "float32" else ""
    for R in sorted({r for r, _ in FIELD_COLOR_SHAPES}, reverse=True):
        log(f"K5 / K6 per {R}-ray chunk (direct, 64 + 320 points{act}): K5 {chunk_ms[(R, 'field_color_fwd')]:.3f} "
            f"ms, K6 {chunk_ms[(R, 'field_color_bwd')]:.3f} ms")
    log(f"K5 / K6 per chunked step (direct, 4,096 + 704 rays x (64 + 320) points{act}): K5 kernel "
        f"{step_ms['field_color_fwd'][0]:.3f} ms, plain "
        f"{step_ms['field_color_fwd'][1]:.3f} ms, bound {bounds['field_color_fwd'][0]:.3f} ms "
        f"({bounds['field_color_fwd'][1]}); K6 kernel {step_ms['field_color_bwd'][0]:.3f} ms, plain "
        f"{step_ms['field_color_bwd'][1]:.3f} ms, bound {bounds['field_color_bwd'][0]:.3f} ms "
        f"({bounds['field_color_bwd'][1]})")
    return {(ACT32[name] if act_dtype == "float32" else name): result(worst[name], *step_ms[name], bounds[name])
            for name in worst}


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
    kernels' (single steps agree within the bars, many steps need not).
    Then a float32-activation field (``FieldConfig()``'s default):
    ``act32_steps`` steps with K5 / K6's float32 variants counted over
    exactly that run, and a step of it against the plain versions.
    Returns the launches of both runs and the bf16 run's ms a step."""
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

    def run(steps: int, field_cfg=cfg, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = nerf_trainer.train_nerf(*data, field_cfg, render, train, n_steps=steps, seed=c["seed"], device=dev,
                                      **kw)
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

    # the float32-activation field: K5 / K6's float32 variants, and nothing else of K4-K6
    cfg32 = FieldConfig(**{**FIELD, "act_dtype": "float32"})
    n32 = c["act32_steps"]
    run(1, field_cfg=cfg32)
    reset_launch_counts()
    (_, losses32), wall32 = run(n32, field_cfg=cfg32)
    counts32 = launch_counts()
    want32 = {name: 2 * n_chunks * n32 if name in (ACT32["field_color_fwd"], ACT32["field_color_bwd"]) else 0
              for name in counts32 if name not in SERVE_KERNELS}
    log(f"chunked NeRF training at float32 activations, 1 half x {n32} steps: warm {1e3 * wall32 / n32:.2f} ms per "
        f"step; launches " + json.dumps({k: v for k, v in counts32.items() if v}))
    if {k: counts32[k] for k in want32} != want32 or not np.isfinite(np.asarray(losses32)).all():
        raise AssertionError(f"float32-activation chunked run: expected launches {want32}, counted {counts32}")
    fresh32 = nerf_trainer.init_state(cfg32, train, torch.Generator().manual_seed(c["seed"]), device=dev)
    chunked_step_vs_plain_step(fresh32, data, dev, render, train, "initial float32-activation", whole_step=True)
    counts.update({k: counts32[k] for k in (ACT32["field_color_fwd"], ACT32["field_color_bwd"])})

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


def corr_compare(q, k, what: str, timed: bool = False):
    """K3 on queries ``q`` and keys ``k``: conf within TOL["corr_argmax"] of
    its plain version, indices equal but at logit ties, a second launch bit
    for bit (raises otherwise); ``timed``: as a CUDA graph replay.  Returns
    (conf error, ms, plain ms, bound), the times None unless ``timed``."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk

    n, m, e = q.shape[0], k.shape[0], k.shape[1]
    if timed:
        ms, (i_k, c_k) = graph_ms(lambda: pk.correspondence_argmax_cuda(q, k))
        plain_ms, (i_p, c_p) = cuda_ms(lambda: pk.correspondence_argmax_plain(q, k), reps=1)
    else:
        ms = plain_ms = None
        i_k, c_k = pk.correspondence_argmax_cuda(q, k)
        i_p, c_p = pk.correspondence_argmax_plain(q, k)
    i_2, c_2 = pk.correspondence_argmax_cuda(q, k)
    err = float((c_k - c_p).abs().max())
    diff = i_k != i_p
    tie_gap = float(((q[diff] * k[i_k[diff].long()]).sum(-1)
                     - (q[diff] * k[i_p[diff].long()]).sum(-1)).abs().max()) if bool(diff.any()) else 0.0
    again = torch.equal(i_2, i_k) and torch.equal(c_2, c_k)
    b = corr_bound(n, m, e)
    times = f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]})" if timed else ""
    log(f"K3 corr {what}{n} x {m} x {e} ({pk.launch_plan(n, m, q.device, 'corr_argmax')[0]} splits): conf "
        f"max_abs_err {err:.3e} (tol {TOL['corr_argmax']}), index mismatches {int(diff.sum())} (logit gap "
        f"{tie_gap:.2e}), second launch bit-identical {again}{times}")
    if not (err <= TOL["corr_argmax"] and float(diff.float().mean()) < 1e-3 and tie_gap < 1e-5 and again):
        raise AssertionError(f"K3 disagrees with its plain version or itself at {what}{n} x {m} x {e}")
    return err, ms, plain_ms, b


def corr_check(dev, g, n: int, m: int, e: int, what: str = ""):
    """K3 at one shape on random inputs from ``g`` (``corr_compare``,
    timed).  Returns (conf error, ms, plain ms, bound)."""
    import torch

    return corr_compare(torch.randn((n, e), generator=g, device=dev), torch.randn((m, e), generator=g, device=dev),
                        what, timed=True)


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
    filter (those rays' hits against the unpadded a1), bit-identical.
    Returns each kernel's max abs error."""
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
    err_max = float(err.max())
    if not (err_max <= TOL["density"] and share < TOL["density_share"] and same):
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
    return {"density": float(err_max), "nn_min": float((d_k - d_p).abs().max())}


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


def synthetic_halves(dev, seed: int):
    """The bench's two synthetic halves (``TRAIN``'s views and size) on the card."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic

    return [synthetic.make_scene(TRAIN["n_views"], TRAIN["image_size"],
                                 torch.Generator(device=dev).manual_seed(seed + uh), device=dev) for uh in (0, 1)]


def train_halves(dev, halves, cfg, n_steps: int, warmup: int, init_states=None):
    """``train_nerf_fused`` of both halves at ``TRAIN``'s settings (seed 1):
    (states, wall seconds, launch counts of exactly that run)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import NerfTrainConfig, RenderConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    data = train_inputs(dev, 0, halves)
    train = NerfTrainConfig(warmup_steps=warmup, batch_size=TRAIN["batch"])
    reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    states, _ = nerf_trainer.train_nerf_fused(*data.values(), cfg, RenderConfig(n_rays_per_image=TRAIN["n_rays"]), train,
                                              n_steps=n_steps, seed=TRAIN["seed"], device=dev,
                                              init_states=init_states)
    sync(dev)
    return states, time.perf_counter() - t0, launch_counts()


def chain_stages(dev, seed: int, out_dir: str, halves, fields_, pose_steps: int, stages: dict, counts: dict,
                 tag: str) -> dict:
    """The bench's chain after NeRF training on the trained fine fields
    ``fields_`` (one a half): generate_cors of each half, negatives,
    descriptor training, and the serving stages on the trained feature head
    and CNN.  Each stage's wall seconds go into ``stages``, its launches
    into ``counts`` and the launch shapes of K1 / K2 / K3 into the returned
    "shapes" (``recorded_launches``, per stage).  Warm ms a descriptor step
    comes from a separate short run with each step timed by
    ``profiling.StepTimer`` (a device sync a step), so ``pose_s`` holds no
    sync of its own.  The gates (hits on the mesh, the loss falls, only the
    head moves, finite outputs, every stage's kernels launch) raise."""
    import dataclasses

    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import CorsConfig, PoseTrainConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, generate_cors
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment, pose_trainer
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import profiling

    P, S, V = PIPELINE, TRAIN["image_size"], TRAIN["n_views"]
    cors_cfg = CorsConfig(**P["cors"])
    timing = os.environ.get("CORS_TIMING")
    os.environ["CORS_TIMING"] = "1"
    reset_launch_counts()
    shapes = {}
    try:
        with recorded_launches() as shapes["cors"]:
            t0 = time.perf_counter()
            cors_dirs = [generate_cors.generate_cors(fields_[uh], h.R_bop, h.t_bop, h.K, h.sils,
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
    with recorded_launches() as shapes["neg"]:
        neg = pose_trainer.build_negatives(fields_[0], h0.R_bop, h0.t_bop, h0.K, h0.sils, a1, pose_cfg,
                                           image_size=S, n_loops=P["neg_loops"], threshold=P["neg_threshold"],
                                           generator=torch.Generator(device=dev).manual_seed(P["neg_seed"]),
                                           device=dev)
        sync(dev)
    stages["neg_s"], counts["neg"] = time.perf_counter() - t0, launch_counts()
    log(f"neg_s {stages['neg_s']:.3f} s: n_neg {neg.shape[0]} (surface-hit loops {P['neg_loops']}, a1 "
        f"{a1.shape[0]} points)")

    aug_cfg = augment.AugmentConfig(**P["aug"])
    bank = pose_trainer.load_ray_bank(cors_dirs[0], S, V, device=dev)

    def run_pose(n: int, timer=None):
        """``n`` descriptor steps; with ``timer``, a checkpoint hook after
        every step closes the timer's step and opens the next."""
        cfg, hook = pose_cfg, None
        if timer is not None:
            cfg = dataclasses.replace(pose_cfg, ckpt_every=1)

            def hook(state, step):
                timer.__exit__(None, None, None)
                timer.__enter__()

        sync(dev)
        t = time.perf_counter()
        if timer is not None:
            timer.__enter__()
        out = pose_trainer.train_pose(fields_[0], h0.images, h0.sils, bank, neg, cfg=cfg, aug_cfg=aug_cfg,
                                      n_steps=n, seed=P["pose_seed"], on_checkpoint=hook, device=dev)
        sync(dev)
        return out, time.perf_counter() - t

    _, cold_s = run_pose(1)
    timer = profiling.StepTimer(device=dev)
    run_pose(P["timed_pose_steps"], timer)
    reset_launch_counts()
    (pstate, losses), stages["pose_s"] = run_pose(pose_steps)
    counts["pose"] = launch_counts()
    losses = np.asarray(losses)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    trunk_same = torch.equal(pstate.field.trunk1.weight, fields_[0].trunk1.weight)
    # the head's output weight: SIREN's feature_layer.out, or feat2
    head_moved = not torch.equal(pose_trainer.head_params(pstate.field)[-2], pose_trainer.head_params(fields_[0])[-2])
    log(f"pose_s {stages['pose_s']:.3f} s: {pose_steps} descriptor steps ({min(pose_cfg.batch_size, V)} views x "
        f"{pose_cfg.sample_size} samples, {bank.pos_vec.shape[1]} bank rows a view), "
        f"{1e3 * stages['pose_s'] / pose_steps:.2f} ms a step; warm {timer.mean_ms():.2f} ms a step in a separate "
        f"{P['timed_pose_steps']}-step run (StepTimer, {len(timer.steady)} steps after {timer.skip_first}), "
        f"cold first step {1e3 * cold_s:.1f} ms; mean loss of the first 10 steps {first:.6f}, of the last 10 "
        f"{last:.6f}; NeRF trunk unchanged {trunk_same}, feature head moved {head_moved}")
    if not (np.isfinite(losses).all() and last < first and trunk_same and head_moved):
        raise AssertionError("descriptor training: losses not finite or not falling, or the wrong parameters moved")

    reset_launch_counts()
    with recorded_launches() as shapes["serve"]:
        served = serve_stages(dev, seed, pstate.field, pstate.cnn, h0, h1, os.path.join(out_dir, "serve"), tag)
    counts["serve"] = launch_counts()
    stages.update({k: served["stages"][k] for k in ("bake_s", "infer_s", "icp_s")})
    diam, scale = h0.diameter, h0.diameter / 1.8
    adds = served["adds"]
    quality = {"pose_correct": int((adds < 0.1 * diam * scale).sum()), "median_add": float(np.median(adds)),
               "chamfer": float(served["out"]["chamfer"]), "cors_rays": cors_rays, "n_neg": int(neg.shape[0]),
               "n_keys": int(served["n_real"]), "pose_warm_ms": timer.mean_ms()}
    log(f"{tag} stages (s): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    log(f"{tag} outputs: " + json.dumps(quality))
    if not (np.isfinite(adds).all() and np.isfinite(served["pred_R"]).all() and np.isfinite(quality["chamfer"])
            and np.isfinite(served["feats"]).all()):
        raise AssertionError(f"{tag}: non-finite outputs")
    wanted = {"nerf": ("bundle_loss",), "cors": ("density", "nn_min"), "neg": ("density", "nn_min"),
              "serve": ("density", "nn_min", "corr_argmax")}
    log(f"{tag} launches per stage: " + json.dumps({k: {n: counts[k][n] for n in names} for k, names in
                                                  wanted.items()}))
    for stage, names in wanted.items():
        if not all(counts[stage][n] > 0 for n in names):
            raise AssertionError(f"{tag}: a kernel of the {stage} stage never launched: {counts[stage]}")
    return dict(cors_dirs=cors_dirs, cors_cfg=cors_cfg, shapes=shapes, served=served, quality=quality)


def pipeline_path(dev, seed: int, out_dir: str, trained=None):
    """The bench's chain on the card: NeRF training of both halves (or
    ``trained`` = (states, wall seconds, launch counts) of that run), then
    ``chain_stages``; then K1 / K2 at the cors stage's shapes, FPS, and
    generate_cors through K1 / K2's plain versions."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import surface_sampling

    P, S = PIPELINE, TRAIN["image_size"]
    halves = synthetic_halves(dev, seed)
    stages, counts = {}, {}
    if trained is not None:
        states, stages["nerf_s"], counts["nerf"] = trained
    else:
        states, stages["nerf_s"], counts["nerf"] = train_halves(dev, halves, FieldConfig(**FIELD), P["nerf_steps"],
                                                                TRAIN["warmup"])
    out = chain_stages(dev, seed, out_dir, halves, [st.fine for st in states], P["pose_steps"], stages, counts,
                       "pipeline")
    h0 = halves[0]
    hits = surface_sampling.sample_surface_hits(
        states[0].fine, h0.R_bop, h0.t_bop, h0.K, h0.sils, n_loops=P["neg_loops"], rays_per_image=50, image_size=S,
        threshold=P["neg_threshold"], generator=torch.Generator(device=dev).manual_seed(P["neg_seed"]))
    fps_timing(hits, "the negatives' surface hits", reps=3)
    cors_kernel_checks(dev, states[0].fine, h0, out["cors_dirs"][0], out["cors_cfg"], S, out["shapes"]["cors"],
                       counts["cors"])
    cors_vs_plain(dev, states[0].fine, h0, out["cors_dirs"][0], out["cors_cfg"], S, out_dir)


def nosiren_path(dev, seed: int, out_dir: str) -> dict:
    """The chain of ``pipeline_path`` with the softplus MLP feature head
    (``NOSIREN``): the head does not change NeRF training (a SIREN and a
    non-SIREN field from the same trunk, density and colour weights and
    the same draws train to bit-identical non-feature parameters), K4
    leaves the head bit-identical, then ``chain_stages``; the baked keys
    lie strictly inside (0, 1).  Then K1-K4 against their plain versions
    at this phase's own shapes: K1 / K2 at the cors stage's
    (``cors_kernel_checks``), K2 at every launch shape of the negatives and
    serving stages and K3 at the serving stage's (``nn_check`` /
    ``corr_check``), K4 in a train step at the fresh and the trained
    non-SIREN states (``kernel_step_vs_plain_step``).  Returns (each
    stage's launch counts, each kernel's largest error in those checks)."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        FieldConfig,
        NerfTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NON_FEATURE_MODULES
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    N = NOSIREN
    cfg = FieldConfig(**FIELD, siren=False)
    halves = synthetic_halves(dev, seed)
    train = NerfTrainConfig(warmup_steps=N["warmup"], batch_size=TRAIN["batch"])

    def is_head(name: str) -> bool:
        return name.split(".")[0] not in NON_FEATURE_MODULES

    def inits(field_cfg, like=None):
        """Fresh states of both halves; ``like``'s non-feature weights copied in."""
        states = [nerf_trainer.init_state(field_cfg, train, torch.Generator().manual_seed(TRAIN["seed"] + h),
                                          device=dev) for h in (0, 1)]
        for st, src in zip(states, like or ()):
            for f, g in ((st.coarse, src.coarse), (st.fine, src.fine)):
                f.load_state_dict({k: v for k, v in g.state_dict().items() if not is_head(k)}, strict=False)
        return states

    def body(states):
        return [(n, p) for st in states for f in (st.coarse, st.fine) for n, p in f.state_dict().items()
                if not is_head(n)]

    siren_states = inits(FieldConfig(**FIELD))
    plain = inits(cfg, like=siren_states)
    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(body(siren_states), body(plain))):
        raise AssertionError("the SIREN and non-SIREN fields do not start from the same weights")
    siren_states, _, _ = train_halves(dev, halves, FieldConfig(**FIELD), N["same_steps"], N["warmup"], siren_states)
    plain, _, _ = train_halves(dev, halves, cfg, N["same_steps"], N["warmup"], plain)
    same = sum(torch.equal(a, b) for (_, a), (_, b) in zip(body(siren_states), body(plain)))
    log(f"nosiren: after {N['same_steps']} NeRF steps from the same weights and draws, {same} of "
        f"{len(body(plain))} non-feature tensors of the SIREN and the non-SIREN fields are bit-identical")
    if same != len(body(plain)):
        raise AssertionError("the feature head changed NeRF training")

    states = inits(cfg)
    heads = [(n, p.clone()) for st in states for f in (st.coarse, st.fine) for n, p in f.state_dict().items()
             if is_head(n)]
    stages, counts = {}, {}
    states, stages["nerf_s"], counts["nerf"] = train_halves(dev, halves, cfg, N["nerf_steps"], N["warmup"], states)
    after = [p for st in states for f in (st.coarse, st.fine) for n, p in f.state_dict().items() if is_head(n)]
    head_same = all(torch.equal(a, b) for (_, a), b in zip(heads, after))
    log(f"nosiren nerf_s {stages['nerf_s']:.3f} s: {N['nerf_steps']} steps a half, "
        f"{1e3 * stages['nerf_s'] / N['nerf_steps']:.2f} ms a step; feature head ({sorted({n for n, _ in heads})}) "
        f"bit-identical after training: {head_same}")
    if not head_same:
        raise AssertionError("NeRF training (K4) moved the feature head")
    out = chain_stages(dev, seed, out_dir, halves, [st.fine for st in states], N["pose_steps"], stages, counts,
                       "nosiren")
    feats = out["served"]["feats"]
    log(f"nosiren baked keys: {feats.shape}, min {float(feats.min()):.6f}, max {float(feats.max()):.6f}; ADD per "
        f"image {np.round(out['served']['adds'], 4).tolist()} (no bar)")
    if not (np.isfinite(feats).all() and feats.min() > 0.0 and feats.max() < 1.0):
        raise AssertionError("the non-SIREN head's baked keys are not strictly inside (0, 1)")

    # K1-K4 against their plain versions at this phase's shapes (these
    # launches come after the stages' counts were read)
    shapes = out["shapes"]
    errs = cors_kernel_checks(dev, states[0].fine, halves[0], out["cors_dirs"][0], out["cors_cfg"],
                              TRAIN["image_size"], shapes["cors"], counts["cors"])
    g = torch.Generator(device=dev).manual_seed(seed)
    for stage in ("neg", "serve"):
        nn = shapes[stage]["nn_min"]
        log(f"nosiren {stage} stage's K2 launch shapes (queries, references, masked: launches): "
            f"{ {str(k): nn.count(k) for k in sorted(set(nn))} }")
        for s in sorted(set(nn)):
            nn_check(dev, g, *s, what=f"at the nosiren {stage} stage's shape ")
    corr = shapes["serve"]["corr_argmax"]
    log(f"nosiren serve stage's K3 launch shapes (queries, keys, width): {corr}")
    errs["corr_argmax"] = max((corr_check(dev, g, *s, what="at the nosiren serve stage's shape ")[0]
                               for s in sorted(set(corr))), default=0.0)
    # the step's fine grads are not held: a non-SIREN field's fine weights
    # differ from the SIREN one's (init_state draws the fine field after the
    # coarse head), and the fine pass's depths, resampled from each
    # version's coarse weights, move them; its fine pass is held on K4's
    # own depths instead
    data, render = train_inputs(dev, 0, halves), RenderConfig(n_rays_per_image=TRAIN["n_rays"])
    errs["bundle_loss"] = max(
        kernel_step_vs_plain_step(st, data, dev, seed + 100, render, train, f"nosiren {tag}", whole_step=False)
        for st, tag in ((inits(cfg), "initial"), (states, f"step-{N['nerf_steps']}")))
    log("nosiren kernels against their plain versions at the phase's shapes, largest error: " + json.dumps(errs))
    return counts, errs


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

    def base(r, uh, act=("--act-dtype", "bfloat16")):
        return ["--objid", "1", "--dataset", "tless", "--UH", str(uh), "--root", r, "--synthetic", "--synthetic-views",
                str(c["views"]), *act, "--field-preset", "full", "--viz-every", "0", "--log-every", "0", *c["flags"]]

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
    # and at the CLI's default --act-dtype (float32): K4's float32 variant alone
    run(CLI_DEFAULT_ACT, ["train-nerf", *base(os.path.join(root, "default_act"), 1, ()), "--steps",
                          str(c["nerf_steps"])])
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
    wanted[CLI_DEFAULT_ACT] = (ACT32["bundle_loss"],)
    missing = {k: [n for n in names if not launches[k][n]] for k, names in wanted.items()}
    missing = {k: v for k, v in missing.items() if v}
    field_kernels = (*ACT32, *ACT32.values())
    stray = {k: n for k, n in launches[CLI_DEFAULT_ACT].items()
             if n and k in field_kernels and k != ACT32["bundle_loss"]}
    if stray:
        missing[CLI_DEFAULT_ACT + ": launched besides K4's float32 variant"] = stray
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


@contextlib.contextmanager
def one_card():
    """While open, ``mesh="auto"`` resolves to no mesh whatever the number
    of cards: the phases before the mesh phase measure one card."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib

    auto = mesh_lib.auto_mesh
    mesh_lib.auto_mesh = lambda *args, **kwargs: None
    try:
        yield
    finally:
        mesh_lib.auto_mesh = auto


def per_device_counts() -> dict:
    """Each kernel's launches by device index since the last reset."""
    return {name: dict(w.per_device) for name, w in kernel_wrappers().items()}


def mesh_stage(mesh, name: str, single, sharded, kernels=(), expect=None, warm=False) -> dict:
    """``single()`` then ``sharded()`` (``warm``: after one untimed call of
    each, for a stage whose first call on a device pays cuDNN's, the
    allocator's and the kernels' warm-up there), each timed to its
    devices' end, the
    launches of the sharded run counted by kernel and device: each kernel
    of ``kernels`` must launch on every device of the mesh, and where
    ``expect`` gives a total (launches of one entry's share x entries) it
    must be that.  Returns {"single", "sharded", "single_s", "sharded_s",
    "launches"} (launches by kernel: {device index: n})."""
    devs = sorted({d.index for d in mesh.devices})

    def timed(fn):
        for d in set(mesh.devices):
            sync(d)
        t0 = time.perf_counter()
        out = fn()
        for d in set(mesh.devices):
            sync(d)
        return out, time.perf_counter() - t0

    if warm:
        single()
        sharded()
    one, one_s = timed(single)
    reset_launch_counts()
    out, out_s = timed(sharded)
    launches = {k: v for k, v in per_device_counts().items() if v}
    log(f"mesh {name}: unsharded {one_s:.3f} s, on the mesh {out_s:.3f} s; launches on the mesh by device "
        f"{json.dumps(launches)}")
    for k in kernels:
        gate(sorted(launches.get(k, {})) == devs and all(launches[k].values()),
             f"mesh {name}: {k} did not launch on every device of the mesh: {launches}")
        gate(not (expect and k in expect) or sum(launches.get(k, {}).values()) == expect[k],
             f"mesh {name}: expected {expect[k] if expect and k in expect else 0} launches of {k}, counted "
             f"{launches.get(k)}")
    return {"single": one, "sharded": out, "single_s": one_s, "sharded_s": out_s, "launches": launches}


# the mesh phase's failed gates: every stage runs and reports, and the
# phase raises at its end if any gate failed
MESH_FAILED = []


def gate(ok: bool, msg: str):
    """Record a failed gate of the mesh phase."""
    if not ok:
        log(f"  FAILED: {msg}")
        MESH_FAILED.append(msg)


def close(tag: str, got, want, rtol: float, atol: float = 0.0) -> float:
    """Max abs difference of two arrays (numpy or tensors); a failed gate
    where it is over atol + rtol x |want|."""
    import numpy as np

    a, b = (np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64) for x in (got, want))
    err = np.abs(a - b)
    gate(a.shape == b.shape and np.isfinite(a).all() and (err <= atol + rtol * np.abs(b)).all(),
         f"mesh {tag}: off the unsharded run by {float(err.max()):.3e} (rtol {rtol}, atol {atol})")
    return float(err.max())


def parting_step(l0, l1) -> int | None:
    """The first step (from 1) at which two runs' losses (H, steps) part by
    more than 1e-3 of the unsharded run's, or None."""
    import numpy as np

    far = (np.abs(l1 - l0) > 1e-3 * np.abs(l0)).any(0)
    return int(np.argmax(far)) + 1 if far.any() else None


def training_runs(tag: str, l0, l1):
    """Two runs of a training that part where Adam's sign flips feed the
    resampled depths: the means of their last steps agree within
    ``MESH_TOL["last_mean"]``."""
    import numpy as np

    k = max(1, min(10, l0.shape[1] // 3))
    s0, s1 = (np.stack([l[:, :k].mean(1), l[:, -k:].mean(1)]) for l in (l0, l1))   # (first, last) x halves
    rel = float((np.abs(s1[1] - s0[1]) / s0[1]).max())
    log(f"  {tag}: mean loss of the first / last {k} steps unsharded {s0.tolist()}, on the mesh {s1.tolist()}; "
        f"last means part by {rel:.3e} (tol {MESH_TOL['last_mean']})")
    gate(rel <= MESH_TOL["last_mean"], f"mesh {tag}: the last means part by {rel:.3e}")


def _train_params(states):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    return [p.detach() for st in states for p in nerf_trainer.train_params(st)]


def step_matches(tag: str, new, want, grads, want_grads, rates) -> tuple:
    """One sharded step against the unsharded step from the same state and
    draws.  The summed grads: each tensor within ``MESH_TOL["grad"]`` of
    its max |g| plus 1e-5 of every grad's max (a tensor whose grad is 0,
    as the keys' output bias under the shift-invariant softmax, holds f32
    noise of ~1e-6 of it; a shard weighted wrongly moves its share of
    every grad).  The params after the step: the reference's bar (rtol
    ``param_rtol``, atol ``param_atol``), but where the unsharded grad sits
    within that sum-order error of 0, where Adam's step (~ the rate times
    sign(g) from fresh moments) may go the other way: those elements are
    held to twice the step's rate (``rates``: one per tensor).  Returns
    (grad error / bar, grad error / tensor max |g| over the tensors whose
    max is above 1e-3 of every grad's, share of elements held to the
    rate)."""
    import torch

    g_all = max(float(g.abs().max()) for g in want_grads)
    worst, rel, slack, total = 0.0, 0.0, 0, 0
    ok = True
    for a, b, g, gw, rate in zip(new, want, grads, want_grads, rates):
        bar_g = MESH_TOL["grad"] * float(gw.abs().max()) + 1e-5 * g_all
        err = float((g - gw).abs().max())
        worst = max(worst, err / bar_g)
        if float(gw.abs().max()) > 1e-3 * g_all:
            rel = max(rel, err / float(gw.abs().max()))
        near = gw.abs() <= bar_g
        bar = torch.where(near, torch.full_like(b, 2.0 * rate),
                          MESH_TOL["param_atol"] + MESH_TOL["param_rtol"] * b.abs())
        ok &= bool(((a - b).abs() <= bar).all())
        slack, total = slack + int(near.sum()), total + near.numel()
    gate(worst <= 1.0, f"mesh {tag}: the summed grads are off the unsharded step's by {worst:.3e} of their bar")
    gate(ok, f"mesh {tag}: params off the unsharded step's")
    return worst, rel, slack / total


def forced_steps(mesh, tag: str, n_steps: int, fresh, step, rates, kernels=(), expect=None) -> dict:
    """``n_steps`` steps of a trainer from ``fresh()`` unsharded, then each
    step again on the mesh from a copy of the unsharded run's state before
    it (params and moments) with the same draws, so each sharded step is
    held to the unsharded one (loss at ``MESH_TOL["loss"]``,
    ``step_matches``) whatever the steps before it did.
    ``step(state, k, mesh)`` runs step k: (new state, loss, grads,
    params); ``rates(k)``: step k's rate per tensor.  Returns
    ``mesh_stage``'s dict."""
    import copy

    starts = []

    def single():
        starts.clear()
        st, out = fresh(), []
        for k in range(n_steps):
            starts.append(copy.deepcopy(st))
            st, *res = step(st, k, None)
            out.append(res)
        return out

    def sharded():
        return [step(copy.deepcopy(st), k, mesh)[1:] for k, st in enumerate(starts)]

    s = mesh_stage(mesh, tag, single, sharded, kernels, expect, warm=True)
    for k, ((l0, g0, p0), (l1, g1, p1)) in enumerate(zip(s["single"], s["sharded"])):
        err = close(f"{tag} step {k + 1} loss", l1, l0, MESH_TOL["loss"], 0.0)
        grad, rel, slack = step_matches(f"{tag} step {k + 1}", p1, p0, g1, g0, rates(k))
        log(f"  step {k + 1} from the unsharded run's state: loss off by {err:.3e}; grads off by {grad:.3f} of "
            f"their bar ({rel:.3e} of a tensor's max |g|, tol {MESH_TOL['grad']}); params within the reference's "
            f"bar but {slack:.2e} of them (near-0 grads, held to twice the rate)")
    return s


def nerf_step_fn(opt, render, train, rays, **kw):
    """``forced_steps``' step of train_step (``kw``: its options) with
    ``rays[k]``: the step's cameras, depth bounds, draws and its images and
    silhouettes (H, B, ...)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    def step(states, k, m):
        r = rays[k]
        new, loss, _ = nerf_trainer.train_step(states, r["cam"], r["images"], r["sils"], opt, render, train,
                                               r["min_d"], r["max_d"], draws=r["draws"], mesh=m, **kw)
        trained = [p for st in new for p in nerf_trainer.train_params(st)]
        return new, loss, [p.grad.clone() for p in trained], [p.detach().clone() for p in trained]

    return step


def mesh_train_stages(mesh, dev, data, stages: dict) -> float:
    """Fused NeRF training: ``MESH["forced_steps"]`` forced steps (each
    sharded step from the unsharded run's state), ``MESH["nerf_steps"]``
    steps of train_nerf_fused on the mesh against unsharded, then K4 on
    each entry's rays of one step against its plain version there.
    Returns K4's worst scaled grad error."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        FieldConfig,
        NerfTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    cfg = FieldConfig(**FIELD)
    render = RenderConfig(n_rays_per_image=TRAIN["n_rays"])
    train = NerfTrainConfig(warmup_steps=TRAIN["warmup"], batch_size=TRAIN["batch"])
    args = (data["images"], data["sils"], data["R_bop"], data["t_bop"], data["K"], cfg, render, train)
    opt = nerf_trainer.make_optimizer(train)
    B, K = TRAIN["batch"], MESH["forced_steps"]

    def fresh():
        return [nerf_trainer.init_state(cfg, train, torch.Generator().manual_seed(TRAIN["seed"] + h), device=dev)
                for h in range(2)]

    rays = [dict(step_rays(data, dev, 7 + 2 * k, render), images=data["images"][:, :B], sils=data["sils"][:, :B])
            for k in range(K)]
    step = nerf_step_fn(opt, render, train, rays)
    n_tensors = len(_train_params(fresh()))
    stages["nerf_forced"] = forced_steps(mesh, "nerf_forced", K, fresh, step,
                                         lambda k: [opt.learning_rate(k)] * n_tensors, ("bundle_loss",),
                                         {"bundle_loss": 2 * mesh.size * K})

    # the whole run: Adam's sign flips (near-0 grads) feed the fine pass's
    # resampled depths and the runs part; held by the first loss, the last
    # means and Adam's bound
    n = MESH["nerf_steps"]

    def run(m):
        return nerf_trainer.train_nerf_fused(*args, n_steps=n, seed=TRAIN["seed"], device=dev, mesh=m)

    s = mesh_stage(mesh, "nerf", lambda: run(None), lambda: run(mesh), ("bundle_loss",),
                   {"bundle_loss": 2 * mesh.size * n})
    (st0, l0), (st1, l1) = s["single"], s["sharded"]
    rates = MESH_TOL["rates"] * sum(opt.learning_rate(k) for k in range(n))
    pairs = list(zip(_train_params(st1), _train_params(st0)))
    outside = sum(int(((a - b).abs() > MESH_TOL["param_atol"] + MESH_TOL["param_rtol"] * b.abs()).sum())
                  for a, b in pairs) / sum(b.numel() for _, b in pairs)
    close("nerf first loss", l1[:, 0], l0[:, 0], MESH_TOL["loss"])
    training_runs(f"nerf, {n} steps", l0, l1)
    err = max(close("nerf params", a, b, 0.0, rates) for a, b in pairs)
    log(f"  {n} steps: loss max relative difference {float((abs(l1 - l0) / abs(l0)).max()):.3e}, first step "
        f"whose losses part by more than 1e-3: {parting_step(l0, l1)}; max param difference {err:.3e} (Adam's "
        f"bound {rates:.3e}), share of params outside the reference's bar (rtol {MESH_TOL['param_rtol']}, atol "
        f"{MESH_TOL['param_atol']}) {outside:.3e}")
    stages["nerf"] = s

    # K4 at each entry's share of one step's rays, on its device, against its plain version there
    r = rays[0]
    fields = []
    for h in range(2):
        f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(17 + h))
        torch.nn.init.zeros_(f.density_layer.bias)
        fields.append(f)
    worst = 0.0
    for i, d, sl in mesh_lib.shards(r["d"].shape[1], mesh):
        weights = tuple(torch.stack(b) for b in zip(*(fk.loss_weights(f.to(d)) for f in fields)))
        fm = torch.from_numpy(fk.fmat_of(cfg)).to(d)
        rest = (r["dn"][:, sl].to(d).contiguous(), r["tgt"][:, sl].to(d).contiguous(), fm, weights,
                fk.ladder_of(cfg), cfg.softplus_beta, train.huber_scaling, train.loss_scale / r["d"].shape[1])
        o, dd, lengths = (r[k][:, sl].to(d) for k in ("o", "d", "lengths"))
        z = lengths
        for tag in ("coarse", "fine"):
            pts = (o[:, :, None] + dd[:, :, None] * z[..., None]).contiguous()
            want_w = tag == "coarse"
            got = fk.bundle_loss_cuda(pts, *rest, want_w, cfg.act_dtype)
            worst = max(worst, compare_bundle(f"K4 on entry {i} ({d}), {tag}, {pts.shape[1]} rays", got,
                                              fk.bundle_loss_plain(pts, *rest, want_w, cfg.act_dtype),
                                              fk.bundle_loss_cuda(pts, *rest, want_w, cfg.act_dtype)))
            if tag == "coarse":
                z = raymarch.importance_resample(lengths, got[2], render.n_pts_fine, u=r["u_pdf"][:, sl].to(d))
    return worst


@contextlib.contextmanager
def captured(module, name: str):
    """While open, the arguments of each call of ``module.name`` are
    appended to the yielded list (tensors detached; the call goes
    through)."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args):
        calls.append(tuple(a.detach() if hasattr(a, "detach") else
                           tuple(w.detach() for w in a) if isinstance(a, tuple) else a for a in args))
        return fn(*args)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def mesh_chunked_stage(mesh, dev, seed: int, stages: dict) -> dict:
    """train_nerf at CHUNKED's settings: ``MESH["forced_chunk_steps"]``
    forced steps (each sharded step from the unsharded run's state; each
    entry's share of the 4,800 rays in one chunk a pass through K5 / K6),
    K5 / K6 on each entry's chunks of the first sharded step (its points
    and directions, a random field) against their plain versions there,
    then ``MESH["chunk_steps"]`` steps of train_nerf on the mesh against
    unsharded.  Returns K5's and K6's worst errors."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        FieldConfig,
        NerfTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    n = MESH["chunk_steps"]
    h = synthetic.make_scene(CHUNKED["n_views"], CHUNKED["image_size"], torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
    cfg = FieldConfig(**FIELD)
    render = RenderConfig(n_rays_per_image=CHUNKED["n_rays"])
    train = NerfTrainConfig(batch_size=CHUNKED["batch"], warmup_steps=min(300, n // 3))
    opt = nerf_trainer.make_optimizer(train)
    rays_per_step = CHUNKED["batch"] * CHUNKED["n_rays"]
    per_entry = 2 * -(-(rays_per_step // mesh.size) // nerf_trainer.RAY_CHUNK)   # launches of a step on each entry

    # the forced steps, on the schedule's batches with train_nerf's draws
    K, S, bs = MESH["forced_chunk_steps"], CHUNKED["image_size"], CHUNKED["batch"]
    sched = nerf_trainer.half_schedule(CHUNKED["n_views"], bs, K, CHUNKED["seed"])
    cams = cam_lib.camera_from_bop(h.R_bop, h.t_bop, h.K, S)
    min_d, max_d = nerf_trainer.depth_bounds(h.t_bop.cpu().numpy())
    rays = []
    for k in range(K):
        idx = torch.as_tensor(sched[k], device=dev)
        rays.append(dict(cam=cam_lib.Camera(cams.R[idx][None], cams.T[idx][None], cams.focal[idx][None],
                                            cams.principal[idx][None], S), min_d=min_d, max_d=max_d,
                         images=h.images[idx][None], sils=h.sils[idx][None],
                         draws=nerf_trainer.draw([nerf_trainer.step_generator(CHUNKED["seed"], k, dev)], bs, render,
                                                 dev)))

    def fresh():
        return [nerf_trainer.init_state(cfg, train, torch.Generator().manual_seed(CHUNKED["seed"]), device=dev)]

    n_tensors = len(_train_params(fresh()))
    with captured(fk, "field_color_fwd_op") as calls:
        stages["chunked_forced"] = forced_steps(
            mesh, "chunked_forced", K, fresh, nerf_step_fn(opt, render, train, rays, ray_chunk=nerf_trainer.RAY_CHUNK),
            lambda k: [opt.learning_rate(k)] * n_tensors,
            ("field_color_fwd", "field_color_bwd"),
            {"field_color_fwd": per_entry * mesh.size * K, "field_color_bwd": per_entry * mesh.size * K})
    # the calls of the last sharded run's first step: each entry's coarse
    # and fine chunks, in entry order, on its device; the fields are random
    # (density bias 0, as field_color_phase draws them: a fresh field's
    # densities are nearly constant)
    first = calls[-K * per_entry * mesh.size:][:per_entry * mesh.size]
    field = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(seed + 20))
    torch.nn.init.zeros_(field.density_layer.bias)
    worst = {"field_color_fwd": 0.0, "field_color_bwd": 0.0}
    with torch.no_grad():
        for j, (pts, dn, fm, _, ladder, beta, act) in enumerate(first):
            args = (pts, dn, fm, tuple(b[None] for b in fk.loss_weights(field.to(pts.device))), ladder, beta, act)
            err, bad, *_ = field_color_pair(args, torch.Generator(device=pts.device).manual_seed(seed + j),
                                            f"on entry {j // per_entry} ({pts.device}), {pts.shape[1]} rays x "
                                            f"{pts.shape[2]} points", reps=1)
            worst["field_color_fwd"] = max(worst["field_color_fwd"], err)
            worst["field_color_bwd"] = max(worst["field_color_bwd"], bad)
    del calls, first

    def run(m):
        return nerf_trainer.train_nerf(h.images, h.sils, h.R_bop, h.t_bop, h.K, cfg, render, train, n_steps=n,
                                       seed=CHUNKED["seed"], device=dev, mesh=m)

    s = mesh_stage(mesh, "chunked", lambda: run(None), lambda: run(mesh), ("field_color_fwd", "field_color_bwd"),
                   {"field_color_fwd": per_entry * mesh.size * n, "field_color_bwd": per_entry * mesh.size * n},
                   warm=True)
    (st0, l0), (st1, l1) = s["single"], s["sharded"]
    l0, l1 = np.asarray(l0)[None], np.asarray(l1)[None]
    rates = MESH_TOL["rates"] * sum(opt.learning_rate(k) for k in range(n))
    close("chunked first loss", l1[:, 0], l0[:, 0], MESH_TOL["loss"])
    training_runs(f"chunked, {n} steps", l0, l1)
    err = max(close("chunked params", a, b, 0.0, rates) for a, b in zip(_train_params([st1]), _train_params([st0])))
    log(f"  {n} chunked steps: loss max relative difference {float((abs(l1 - l0) / abs(l0)).max()):.3e}, first "
        f"step whose losses part by more than 1e-3: {parting_step(l0, l1)}; max param difference {err:.3e} (Adam's "
        f"bound {rates:.3e})")
    stages["chunked"] = s
    return worst


def mesh_serving_stages(mesh, dev, seed: int, field, halves, out_dir: str, stages: dict):
    """generate_cors of half 0 (bit-identical artifacts), K2 at its mesh
    filter's shape (bit-identical), verification and ICP, inference of 8
    images (then K3 on each entry's share against its plain version), 20
    descriptor steps, forced descriptor steps on 2 + 1 + 1 views, one
    SurfEmb image's hypotheses.  Returns K3's worst conf error on the
    entries."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        CorsConfig,
        InferenceConfig,
        PoseTrainConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet, normalize_image
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp, pointcloud
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import (
        artifacts,
        generate_cors,
        inference,
        pose_est_surf,
        registration,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment, pose_trainer

    P, S, V = PIPELINE, TRAIN["image_size"], TRAIN["n_views"]
    h0, h1 = halves
    cors_cfg = CorsConfig(**P["cors"])

    def cors(m, tag):
        return generate_cors.generate_cors(field, h0.R_bop, h0.t_bop, h0.K, h0.sils, os.path.join(out_dir, tag), 1,
                                           cors_cfg, grid_res=SERVE["grid_res"], image_size=S, device=dev, mesh=m)

    # K1's grid runs on home in both; the views' passes are dealt over the entries
    s = mesh_stage(mesh, "cors", lambda: cors(None, "single"), lambda: cors(mesh, "mesh"), ("density", "nn_min"))
    d0, d1 = s["single"], s["sharded"]
    same = all(np.array_equal(artifacts.load_array(d0, k), artifacts.load_array(d1, k))
               for k in ("a1.npy", "subvert1.npy", "subnormal1.npy"))
    same &= all(np.array_equal(a, b) for v in range(V)
                for a, b in zip(artifacts.load_view_rays(d0, S, v), artifacts.load_view_rays(d1, S, v)))
    log(f"  artifacts bit-identical: {same}")
    gate(same, "mesh cors: the artifacts differ from the unsharded run's")
    stages["cors"] = s

    a1 = torch.as_tensor(artifacts.load_array(d0, "a1.npy"), device=dev)
    hits = torch.as_tensor(artifacts.load_view_rays(d0, S, 0)[1], device=dev)
    s = mesh_stage(mesh, "nn_query", lambda: pointcloud.nn_query(hits, a1), lambda: pointcloud.nn_query(hits, a1,
                                                                                                         mesh=mesh),
                   ("nn_min",), {"nn_min": mesh.size}, warm=True)
    same = all(torch.equal(a, b) for a, b in zip(s["single"], s["sharded"]))
    log(f"  K2 {hits.shape[0]} x {a1.shape[0]} (view 0's front hits against a1): bit-identical {same}")
    gate(same, "mesh nn_query: not bit-identical to the unsharded call")
    stages["nn_query"] = s

    scale = h0.diameter / 1.8
    cloud = a1[:: max(a1.shape[0] // 4000, 1)] * scale
    R_gt, t_gt = h1.R_bop[: MESH["n_infer"]], h1.t_bop[: MESH["n_infer"]] * scale
    g = torch.Generator(device=dev).manual_seed(seed)
    R_pred = torch.linalg.qr(R_gt + 0.02 * torch.randn(R_gt.shape, generator=g, device=dev))[0]
    R_pred = R_pred * torch.sign(torch.linalg.det(R_pred))[:, None, None]
    upper, lower = cloud[::2], cloud[1::2]
    rot = R_pred[0] @ R_gt[0].T

    def registered(m):
        best, chamfers = registration.verify_consecutive(cloud, R_gt, t_gt, R_pred, t_gt, device=dev, mesh=m)
        out = registration.register_halves(upper, lower, torch.eye(3, device=dev), torch.zeros(3, device=dev), rot,
                                           torch.zeros(3, device=dev), cloud, h0.diameter * scale,
                                           icp_threshold=0.2 * scale, icp_iters=MESH["icp_iters"], device=dev, mesh=m)
        return best, chamfers, out

    n_pairs = MESH["n_infer"] - 1
    s = mesh_stage(mesh, "registration", lambda: registered(None), lambda: registered(mesh), ("nn_min",),
                   {"nn_min": mesh.size * (2 * n_pairs + MESH["icp_iters"] + 1 + 2)}, warm=True)
    (b0, c0, o0), (b1, c1, o1) = s["single"], s["sharded"]
    err = max(close("icp R", o1["R"], o0["R"], 0.0, MESH_TOL["icp"]), close("icp t", o1["t"], o0["t"], 0.0,
                                                                            MESH_TOL["icp"] * scale))
    log(f"  verification: best {b1} (unsharded {b0}), Chamfers equal {c1 == c0}; ICP R / t max difference {err:.3e}, "
        f"Chamfer {o1['chamfer']:.6f} (unsharded {o0['chamfer']:.6f}), fitness {o1['fitness']:.4f}")
    gate(b1 == b0 and c1 == c0 and abs(o1["chamfer"] - o0["chamfer"]) <= 1e-5 * abs(o0["chamfer"]),
         "mesh registration: verification or Chamfer off the unsharded run")
    stages["registration"] = s

    cnn = ResNetUNet().reset_parameters(torch.Generator().manual_seed(seed)).to(dev).eval()
    n = MESH["n_infer"]
    keys = cloud[:: max(cloud.shape[0] // 1024, 1)][:1024]
    feats = torch.nn.functional.normalize(torch.randn((keys.shape[0], 12), generator=g, device=dev), dim=-1) * 3.0
    imgs = normalize_image(h1.images[:n])
    Ks = h1.K[:n].clone()
    Ks[:, 0:2, 2] -= 0.5

    cfg_i = InferenceConfig()
    k = -(-n // mesh.size)

    def infer(m, batch=n, samples=None):
        with torch.no_grad():
            return inference.run_sequence(cnn, imgs, h1.sils[:n], Ks, keys, feats, cfg_i, seed=1, batch=batch,
                                          samples=samples, device=dev, mesh=m)

    s = mesh_stage(mesh, "inference", lambda: infer(None), lambda: infer(mesh), ("corr_argmax",),
                   {"corr_argmax": mesh.size}, warm=True)
    (R0, t0), (R1, t1) = s["single"], s["sharded"]
    # cuDNN picks a convolution's algorithm by its shape, so the bf16 CNN at
    # the batch's size and at an entry's share rounds differently, and the
    # correspondences, and so the poses, part from the unsharded run's.  The
    # stage is held to the unsharded run at an entry's batch size with the
    # same RANSAC draws (made on home from the batch's masks, as the stage
    # makes them)
    with torch.no_grad():
        q_all = cnn(imgs)
        q_parts = torch.cat([cnn(imgs[sl]) for _, _, sl in mesh_lib.shards(n, mesh)])
        masks = torch.cat([inference.correspondences(cnn, imgs[sl], h1.sils[:n][sl], Ks[sl], feats,
                                                     cfg_i.down_sample, cfg_i.conf_keep_frac)[1]
                           for _, _, sl in mesh_lib.shards(n, mesh)])
    draws = pnp.draw_hypotheses(masks.to(torch.float32), cfg_i.ransac_iters,
                                torch.Generator(device=dev).manual_seed(seed))
    R2, t2 = infer(None, k, draws)
    R3, t3 = infer(mesh, n, draws)
    errs = {"R": close("inference R", R3, R2, MESH_TOL["pose_t"], MESH_TOL["pose_R"]),
            "t": close("inference t", t3, t2, MESH_TOL["pose_t"], MESH_TOL["pose_t"])}
    gate(np.isfinite(R1).all() and np.abs(np.einsum("nij,nkj->nik", R1, R1) - np.eye(3)).max() < 1e-3,
         "mesh inference: poses not finite or not rotations")
    log(f"  {n} images: the bf16 CNN at batch {n} against each entry's {k}: max difference "
        f"{float((q_all - q_parts).abs().max()):.3e}, so the poses part from the unsharded run's by "
        f"{float(np.abs(R1 - R0).max()):.3e} (R); with the same draws, against the unsharded run at batch {k}: "
        f"{errs['R']:.3e} (R), {errs['t']:.3e} (t)")
    stages["inference"] = s
    # K3 on each entry's share of the batch, on its device, against its plain version there
    with captured(pk, "correspondence_argmax") as calls:
        infer(mesh)
    gate(len(calls) == mesh.size, f"mesh inference: {len(calls)} K3 calls on the mesh, {mesh.size} entries")
    with torch.no_grad():
        errs["corr_argmax"] = max(corr_compare(q.contiguous(), keys_.contiguous(),
                                               f"on entry {i} ({q.device}), ")[0]
                                  for i, (q, keys_) in enumerate(calls))
    del calls

    pose_cfg = PoseTrainConfig(**P["pose"])
    aug_cfg = augment.AugmentConfig(**P["aug"])
    bank = pose_trainer.load_ray_bank(d0, S, V, device=dev)
    neg = pose_trainer.build_negatives(field, h0.R_bop, h0.t_bop, h0.K, h0.sils, a1.cpu().numpy(), pose_cfg,
                                       image_size=S, n_loops=P["neg_loops"], threshold=P["neg_threshold"],
                                       generator=torch.Generator(device=dev).manual_seed(P["neg_seed"]), device=dev)

    def pose(m):
        return pose_trainer.train_pose(field, h0.images, h0.sils, bank, neg, cfg=pose_cfg, aug_cfg=aug_cfg,
                                       n_steps=MESH["pose_steps"], seed=P["pose_seed"], device=dev, mesh=m)

    s = mesh_stage(mesh, "pose", lambda: pose(None), lambda: pose(mesh), warm=True)
    (p0, l0), (p1, l1) = s["single"], s["sharded"]
    again = pose(mesh)
    opt = pose_trainer.make_pose_optimizer(pose_cfg)
    steps = range(MESH["pose_steps"])
    err = close("pose losses", l1, l0, MESH_TOL["pose_loss"])
    moved = 0.0
    for get, base in ((lambda st: list(st.cnn.parameters()), pose_cfg.lr_cnn),
                      (lambda st: pose_trainer.head_params(st.field), pose_cfg.lr_mlp)):
        bound = 2.0 * sum(opt.learning_rate(base, k) for k in steps)
        moved = max(moved, max(close("pose params", a, b, 0.0, bound) for a, b in zip(get(p1), get(p0))))
    repeat = l1 == again[1] and all(torch.equal(a, b) for a, b in zip(p1.cnn.parameters(), again[0].cnn.parameters()))
    log(f"  {MESH['pose_steps']} descriptor steps: losses off the unsharded run by {err:.3e}, params by {moved:.3e}; "
        f"last loss {l1[-1]:.6f} (unsharded {l0[-1]:.6f}); a second run on the mesh bit-identical {repeat}")
    gate(repeat, "mesh pose: two runs on the mesh differ")
    stages["pose"] = s

    # descriptor steps on 4 views over 3 entries (2 + 1 + 1, each entry's
    # loss weighted by its share), each from the unsharded run's state,
    # with the full-width CNN in f32 (see MESH_TOL)
    mesh3 = mesh_lib.Mesh((list(mesh.devices) * 3)[:3])
    views = torch.arange(4, device=dev)
    neg_t = torch.as_tensor(neg, dtype=torch.float32, device=dev)
    K = MESH["forced_pose_steps"]
    pose_draws = [pose_trainer.draw_pose_step(torch.Generator(device=dev).manual_seed(50 + k), 4, S, neg_t.shape[0],
                                              pose_cfg, aug_cfg) for k in range(K)]

    def pose_step(st, k, m):
        new, loss, _ = pose_trainer.pose_train_step(
            st, opt, h0.images[views], h0.sils[views], bank.pos_vec[views], bank.xys[views], bank.valid[views], neg_t,
            pose_cfg, aug_cfg, pose_draws[k], torch.Generator(device=dev).manual_seed(60 + k), mesh=m)
        trained = list(new.cnn.parameters()) + pose_trainer.head_params(new.field)
        return new, loss, [p.grad.clone() for p in trained], [p.detach().clone() for p in trained]

    def pose_fresh():
        g = torch.Generator().manual_seed(P["pose_seed"])
        return pose_trainer.init_pose_state(field, pose_cfg, ResNetUNet(dtype=torch.float32).reset_parameters(g),
                                            device=dev)

    n_cnn = len(list(pose_fresh().cnn.parameters()))
    n_head = len(pose_trainer.head_params(field))
    stages["pose_forced"] = forced_steps(
        mesh3, "pose_forced", K, pose_fresh, pose_step,
        lambda k: [opt.learning_rate(pose_cfg.lr_cnn, k)] * n_cnn + [opt.learning_rate(pose_cfg.lr_mlp, k)] * n_head)

    verts, faces, _, normals = (torch.as_tensor(x, device=dev) for x in mesh_scene.blob_mesh())
    m_keys = MESH["surf_keys"]
    tri = faces[torch.randint(0, faces.shape[0], (m_keys,), generator=g, device=dev).long()].long()
    bary = -torch.log(torch.rand((m_keys, 3), generator=g, device=dev))
    bary = bary / bary.sum(-1, keepdim=True)
    pts = (bary[..., None] * verts[tri]).sum(1)
    nrm = torch.nn.functional.normalize((bary[..., None] * normals[tri]).sum(1), dim=-1)
    _, _, K, maps = ideal_view(pts, 224)
    draws = pose_est_surf.draw_hypotheses(InferenceConfig().max_poses, g, dev)

    def surf(m):
        return inference.estimate_pose_surfemb(ideal_cnn(maps), torch.zeros((224, 224, 3), device=dev), K, pts, nrm,
                                               sharp_features(pts), 1.2, refine=False, hyp_mesh=m,
                                               draws=inference.SurfEmbDraws(draws.u, draws.pick, None))

    s = mesh_stage(mesh, "surfemb", lambda: surf(None), lambda: surf(mesh), warm=True)
    (R0, t0, sc0), (R1, t1, sc1) = s["single"], s["sharded"]
    surf_errs = (close("surfemb R", R1, R0, 0.0, MESH_TOL["pose_R"]), close("surfemb t", t1, t0, 0.0,
                                                                             MESH_TOL["pose_t"]))
    log(f"  one image, {InferenceConfig().max_poses} hypotheses: best score {sc1:.6f} (unsharded {sc0:.6f}), pose off "
        f"by {surf_errs[0]:.3e} (R), {surf_errs[1]:.3e} (t)")
    stages["surfemb"] = s
    return errs["corr_argmax"]


def mesh_path(dev, seed: int, out_dir: str, field) -> tuple:
    """The mesh phase (``MESH``): every entry point that takes a mesh, run
    on it and unsharded; ``field`` is the train phase's trained fine field
    of half 0.  Returns (launches of the mesh runs by kernel, each checked
    kernel's worst error in its per-entry checks: K3, K4, K5, K6)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib

    k = torch.cuda.device_count()
    mesh = mesh_lib.make_mesh(k) if k >= 2 else mesh_lib.Mesh([dev, dev])
    auto = mesh_lib.auto_mesh()
    log(f"mesh phase on {mesh} ({k} card{'s' if k > 1 else ''}); auto_mesh() is "
        f"{auto if auto is None else auto.devices}")
    if (auto is None) != (k < 2):
        raise AssertionError("auto_mesh() disagrees with the number of cards")
    t0 = time.perf_counter()
    stages = {}
    MESH_FAILED.clear()
    halves = synthetic_halves(dev, seed)
    errs = {"bundle_loss": mesh_train_stages(mesh, dev, train_inputs(dev, seed, halves), stages)}
    errs.update(mesh_chunked_stage(mesh, dev, seed, stages))
    errs["corr_argmax"] = mesh_serving_stages(mesh, dev, seed, field, halves, out_dir, stages)
    times = {name: {"single_s": round(s["single_s"], 4), "mesh_s": round(s["sharded_s"], 4)}
             for name, s in stages.items()}
    log("mesh stage seconds: " + json.dumps(times))
    total = {}
    for s in stages.values():
        for name, by_dev in s["launches"].items():
            total[name] = total.get(name, 0) + sum(by_dev.values())
    log(f"mesh phase {time.perf_counter() - t0:.1f} s; launches on the mesh: {json.dumps(total)}")
    if MESH_FAILED:
        raise AssertionError(f"mesh phase: {len(MESH_FAILED)} gates failed: {MESH_FAILED}")
    return total, errs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", metavar="PATH",
                        help="also profile one serve run (kernel table to PATH) and 20 training steps (PATH.train.txt); "
                             "Chrome traces in PATH*.trace/")
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

    with one_card():
        phases = {"density": density_phase(dev, args.seed),
                  "bundle_loss": bundle_loss_phase(dev, args.seed, "bfloat16"),
                  ACT32["bundle_loss"]: bundle_loss_phase(dev, args.seed, "float32")}
        for act in ("bfloat16", "float32"):
            phases.update(field_color_phase(dev, args.seed, act))
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
            cli_launches = cli_path(dev, out_dir)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_surf_")
        try:
            surf_launches = surf_path(dev, out_dir)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_nosiren_")
        try:
            t0 = time.perf_counter()
            nosiren_launches, nosiren_errs = nosiren_path(dev, args.seed, out_dir)
            log(f"nosiren phase {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mesh_launches, mesh_errs = mesh_path(dev, args.seed, out_dir, train_states[0].fine)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    counts["bundle_loss"] = train_counts["bundle_loss"]
    counts.update({k: chunked_counts[k] for k in ("field_color_fwd", "field_color_bwd", ACT32["field_color_fwd"],
                                                 ACT32["field_color_bwd"])})
    # K4's float32 variant: the CLI's train-nerf at its default --act-dtype
    counts[ACT32["bundle_loss"]] = cli_launches[CLI_DEFAULT_ACT][ACT32["bundle_loss"]]
    # the surf phase's commands' and the nosiren phase's stages' launches join the paths' counts
    for per_stage in (*surf_launches.values(), *nosiren_launches.values()):
        for name, n in per_stage.items():
            counts[name] += n
    # and the mesh phase's runs on the mesh
    for name, n in mesh_launches.items():
        counts[name] += n
    # the error column covers the nosiren phase's checks at its own shapes
    # and the mesh phase's K3-K6 on each entry's share too
    for name, err in [*nosiren_errs.items(), *mesh_errs.items()]:
        phases[name]["max_abs_err"] = max(phases[name]["max_abs_err"], err)
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
