#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port: builds the hand-written kernels,
checks each against its plain PyTorch version at the shapes of the path
that runs it, then trains both half-sequence NeRFs, trains one NeRF at a
large ray batch (chunked steps) and drives the serving path at bench
settings on one GPU.

    python3 chip_smoke.py                    # from the repository root, one CUDA device
    python3 chip_smoke.py --nerf-steps 800   # the bench's full NeRF schedule
    python3 chip_smoke.py --chunk-steps 200  # the reference's full large-batch schedule

Phases (any failure raises, and the script exits non-zero):
1. device and toolchain: the card's name and power limit (nvidia-smi),
   torch / CUDA / nvcc versions;
2. build K1-K6 from ``imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch/ops/csrc``,
   then count each kernel's tensor-core instructions (HMMA / HGMMA) in the
   built extension's SASS (``cuobjdump -sass``): K1's and K4's must have
   some;
3. per kernel, kernel vs plain version on the card, error, both times and
   the bound (the least time the card could take: bytes over 3.35 TB/s or
   operations over the peak rate of their type, from this run's shapes):
   K1 on the 128^3 grid of a randomly initialised full-width field (and
   its sin / cos embedding stage alone), K2 at
   50,000 x 50,000, K3 with 5,625 queries x 80,000 keys at 12 dims, K4 at
   the train step's shapes (2 halves x 1,200 rays x 64 coarse / 320 fine
   points, full-width random fields, both embeddings, synthetic targets),
   K5 / K6 at a chunk's shapes (one half, 4,096 rays and the ragged 704,
   x 64 / 320 points, both embeddings);
4. NeRF training of both halves (``train_nerf_fused``) at the bench's
   settings: 8 views at 224 px, full-width bf16 field, 400 rays per image,
   batch 3, warmup 266, seed 1, ``--nerf-steps`` steps (default 200), with
   K4's launches counted over exactly that run; then one step with K4
   against one with its plain version from the same state and draws;
5. chunked NeRF training of one half (``train_nerf``) at the reference's
   large-batch schedule (experiments/nerf_schedule.py:40): 6 cams x 800
   rays a step, chunks of 4,096 and 704 rays through K5 / K6,
   ``--chunk-steps`` steps (default 100), with K5's and K6's launches
   counted over exactly that run; a chunked step through K5 / K6 against
   one through their plain versions; exact resume through
   ``train.checkpoint``; the trained fine field's point cloud (K1 grid,
   marching tetrahedra) against the analytic surface;
6. the serving path of the bench (8 views at 224 px, 128^3 grid,
   FeatConfig(mc_threshold=0.05, n_points=20000, sample_loops=3), 8 images
   through InferenceConfig(), ICP with 20 iterations) on a full-width
   planted NerfField and a full-width random ResNetUNet from ``--seed``,
   with each kernel's launches counted over exactly that run;
7. checks of the outputs: shapes, finiteness, keys on the planted shell,
   and ICP from a perturbed ground-truth pose, card against the CPU plain
   path.

Output: one JSON line with the kernels, then the device JSON as the last line.
"""

from __future__ import annotations

import argparse
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
# the device functions of each kernel in the built extension (K4 is two:
# the loss kernel and its weight-grad contraction kernel)
DEVICE_FUNCTIONS = {
    "density": ("density_kernel",),
    "nn_min": ("nn_min_kernel",),
    "corr_argmax": ("corr_argmax_kernel",),
    "bundle_loss": ("bundle_loss_kernel", "dw_kernel"),
    "field_color_fwd": ("field_color_fwd_kernel",),
    "field_color_bwd": ("field_color_bwd_kernel",),
}
TENSOR_CORE_KERNELS = ("density", "bundle_loss")  # their products must run on the tensor cores
# one H100 SXM (NVIDIA's data sheet, dense): device memory bytes/s, bf16
# tensor-core and f32 FLOP/s, for the bounds
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# K4: loss sums (relative), EA weights (absolute), each grad block scaled by
# its max |g|.  K5: dens and rgb (absolute), the share of bf16 residual
# values that are not bit-equal; K6 as K4's grads
# K1: max abs, and the share of densities off by more than 1e-4 (the tensor
# cores sum each k-16 step's products in another order than the plain
# version's f32 chain, which flips more bf16 roundings of h1: 1.05e-3 at
# 128^3 on the H100, 2e-3 allowed)
TOL = {"density": 2e-2, "density_share": 2e-3, "nn_min": 0.0, "corr_argmax": 1e-4, "loss_rel": 1e-3, "w_abs": 1e-3,
       "grad_scaled": 3e-2, "color_abs": 2e-2, "res_share": 1e-2}
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


def kernel_phases(dev, seed: int):
    """Each kernel against its plain version at the serving path's shapes."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel, point_kernels

    results = {}
    g = torch.Generator(device=dev).manual_seed(seed)

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
    results["density"] = result(float(err.max()), ms, plain_ms, b)
    log(f"K1 density  N={n} H=60 hidden=256, random field (density min {float(want.min()):.4f} "
        f"mean {float(want.mean()):.4f} max {float(want.max()):.4f}): max_abs_err {float(err.max()):.3e} "
        f"(tol {TOL['density']}), share > 1e-4: {frac:.2e} (tol {TOL['density_share']}); second launch "
        f"bit-identical: {same}; kernel {ms:.3f} ms "
        f"(its sin / cos embedding alone {embed_ms:.3f} ms), plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]})")
    if not (float(err.max()) <= TOL["density"] and frac < TOL["density_share"] and float(want.std()) > 1e-3 and same):
        raise AssertionError("K1 disagrees with its plain version")
    del want, err, again

    # K2: 50,000 x 50,000 nearest neighbour with a mask
    q = torch.randn((50_000, 3), generator=g, device=dev)
    r = torch.randn((50_000, 3), generator=g, device=dev)
    mask = torch.rand((50_000,), generator=g, device=dev) > 0.1
    ms, (d_k, i_k) = cuda_ms(lambda: point_kernels.nn_min_cuda(q, r, mask))
    plain_ms, (d_p, i_p) = cuda_ms(lambda: point_kernels.nn_min_plain(q, r, mask), reps=1)
    err = float((d_k - d_p).abs().max())
    same_idx = bool(torch.equal(i_k, i_p))
    n, m = q.shape[0], r.shape[0]
    # 3 differences, 3 products, 2 sums and a compare a pair, f32
    b = bound(12 * (n + m) + m + 8 * n, 9 * n * m, F32_FLOPS)
    results["nn_min"] = result(err, ms, plain_ms, b)
    log(f"K2 nn_min   50000 x 50000: max_abs_err {err:.3e} (tol {TOL['nn_min']}), indices equal: "
        f"{same_idx}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]})")
    if not (err <= TOL["nn_min"] and same_idx):
        raise AssertionError("K2 disagrees with its plain version")

    # K3: 5,625 queries (one 224^2 crop at stride 3) x 80,000 keys, 12 dims
    qq = torch.randn((5_625, 12), generator=g, device=dev)
    kk = torch.randn((80_000, 12), generator=g, device=dev)
    ms, (i_k, c_k) = cuda_ms(lambda: point_kernels.correspondence_argmax_cuda(qq, kk))
    plain_ms, (i_p, c_p) = cuda_ms(lambda: point_kernels.correspondence_argmax_plain(qq, kk), reps=1)
    err = float((c_k - c_p).abs().max())
    diff = i_k != i_p
    tie_gap = float(((qq[diff] * kk[i_k[diff].long()]).sum(-1)
                     - (qq[diff] * kk[i_p[diff].long()]).sum(-1)).abs().max()) if bool(diff.any()) else 0.0
    n, m, e = qq.shape[0], kk.shape[0], qq.shape[1]
    # the logits' f32 multiply-adds (the softmax's exp per logit not counted)
    b = bound(4 * e * (n + m) + 8 * n, 2 * n * m * e, F32_FLOPS)
    results["corr_argmax"] = result(err, ms, plain_ms, b)
    log(f"K3 corr     5625 x 80000 x 12: conf max_abs_err {err:.3e} (tol {TOL['corr_argmax']}), "
        f"index mismatches {int(diff.sum())} (logit gap {tie_gap:.2e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b[0]:.3f} ms ({b[1]})")
    if not (err <= TOL["corr_argmax"] and float(diff.float().mean()) < 1e-3 and tie_gap < 1e-5):
        raise AssertionError("K3 disagrees with its plain version")
    return results


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
    return counts, 1e3 * wall_s / n_steps


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
    bias 0), both embeddings.  K6 runs on K5's own residuals and outputs
    with random cotangents.  Returns {name: (worst error, kernel ms, plain
    ms)}, the times summed over the four shapes of the direct embedding:
    one 4,800-ray chunked step's launches (2 chunks x 2 passes)."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk

    worst = {"field_color_fwd": 0.0, "field_color_bwd": 0.0}
    step_ms = {"field_color_fwd": [0.0, 0.0], "field_color_bwd": [0.0, 0.0]}
    work = {"field_color_fwd": [0, 0], "field_color_bwd": [0, 0]}  # bytes, operations of one chunked step
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
            ms, (dk, rk, res_k) = cuda_ms(lambda: fk.field_color_fwd_cuda(*fwd))
            plain_ms, (dp, rp, res_p) = cuda_ms(lambda: fk.field_color_fwd_plain(*fwd), reps=1)
            dk2, rk2, res_k2 = fk.field_color_fwd_cuda(*fwd)
            err = max(float((dk - dp).abs().max()), float((rk - rp).abs().max()))
            share = max(float(((dk - dp).abs() > 1e-4).float().mean()), float(((rk - rp).abs() > 1e-4).float().mean()))
            res_share = max(float((res_k[k] != res_p[k]).float().mean()) for k in fk.RESIDUALS)
            same = (torch.equal(dk, dk2) and torch.equal(rk, rk2)
                    and all(torch.equal(res_k[k], res_k2[k]) for k in fk.RESIDUALS))
            del dp, rp, res_p, dk2, rk2, res_k2
            log(f"K5 field_color_fwd {embed} {R} rays x {P} points (dens std {float(dk.std()):.3f}): dens / rgb max abs "
                f"err {err:.3e} (tol {TOL['color_abs']}), share > 1e-4 {share:.2e}; residuals not bit-equal "
                f"{res_share:.2e} (tol {TOL['res_share']}); second launch bit-identical: {same}; kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms")
            if not (err <= TOL["color_abs"] and share < 1e-3 and res_share <= TOL["res_share"] and same
                    and float(dk.std()) > 1e-3):
                raise AssertionError(f"K5 disagrees with its plain version ({embed}, {R} x {P})")
            worst["field_color_fwd"] = max(worst["field_color_fwd"], err)
            g = torch.Generator(device=dev).manual_seed(seed + R)
            bwd = (dn, fm, weights, res_k, dk, rk, torch.randn(dk.shape, generator=g, device=dev),
                   torch.randn(rk.shape, generator=g, device=dev), ladder, beta)
            bms, gk = cuda_ms(lambda: fk.field_color_bwd_cuda(*bwd))
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
                E, nh = weights[0].shape[1], weights[2].shape[-1]
                ff, res_bytes = field_flops(E, nh), 2 * (2 * E + 3 * nh)
                # K5 reads points and writes dens, rgb and the bf16 residuals;
                # K6 reads the residuals, dens, rgb and their cotangents
                fwd = (R * P * (12 + 16 + res_bytes) + R * 12 + weight_bytes(E, nh), R * P * ff["fwd"] + R * ff["ray"])
                bwd = (R * P * (res_bytes + 32) + R * 12 + 2 * weight_bytes(E, nh), R * P * ff["bwd"] + R * ff["ray"])
                for name, pair in (("field_color_fwd", fwd), ("field_color_bwd", bwd)):
                    work[name] = [a + b for a, b in zip(work[name], pair)]
            del dk, rk, res_k, bwd, gk, gp, gk2
    bounds = {name: bound(*work[name], BF16_FLOPS) for name in work}
    log(f"K5 / K6 per chunked step (direct, 4,096 + 704 rays x (64 + 320) points): K5 kernel "
        f"{step_ms['field_color_fwd'][0]:.3f} ms, plain {step_ms['field_color_fwd'][1]:.3f} ms, bound "
        f"{bounds['field_color_fwd'][0]:.3f} ms ({bounds['field_color_fwd'][1]}); K6 kernel "
        f"{step_ms['field_color_bwd'][0]:.3f} ms, plain {step_ms['field_color_bwd'][1]:.3f} ms, bound "
        f"{bounds['field_color_bwd'][0]:.3f} ms ({bounds['field_color_bwd'][1]})")
    return {name: result(worst[name], *step_ms[name], bounds[name]) for name in worst}


def chunked_step_vs_plain_step(state, data, dev, render, train, tag: str, whole_step: bool):
    """One chunked train step through K5 / K6 and one through their plain
    versions, from copies of the same state, on the first batch of the
    schedule with the same draws.  ``whole_step`` holds the loss and both
    fields' grads to the bars; otherwise they are reported (the fine pass
    resamples from the coarse weights, which magnifies ulp differences on
    a trained surface, as for K4)."""
    import copy

    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    images, sils, R_bop, t_bop, K = data
    n, S, bs = images.shape[0], images.shape[1], CHUNKED["batch"]
    idx = torch.as_tensor(nerf_trainer.half_schedule(n, bs, 1, CHUNKED["seed"])[0], device=dev)
    cams = cam_lib.camera_from_bop(R_bop, t_bop, K, S)
    cam = cam_lib.Camera(cams.R[idx][None], cams.T[idx][None], cams.focal[idx][None], cams.principal[idx][None], S)
    min_d, max_d = nerf_trainer.depth_bounds(t_bop.cpu().numpy())
    draws = nerf_trainer.draw([nerf_trainer.step_generator(CHUNKED["seed"], 0, dev)], bs, render, dev)
    args = (cam, images[idx][None], sils[idx][None], nerf_trainer.make_optimizer(train), render, train, min_d, max_d)
    (a,), loss_a, _ = nerf_trainer.train_step([copy.deepcopy(state)], *args, draws=draws)
    ops = fk.field_color_fwd_op, fk.field_color_bwd_op
    fk.field_color_fwd_op, fk.field_color_bwd_op = fk.field_color_fwd_plain, fk.field_color_bwd_plain
    try:  # this step only: the plain versions on the card
        (b,), loss_b, _ = nerf_trainer.train_step([copy.deepcopy(state)], *args, draws=draws)
    finally:
        fk.field_color_fwd_op, fk.field_color_bwd_op = ops
    sync(dev)
    loss_rel = float((loss_a - loss_b).abs().max() / loss_b.abs().max())
    err = {}
    for which in ("coarse", "fine"):
        err[which] = max(float((pa.grad - pb.grad).abs().max()) / max(float(pb.grad.abs().max()), 1e-3)
                         for (_, pa), (_, pb) in zip(nerf_trainer.trainable(getattr(a, which)),
                                                     nerf_trainer.trainable(getattr(b, which))))
    log(f"chunked train step at the {tag} state, K5 / K6 vs plain from the same state and draws: loss "
        f"{float(loss_a[0]):.6f} vs {float(loss_b[0]):.6f} (rel err {loss_rel:.2e}); grad max err / tensor max |g|: "
        f"coarse {err['coarse']:.2e}, fine {err['fine']:.2e}")
    if whole_step and not (loss_rel <= TOL["loss_rel"] and max(err.values()) <= TOL["grad_scaled"]):
        raise AssertionError(f"the chunked step through K5 / K6 disagrees with the step through their plain "
                             f"versions ({tag})")


def chunked_train_path(dev, seed: int, n_steps: int, profile: str | None = None):
    """``train_nerf`` on synthetic half 0 at the reference's large-batch
    schedule (``CHUNKED``): K5's and K6's launches counted over exactly the
    measured run, a kernel step against a plain step, exact resume through
    ``train.checkpoint``, and the trained fine field's point cloud."""
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

    # the trained fine field's point cloud against the analytic surface (reported)
    t0 = time.perf_counter()
    verts, tris = nerf_trainer.extract_point_cloud(state.fine, threshold=0.03, grid_res=128)
    peak = float(renderer.density_grid_cached(state.fine, grid_res=128).max())
    gt, ok = synthetic.analytic_surface_points(20000, torch.Generator(device=dev).manual_seed(9), device=dev)
    cham = float("nan")
    if verts.shape[0]:
        sub = verts[np.random.default_rng(0).permutation(verts.shape[0])[:20000]]
        cham = float(pc.chamfer_distance(torch.as_tensor(sub, dtype=torch.float32, device=dev), gt[ok]))
    log(f"extract_point_cloud of the step-{n_steps} fine field at 128^3 (threshold 0.03, grid max density "
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


def serve_path(dev, seed: int, out_dir: str, profile: str | None = None):
    """The bench's bake -> inference -> ADD -> verification -> ICP stages.
    With ``profile``, a further run under torch.profiler writes its kernel
    table there and logs the device's busy share."""
    import numpy as np
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        FeatConfig,
        FieldConfig,
        InferenceConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import (
        ResNetUNet,
        normalize_image,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import (
        artifacts,
        gen_feat,
        inference,
        registration,
    )

    n_views, img, grid, n_inf = SERVE["n_views"], SERVE["image_size"], SERVE["grid_res"], SERVE["n_infer"]
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
        """One run of the serving stages; returns its outputs and stage times."""
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
        return verts_scaled, feats, verts_real, n_real, adds, pred_R, pred_t, R_gt, t_gt, best, chamfers, \
            cad, upper, lower, out, stages

    once("cold: first call, cuDNN and allocator warm-up")
    # the measured run: launch counts cover exactly this run of the path
    reset_launch_counts()
    (verts_scaled, feats, verts_real, n_real, adds, pred_R, pred_t, R_gt, t_gt, best, chamfers,
     cad, upper, lower, out, stages) = once("warm")
    counts = {k: launch_counts()[k] for k in SERVE_KERNELS}
    log("launches in the serve run: " + json.dumps(counts))
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
    # FPS at the bake's size, timed on its own (a sequential loop of small launches)
    hits = torch.as_tensor(verts_real / scale, device=dev)
    t_fps = time.perf_counter()
    pc.farthest_point_sampling(hits, hits.shape[0])
    sync(dev)
    log(f"FPS of {hits.shape[0]} points: {1e3 * (time.perf_counter() - t_fps):.1f} ms (host clock)")
    if not all(c > 0 for c in counts.values()):
        raise AssertionError(f"a kernel of the serving path never launched: {counts}")
    return counts, stages


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", metavar="PATH",
                        help="also profile one serve run (kernel table to PATH) and 20 training steps (PATH.train.txt)")
    parser.add_argument("--nerf-steps", type=int, default=200, help="NeRF training steps (the bench runs 800)")
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

    phases = kernel_phases(dev, args.seed)
    phases["bundle_loss"] = bundle_loss_phase(dev, args.seed)
    phases.update(field_color_phase(dev, args.seed))
    train_counts, _ = train_path(dev, args.seed, args.nerf_steps, args.profile)
    chunked_counts, _ = chunked_train_path(dev, args.seed, args.chunk_steps, args.profile)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        counts, _ = serve_path(dev, args.seed, out_dir, args.profile)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    counts["bundle_loss"] = train_counts["bundle_loss"]
    counts.update({k: chunked_counts[k] for k in ("field_color_fwd", "field_color_bwd")})
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
