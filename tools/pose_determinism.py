#!/usr/bin/env python3
"""Is descriptor training bit-reproducible on the card, and what does a
step cost?  Runs ``train_pose`` of the package under ``--root`` on one CUDA
device at the chain's settings (8 synthetic views at 224 px, a full-width
bf16 NerfField and ResNetUNet, 1,024 samples a view, the round-5
augmentation with the batch's rolled views as distractors), with a random
ray bank and random negatives:

1. ``--steps`` steps under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``: every warning the run raises is printed once (an op
   with no deterministic implementation names itself in one);
2. two runs of ``--steps`` steps from one seed, without that flag: are the
   parameters, the Adam moments and the losses bit-identical?  Where the
   tree has the step's two repairs (``grid_sample.gather_rows``,
   ``device.deterministic_cudnn``), also with each of them undone and with
   both: which op breaks the repeat;
3. warm ms a step: a run of ``--time-steps`` + 2 steps less a run of 2,
   each timed on the host clock between two synchronizations, so a run's
   set-up and its first two steps (on the card: the eager step and the
   capture of the step's graph) cancel.

    python3 tools/pose_determinism.py [--root DIR] [--steps 5] [--time-steps 20]

Compare two trees in one call on the same card: run it with each tree's
root in turn (A B B A).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="directory holding the package to run")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--time-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig, PoseTrainConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment, pose_trainer

    dev = torch.device("cuda")
    V, S, M = 8, 224, 4096
    scene = synthetic.make_scene(V, S, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    xys = torch.rand((V, M, 2), generator=g, device=dev) * 2.0 - 1.0
    pos = torch.randn((V, M, 3), generator=g, device=dev) * 0.4
    valid = torch.ones((V, M), dtype=torch.bool, device=dev)
    bank = pose_trainer.RayBank(pos, xys, pos, xys, valid, valid)
    neg = torch.randn((6000, 3), generator=g, device=dev) * 0.4
    field = NerfField(FieldConfig(act_dtype="bfloat16")).reset_parameters(
        torch.Generator().manual_seed(args.seed + 2)).to(dev)
    cfg = PoseTrainConfig(warmup_steps=100)
    aug_cfg = augment.AugmentConfig(crop_res=S, min_mask_sum=10.0, p_distractor=0.5, scale_jitter=0.15,
                                    trans_frac=0.2)

    def run(n):
        return pose_trainer.train_pose(field, scene.images, scene.sils, bank, neg, cfg=cfg, aug_cfg=aug_cfg,
                                       n_steps=n, seed=1, device=dev)

    def flat(state, losses):
        opt = state.opt
        return ([p.detach().clone() for p in state.field.parameters()] + [p.detach().clone() for p in
                                                                          state.cnn.parameters()]
                + [t.clone() for t in opt.head_mu + opt.head_nu + opt.cnn_mu + opt.cnn_nu]
                + [torch.tensor(losses, dtype=torch.float64)])

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            run(args.steps)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0] for w in caught})
    print(f"warnings under use_deterministic_algorithms(True, warn_only=True) ({len(ops)}):")
    for op in ops:
        print("  " + op)

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import grid_sample

    repaired = hasattr(grid_sample, "gather_rows")

    @contextlib.contextmanager
    def undone(gather: bool, cudnn: bool):
        saved = grid_sample.gather_rows if repaired else None
        saved_ctx = getattr(pose_trainer, "deterministic_cudnn", None)
        if gather:
            grid_sample.gather_rows = lambda flat, idx: torch.gather(flat, 1, idx[..., None].expand(
                -1, -1, flat.shape[2]))
        if cudnn:
            pose_trainer.deterministic_cudnn = contextlib.nullcontext
        try:
            yield
        finally:
            if repaired:
                grid_sample.gather_rows = saved
                pose_trainer.deterministic_cudnn = saved_ctx

    variants = {"as is": (False, False)}
    if repaired:
        variants.update({"torch.gather's backward": (True, False), "cuDNN's own choice": (False, True),
                         "both": (True, True)})
    repeat = {}
    for name, (gather, cudnn) in variants.items():
        with undone(gather, cudnn):
            a, b = flat(*run(args.steps)), flat(*run(args.steps))
        torch.cuda.synchronize()
        differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
        repeat[name] = differ
        print(f"{name}: two {args.steps}-step runs, {len(a)} tensors (params, Adam moments, losses), {differ} "
              f"differ; losses {a[-1].tolist()} / {b[-1].tolist()}")

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(2)
    ms = 1e3 * (timed(args.time_steps + 2) - timed(2)) / args.time_steps
    print(json.dumps({"root": args.root, "device": torch.cuda.get_device_name(0), "tensors_differing": repeat,
                      "warnings": ops, "warm_ms_per_step": ms}))


if __name__ == "__main__":
    main()
