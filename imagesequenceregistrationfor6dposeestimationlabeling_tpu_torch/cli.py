"""Command-line interface of the port (counterpart of cli.py): the same
commands, flags, defaults and experiment-directory layout, on the card.

  python -m imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.cli \\
      train-nerf    --objid 1 --dataset ruapc --UH 1 [--cont]
      generate-cors --objid 1 --dataset ruapc --UH 1
      train-pose    --objid 1 --dataset ruapc --UH 1 [--cont]
      gen-feat      --objid 1 --dataset ruapc --UH 1
      inference     --objid 1 --dataset ruapc --UH 0 [--id N]
      poses-est     --objid 1 --dataset ruapc --UH 0
      rel-poses     --objid 1 --dataset ruapc --UH 0 --cal-gt/--cal-pred
      choose-image  --objid 1 --dataset ruapc --UH 0
      icp           --objid 1 --dataset ruapc
      verify        --objid 1 --dataset ruapc --UH 0

Stages talk through the on-disk artifacts (pipeline/artifacts.py, the
reference's npy files) and the port's ``torch.save`` checkpoints under the
reference's names; ``--root`` selects the experiment root (default '.').
``--synthetic`` swaps the BOP loader for the analytic scene and
``--synthetic-mesh`` for the rasterized blob mesh, so the whole pipeline
runs without downloaded data.  ``poses-est`` / ``inference
--use-surf-eval`` estimate poses by SurfEmb hypothesis scoring and
refinement instead of argmax-PnP, and ``inference --full-frames`` reads
raw BOP frames and their visibility masks through the SurfEmb crop.  Every
command runs on the card (``--device cuda``, the default, raises on a host
without one); the CPU runs only for ``--device cpu``.  The field kernels
(K1, K4-K6) run at either ``--act-dtype``, each in its variant.  Random draws come from
``torch.Generator``s seeded as the reference seeds its keys.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib


def load_data(args, image_size):
    """(images, sils, R, t, K, diameter) of half ``args.UH`` as numpy: the
    mesh or the analytic scene (each drawn from a generator seeded with UH)
    or BOP crops."""
    if getattr(args, "synthetic_mesh", False):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene

        dev = resolve_device(args.device)
        scene = mesh_scene.make_mesh_scene(n_views=args.synthetic_views, image_size=image_size,
                                           generator=torch.Generator(device=dev).manual_seed(int(args.UH)), device=dev)
        diam = scene.diameter
        to_np = lambda x: x.cpu().numpy()  # noqa: E731
        return (to_np(scene.images), to_np(scene.sils), to_np(scene.R_bop), to_np(scene.t_bop) * (diam / 1.8),
                to_np(scene.K), diam)
    if args.synthetic:
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic

        dev = resolve_device(args.device)
        scene = synthetic.make_scene(n_views=args.synthetic_views, image_size=image_size,
                                     generator=torch.Generator(device=dev).manual_seed(int(args.UH)), device=dev)
        diam = scene.diameter
        to_np = lambda x: x.cpu().numpy()  # noqa: E731
        # the loader returns mm-like units
        return (to_np(scene.images), to_np(scene.sils), to_np(scene.R_bop), to_np(scene.t_bop) * (diam / 1.8),
                to_np(scene.K), diam)
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import bop

    ids = bop.half_sequence_ids(args.dataset, int(args.UH))
    if args.fsamps:
        ids = ids[: args.fsamps]
    split = "lm" if args.dataset == "lm" else "train"
    ds = os.path.join(args.bop_root, args.dataset)
    samples = bop.load_bop_samples(ds, args.objid, ids, max_b=image_size, offset=5, split_dir=split)
    return samples.images, samples.sils, samples.R, samples.t, samples.K, bop.load_diameter(ds, args.objid)


def load_other_half(args, image_size):
    """Images and GT of the OTHER half-sequence: an experiment estimates
    the poses of the other sequence's images with its own model."""
    other = copy.copy(args)
    other.UH = 1 - int(args.UH)
    return load_data(other, image_size)


def exp_dir(args):
    return os.path.join(args.root, f"{args.UH}_{args.dataset}_obj_{args.objid}")


def field_config(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig

    # the field kernels run on the card at either --act-dtype, in its variant
    # (ops/field_kernel.enabled): float32, the default, keeps them unrounded
    act = getattr(args, "act_dtype", "float32")
    if getattr(args, "field_preset", "full") == "small":
        return FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype=act)
    return FieldConfig(act_dtype=act)


def render_config(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import RenderConfig

    if getattr(args, "field_preset", "full") == "small":
        return RenderConfig(n_rays_per_image=192, n_pts_coarse=32, n_pts_fine=48)
    return RenderConfig()


def cmd_train_nerf(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import NerfTrainConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint, nerf_trainer
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import viz

    dev = resolve_device(args.device)
    cfg = NerfTrainConfig()
    S = args.image_size or cfg.image_size
    images, sils, R, t, K, diam = load_data(args, S)
    t = t / (diam / 1.8)
    fcfg = field_config(args)
    nerf_d = artifacts.nerf_dir(exp_dir(args), args.objid)
    os.makedirs(nerf_d, exist_ok=True)

    n_steps = args.steps or cfg.n_epochs * max(images.shape[0] // cfg.batch_size, 1)
    cfg = dataclasses.replace(cfg, warmup_steps=min(cfg.warmup_steps, max(n_steps // 3, 1)))

    state_path = os.path.join(nerf_d, checkpoint.STATE)
    init_params = resume_state = None
    if args.cont and checkpoint.exists(state_path):
        # full-state resume: params + Adam moments + step (exact)
        resume_state = checkpoint.load_state(state_path, fcfg, device=dev)
        print(f"continuing exactly from step {resume_state.step}")
    elif args.cont and checkpoint.exists(os.path.join(nerf_d, checkpoint.LATEST_FINE)):
        # params-only fallback
        pc, _ = checkpoint.load(os.path.join(nerf_d, checkpoint.LATEST), device=dev)
        pf, step0 = checkpoint.load(os.path.join(nerf_d, checkpoint.LATEST_FINE), device=dev)
        init_params = (pc, pf)
        print(f"continuing (params only) from step {step0}")

    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    cam0 = cam_lib.camera_from_bop(f32(R[:1]), f32(t[:1]), f32(K[:1]), S)[0]
    min_d, max_d = nerf_trainer.depth_bounds(t)
    milestone = {"done": False}

    def save_latest(state, step):
        checkpoint.save_latest(nerf_d, state)
        # the milestone snapshot at step 50,000
        if step >= 50000 and not milestone["done"]:
            checkpoint.save(os.path.join(nerf_d, "nerf50000Fine"), state.fine.state_dict(), step)
            milestone["done"] = True
        if args.viz_every and step % args.viz_every < cfg.ckpt_every:
            rgb, sil = viz.render_preview(state.fine, cam0, S, 64, min_d, max_d, mode="color")
            previews = os.path.join(nerf_d, "previews")
            viz.save_image(os.path.join(previews, f"{step}_rgb.png"), rgb)
            viz.save_image(os.path.join(previews, f"{step}_sil.png"), sil)
            viz.save_image(os.path.join(previews, f"{step}_grid.png"),
                           viz.image_grid([rgb, sil], rows=1, cols=2, fill=False))
        # point-cloud dumps every pc_every; the final cloud is extracted
        # after training either way
        if step % cfg.pc_every < cfg.ckpt_every and step >= cfg.pc_every:
            try:
                v, _ = nerf_trainer.extract_point_cloud(state.fine, threshold=0.03, grid_res=args.grid_res)
                artifacts.save_array(nerf_d, "v1fine.npy", v)
                vc, _ = nerf_trainer.extract_point_cloud(state.coarse, threshold=0.03, grid_res=args.grid_res)
                artifacts.save_array(nerf_d, "v1.npy", vc)
            except Exception as e:  # early in training there may be no surface
                print(f"pc dump skipped at {step}: {e}")

    state, losses = nerf_trainer.train_nerf(
        images, sils, R, t, K, fcfg, render_config(args), cfg, n_steps=n_steps, log_every=args.log_every,
        on_checkpoint=save_latest, init_params=init_params, resume_state=resume_state, device=dev,
    )
    checkpoint.save_latest(nerf_d, state)
    verts, _ = nerf_trainer.extract_point_cloud(state.fine, threshold=0.03)
    artifacts.save_array(nerf_d, "v1fine.npy", verts)
    vc, _ = nerf_trainer.extract_point_cloud(state.coarse, threshold=0.03)
    artifacts.save_array(nerf_d, "v1.npy", vc)
    last = f"{losses[-1]:.4f}" if losses else "(no step run)"
    print(f"trained {n_steps} steps; final loss {last}; cloud {verts.shape[0]} verts -> {nerf_d}")


def load_field(args, which: str = "nerflatestFine"):
    """The trained fine NerfField of this experiment on the run's device;
    with ``--synthetic`` and no checkpoint, the analytic stand-in."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint

    dev = resolve_device(args.device)
    path = os.path.join(artifacts.nerf_dir(exp_dir(args), args.objid), which)
    if args.synthetic and not checkpoint.exists(path):
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic

        return synthetic.AnalyticField(device=dev)
    tree, _ = checkpoint.load(path, device=dev)
    field = NerfField(field_config(args))
    field.load_state_dict(tree)
    return field.to(dev)


def _analytic(field) -> bool:
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic

    return isinstance(field, synthetic.AnalyticField)


def cmd_generate_cors(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import CorsConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import generate_cors

    field = load_field(args)
    # the analytic stand-in has a sharp 0.5-level surface; trained NeRFs
    # use the reference's 0.2
    cfg = CorsConfig(density_threshold=0.5 if _analytic(field) else 0.2)
    if args.image_size:
        # smoke scale: short-trained NeRFs have fuzzier surfaces, so the
        # denoising filters loosen like the other smoke-scale stages'
        cfg = dataclasses.replace(cfg, render_size=args.image_size, grid_pts_per_ray=96, mesh_filter_dist=0.15,
                                  outlier_nb_points=4, outlier_radius=0.2, n_subsurface=200, normals_k=48)
    images, sils, R, t, K, diam = load_data(args, cfg.render_size)
    t = t / (diam / 1.8)
    cors = generate_cors.generate_cors(field, R, t, K, sils, exp_dir(args), args.objid, cfg, grid_res=args.grid_res,
                                       device=resolve_device(args.device))
    print(f"correspondences -> {cors}")


def _load_cnn(path: str, dev):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint

    tree, step = checkpoint.load(path, device=dev)
    cnn = ResNetUNet()
    cnn.load_state_dict(tree)
    return cnn.to(dev), step


def cmd_train_pose(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import PoseTrainConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import normalize_image
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as aug_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint, pose_trainer
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import viz

    dev = resolve_device(args.device)
    cfg = PoseTrainConfig()
    if args.image_size:
        # smoke scale: shorter-trained NeRFs have a fuzzier surface shell
        cfg = dataclasses.replace(cfg, image_size=args.image_size, sample_size=128, neg_mesh_dist=0.15)
    images, sils, R, t, K, diam = load_data(args, cfg.image_size)
    t = t / (diam / 1.8)
    exp = exp_dir(args)
    cors = artifacts.cors_dir(exp, args.objid)
    pose_d = artifacts.pose_dir(exp, args.objid)
    os.makedirs(pose_d, exist_ok=True)
    field = load_field(args)
    if _analytic(field):
        # the analytic stand-in has no trainable feature head: a fresh
        # field (seed 0) takes its place, so descriptor training has keys
        field = NerfField(field_config(args)).reset_parameters(torch.Generator().manual_seed(0)).to(dev)

    # phase 1: the negatives, once (--neg-only stops after them), at the
    # trained field's threshold 0.2: after the swap above the field always
    # is a NerfField
    neg_path = os.path.join(pose_d, "negVec.npy")
    if not os.path.exists(neg_path):
        neg = pose_trainer.build_negatives(
            field, R, t, K, sils, artifacts.load_array(cors, "a1.npy"), cfg, image_size=cfg.image_size,
            threshold=0.2, generator=torch.Generator(device=dev).manual_seed(0), device=dev,
        ).cpu().numpy()
        np.save(neg_path, neg)
        print(f"negVec built: {neg.shape} -> {neg_path}")
        if args.neg_only:
            return
    neg = np.load(neg_path)

    bank = pose_trainer.load_ray_bank(cors, cfg.image_size, images.shape[0], device=dev)
    n_steps = args.steps or int(cfg.total_query_steps * cfg.batch_size / images.shape[0])
    state_path = os.path.join(pose_d, checkpoint.STATE)

    # few.npy: the image ids this run trains on
    if args.synthetic:
        few = np.arange(images.shape[0])
    else:
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import bop

        few = np.asarray(bop.half_sequence_ids(args.dataset, int(args.UH)))
        if args.fsamps:
            few = few[: args.fsamps]
    np.save(os.path.join(exp, f"{args.objid}few.npy"), few)

    img0_n = normalize_image(torch.as_tensor(images[:1], dtype=torch.float32, device=dev))

    def save_latest(st, step):
        checkpoint.save_pose_latest(pose_d, st)
        # query-embedding and mask-logit previews
        if args.viz_every and step % args.viz_every < cfg.ckpt_every:
            with torch.no_grad():
                feat = st.cnn(img0_n)[0].cpu().numpy()
            emb, mask = viz.emb_vis(feat[..., :12], sils[0]), 1.0 / (1.0 + np.exp(-feat[..., 12]))
            previews = os.path.join(pose_d, "previews")
            viz.save_image(os.path.join(previews, f"{step}_emb.png"), emb)
            viz.save_image(os.path.join(previews, f"{step}_mask.png"), mask)
            viz.save_image(os.path.join(previews, f"{step}_grid.png"),
                           viz.image_grid([emb, mask], rows=1, cols=2, fill=False))

    cnn = resume_state = None
    if args.cont and checkpoint.exists(state_path):
        # full-state resume: both nets' params + Adam moments + step (exact)
        resume_state = checkpoint.load_pose_state(state_path, field.cfg, device=dev)
        print(f"continuing descriptor training exactly from step {resume_state.step}")
    elif args.cont and checkpoint.exists(os.path.join(pose_d, checkpoint.ENCODER)):
        cnn, step0 = _load_cnn(os.path.join(pose_d, checkpoint.ENCODER), dev)
        nerf_resume_path = os.path.join(pose_d, checkpoint.LATEST)
        if checkpoint.exists(nerf_resume_path):
            field.load_state_dict(checkpoint.load(nerf_resume_path, device=dev)[0])
        print(f"continuing descriptor training (params only) from step {step0}")

    # content augmentation: distractor pastes and image-file backgrounds
    aug_cfg = None
    if args.distractors or args.distractor_dir:
        aug_cfg = aug_lib.AugmentConfig(crop_res=cfg.image_size, min_mask_sum=10.0, p_distractor=0.3)
    bg_bank = None
    if args.bg_dir:
        bg_bank = aug_lib.load_background_bank(args.bg_dir, cfg.image_size)
        print(f"background bank: {bg_bank.shape[0]} images from {args.bg_dir}")
    distractor_bank = None
    if args.distractor_dir:
        distractor_bank = aug_lib.load_distractor_bank(args.distractor_dir, cfg.image_size)
        print(f"distractor bank: {distractor_bank[0].shape[0]} crops from {args.distractor_dir}")

    state, losses = pose_trainer.train_pose(
        field, images, sils, bank, neg, cfg=cfg, aug_cfg=aug_cfg, n_steps=n_steps, cnn=cnn,
        log_every=args.log_every, on_checkpoint=save_latest, resume_state=resume_state, bg_bank=bg_bank,
        distractor_bank=distractor_bank, device=dev,
    )
    checkpoint.save_pose_latest(pose_d, state)
    last = f"{losses[-1]:.5f}" if losses else "(no step run)"
    print(f"pose training done ({n_steps} steps, final loss {last}) -> {pose_d}")


def cmd_gen_feat(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FeatConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import gen_feat

    dev = resolve_device(args.device)
    S = args.image_size or 224
    images, sils, R, t, K, diam = load_data(args, S)
    t = t / (diam / 1.8)
    field = load_field(args)
    # thresholds follow the FIELD: the analytic stand-in has a sharp
    # 0.5-level surface; a trained NeRF uses 0.2 for hits and 0.05 for the
    # mesh, as generate-cors does
    analytic = _analytic(field)
    verts, _, _ = gen_feat.gen_feat(
        field, R, t, K, sils, diam, exp_dir(args), args.objid,
        FeatConfig(mc_threshold=0.5 if analytic else 0.05, n_points=8000 if args.image_size else 80000,
                   sample_loops=3 if args.image_size else 19, mesh_dist=0.15 if args.image_size else 0.05),
        image_size=S, grid_res=args.grid_res, threshold=0.5 if analytic else 0.2,
        generator=torch.Generator(device=dev).manual_seed(0),
    )
    print(f"baked {verts.shape[0]} surface features -> {exp_dir(args)}")


def _serving_inputs(args, image_size: int, trim: bool = False):
    """(device, experiment dir, keys (verts, feats, n_real) as tensors, the
    OTHER half's data, the trained CNN)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint

    dev = resolve_device(args.device)
    exp = exp_dir(args)
    pose_d = artifacts.pose_dir(exp, args.objid)
    # padded keys for correspondence; n_real for the trimmed metric cloud
    verts, feats, _, n_real = artifacts.load_keys(pose_d, trim=trim)
    other = load_other_half(args, image_size)
    cnn, _ = _load_cnn(os.path.join(pose_d, checkpoint.ENCODER), dev)
    return dev, exp, (_f32(verts, dev), _f32(feats, dev), n_real), other, cnn


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


def _surf_normals(args, dev) -> torch.Tensor:
    """The baked normals (normals_scaled.npy) of the SurfEmb path."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts

    return _f32(artifacts.load_array(artifacts.pose_dir(exp_dir(args), args.objid), "normals_scaled.npy"), dev)


def cmd_poses_est(args):
    """Per-image poses of the OTHER half-sequence -> pred_R.npy / pred_t.npy."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import normalize_image
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference

    dev, exp, (verts, feats, _), (images, sils, R, t, K, diam), cnn = _serving_inputs(args, args.image_size or 224)
    imgs_n = normalize_image(torch.as_tensor(images, dtype=torch.float32, device=dev))
    if args.use_surf_eval:
        # SurfEmb hypothesis scoring and refinement, one image at a time
        # from one generator (seed 1)
        pred_R, pred_t, _ = inference.run_sequence_surfemb(cnn, imgs_n, K, verts, _surf_normals(args, dev), feats,
                                                           diam, seed=1, device=dev)
    else:
        # the batch loop (seed 1), split over every card when there are several
        pred_R, pred_t = inference.run_sequence(cnn, imgs_n, sils, K, verts, feats, seed=1, device=dev)
    np.save(os.path.join(exp, f"{args.objid}pred_R.npy"), pred_R)
    np.save(os.path.join(exp, f"{args.objid}pred_t.npy"), pred_t)
    print(f"saved {pred_R.shape[0]} poses -> {exp}")


def cmd_inference(args):
    """Per-image pose and ADD(-S) accuracy counters against the GT; writes
    <obj>correctly_predicted_list.txt."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import normalize_image
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference

    if args.full_frames and not args.synthetic:
        return _inference_full_frames(args)
    dev, exp, (verts, feats, n_real), (images, sils, R_gt, t_gt, K, diam), cnn = _serving_inputs(
        args, args.image_size or 224)
    f32 = lambda x: _f32(x, dev)  # noqa: E731
    imgs_n = normalize_image(f32(images))
    sils_t, K_t, R_t, t_t = f32(sils), f32(K), f32(R_gt), f32(t_gt)
    ids = range(images.shape[0]) if args.id < 0 else [args.id]
    work_ct = rot_work_ct = tot = 0
    correct_ids = []
    # the images draw their RANSAC (or SurfEmb) samples from one generator in turn
    gen = torch.Generator(device=dev).manual_seed(1)
    symmetric = args.dataset == "tless"
    m = metrics.adds_metric if symmetric else metrics.add_metric
    verts_m = verts[:n_real]  # metric cloud without the cycled pad tail
    zero = torch.zeros(3, device=dev)
    normals = _surf_normals(args, dev) if args.use_surf_eval else None
    for i in ids:
        if args.use_surf_eval:
            # one image: its hypotheses split over every card when there are several
            R_i, t_i, _ = inference.estimate_pose_surfemb(cnn, imgs_n[i], K_t[i], verts, normals, feats, diam,
                                                          generator=gen, hyp_mesh=mesh_lib.auto_mesh(device=dev))
        else:
            est = inference.estimate_pose_single(cnn, imgs_n[i], sils_t[i], K_t[i], verts, feats, generator=gen)
            R_i, t_i = est.R[0], est.t[0]
        err = float(m(verts_m, R_t[i], t_t[i], R_i, t_i))
        err_r = float(m(verts_m, R_t[i], zero, R_i, zero))
        tot += 1
        if err < 0.1 * diam:
            work_ct += 1
            correct_ids.append(i)
        if err_r < 0.1 * diam:
            rot_work_ct += 1
        print(f"img {i}: ADD{'S' if symmetric else ''}={err:.3f} rotOnly={err_r:.3f} (0.1*diam={0.1 * diam:.3f}) "
              f"workCT={work_ct}/{tot}")
    with open(os.path.join(exp, f"{args.objid}correctly_predicted_list.txt"), "w") as f:
        for i in correct_ids:
            f.write(f"{i}\n")
    print(f"final: workCT={work_ct} rotWorkCT={rot_work_ct} total={tot}")


def _inference_full_frames(args):
    """``inference --full-frames``: the OTHER half's raw BOP frames (or
    ``--id``'s) and visibility masks through the SurfEmb crop, ADD (ADD-S
    against the baked cloud for tless) of the CAD model's points (the baked
    cloud where no PLY is on disk) against the GT."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import bop
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, inference
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint

    dev = resolve_device(args.device)
    exp = exp_dir(args)
    pose_d = artifacts.pose_dir(exp, args.objid)
    verts, feats, _, n_real = artifacts.load_keys(pose_d, trim=False)
    verts, feats = _f32(verts, dev), _f32(feats, dev)
    cnn, _ = _load_cnn(os.path.join(pose_d, checkpoint.ENCODER), dev)
    frame_ids = bop.half_sequence_ids(args.dataset, 1 - int(args.UH))
    if args.fsamps:
        frame_ids = frame_ids[: args.fsamps]
    if args.id >= 0:
        frame_ids = [args.id]
    ds = os.path.join(args.bop_root, args.dataset)
    full = bop.load_bop_full_frames(ds, args.objid, frame_ids)
    diam = bop.load_diameter(ds, args.objid)
    # the frames draw their RANSAC samples from one generator in turn
    gen = torch.Generator(device=dev).manual_seed(1)
    work_ct = tot = 0
    correct_ids = []
    verts_m = verts[:n_real]  # metric cloud without the cycled pad tail
    # the ADD / ADD-S query cloud is the CAD model's vertices; ADD-S's
    # neighbours are the baked surface cloud
    try:
        metric_verts = _f32(bop.load_cad_points(ds, args.objid), dev)
    except OSError:
        metric_verts = verts_m  # no CAD ply on disk: the baked cloud
    if args.dataset == "tless":
        def m(*pose):
            return metrics.adds_metric(metric_verts, *pose, surface_points=verts_m)
    else:
        def m(*pose):
            return metrics.add_metric(metric_verts, *pose)
    for a, i in enumerate(full.ids):
        est = inference.estimate_pose_full_frame(cnn, full.frames[a], full.masks[a], full.K[a], verts, feats,
                                                 cfg=InferenceConfig(), generator=gen, device=dev)
        err = float(m(_f32(full.R[a], dev), _f32(full.t[a], dev), est.R[0], est.t[0]))
        tot += 1
        if err < 0.1 * diam:
            work_ct += 1
            correct_ids.append(int(i))
        print(f"img {int(i)}: ADD={err:.3f} (0.1*diam={0.1 * diam:.3f}) workCT={work_ct}/{tot}")
    with open(os.path.join(exp, f"{args.objid}correctly_predicted_list.txt"), "w") as f:
        for i in correct_ids:
            f.write(f"{i}\n")
    print(f"final: workCT={work_ct} total={tot}")


def cmd_rel_poses(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import registration

    dev = resolve_device(args.device)
    exp = exp_dir(args)
    # GT and predicted relative poses can both be asked for in one call
    tags = [t for t, on in (("gt", args.cal_gt), ("pred", args.cal_pred)) if on] or ["gt"]
    for tag in tags:
        if tag == "pred":
            R = np.load(os.path.join(exp, f"{args.objid}pred_R.npy"))
            t = np.load(os.path.join(exp, f"{args.objid}pred_t.npy"))
        else:
            # GT of the estimated (OTHER-half) images
            _, _, R, t, _, _ = load_other_half(args, 64)
        rel_R, rel_t = registration.relative_pose_tensor(torch.as_tensor(R, dtype=torch.float32, device=dev),
                                                         torch.as_tensor(t, dtype=torch.float32, device=dev))
        n = R.shape[0]
        T = np.zeros((n, n, 4, 4))
        T[..., :3, :3] = rel_R.cpu().numpy()
        T[..., :3, 3] = rel_t.cpu().numpy()
        T[..., 3, 3] = 1
        np.save(os.path.join(exp, f"{args.objid}{tag}_relative_poses.npy"), T)
        print(f"saved {tag} relative poses {T.shape} -> {exp}")


def cmd_choose_image(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.pointcloud import farthest_point_sampling
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, registration

    dev = resolve_device(args.device)
    exp = exp_dir(args)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    gt = np.load(os.path.join(exp, f"{args.objid}gt_relative_poses.npy"))
    pr = np.load(os.path.join(exp, f"{args.objid}pred_relative_poses.npy"))
    # trimmed cloud: the cycled pad tail would bias FPS and ADD-S
    verts = f32(artifacts.load_keys(artifacts.pose_dir(exp, args.objid))[0])
    sub = verts[farthest_point_sampling(verts, min(512, verts.shape[0]))]
    diam = load_data(args, 64)[5]
    agree, _ = registration.agreement_matrix(f32(gt[..., :3, :3]), f32(gt[..., :3, 3]), f32(pr[..., :3, :3]),
                                             f32(pr[..., :3, 3]), sub, diam, mesh=mesh_lib.auto_mesh(device=dev))
    agree = agree.cpu().numpy()
    best, top = registration.choose_best_image(agree, top_k=50)
    with open(os.path.join(exp, f"{args.objid}top_50_choices.txt"), "w") as f:
        for i in top:
            f.write(f"{i}\n")
    np.save(os.path.join(exp, f"{args.objid}error.npy"), agree.astype(np.float64))
    print(f"best image: {best}; top-50 saved")


def cmd_icp(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import bop
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, registration

    dev = resolve_device(args.device)
    exp0 = os.path.join(args.root, f"0_{args.dataset}_obj_{args.objid}")
    exp1 = os.path.join(args.root, f"1_{args.dataset}_obj_{args.objid}")
    # trimmed clouds: the cycled pad tail would double-weight the prefix in
    # the ICP fit and the Chamfer mean
    upper = artifacts.load_keys(artifacts.pose_dir(exp1, args.objid))[0]
    lower = artifacts.load_keys(artifacts.pose_dir(exp0, args.objid))[0]
    with open(os.path.join(exp0, f"{args.objid}top_50_choices.txt")) as f:
        chosen = int(f.readline())
    pred_R = np.load(os.path.join(exp0, f"{args.objid}pred_R.npy"))[chosen]
    pred_t = np.load(os.path.join(exp0, f"{args.objid}pred_t.npy"))[chosen]
    if args.synthetic:
        # the GT pose of the chosen image: an OTHER-half (UH=1) image, since
        # the 0_ experiment's predicted poses are of that half
        from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic

        args.UH = 0
        _, _, R, t, _, diam = load_other_half(args, 64)
        gt_R, gt_t = R[chosen], t[chosen]
        pts, ok = synthetic.analytic_surface_points(20000, torch.Generator(device=dev).manual_seed(9), device=dev)
        cad = pts[ok].cpu().numpy() * (diam / 1.8)
    else:
        ds = os.path.join(args.bop_root, args.dataset)
        with open(os.path.join(ds, "train", str(args.objid).zfill(6), "scene_gt.json")) as f:
            gt = json.load(f)
        gt_R = np.asarray(gt[str(chosen)][0]["cam_R_m2c"]).reshape(3, 3)
        gt_t = np.asarray(gt[str(chosen)][0]["cam_t_m2c"])
        cad = bop.load_cad_points(ds, args.objid)
        diam = bop.load_diameter(ds, args.objid)
    out = registration.register_halves(upper, lower, gt_R, gt_t, pred_R, pred_t, cad, diam,
                                       icp_threshold=args.icp_threshold, device=dev)
    summary = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in out.items() if k != "merged"}
    print(json.dumps(summary, default=float))


def cmd_verify(args):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, registration

    exp = exp_dir(args)
    # trimmed cloud: duplicates would double-weight the Chamfer mean
    cloud = artifacts.load_keys(artifacts.pose_dir(exp, args.objid))[0]
    pred_R = np.load(os.path.join(exp, f"{args.objid}pred_R.npy"))
    pred_t = np.load(os.path.join(exp, f"{args.objid}pred_t.npy"))
    _, _, R, t, _, _ = load_data(args, 64)
    n = min(len(R), len(pred_R))
    best, chams = registration.verify_consecutive(cloud[:5000], R[:n], t[:n], pred_R[:n], pred_t[:n],
                                                  device=resolve_device(args.device))
    print(f"best image {best}, min chamfer {min(chams):.4f}")


def cmd_video(args):
    """Rotating-field video: render a camera ring around the trained fine
    field and save the frames and an animated GIF (Pillow)."""
    from PIL import Image

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import viz

    dev = resolve_device(args.device)
    field = load_field(args)
    nerf_d = artifacts.nerf_dir(exp_dir(args), args.objid)
    S = args.image_size or 128
    Rs, ts = viz.rotating_views(n_frames=args.frames, dist=4.0)
    K = np.asarray([[2.1 * S, 0.0, S / 2], [0.0, 2.1 * S, S / 2], [0.0, 0.0, 1.0]])
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    out_dir = os.path.join(nerf_d, "video")
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i in range(args.frames):
        cam = cam_lib.camera_from_bop(f32(Rs[i: i + 1]), f32(ts[i: i + 1]), f32(K)[None], S)[0]
        if _analytic(field):
            with torch.no_grad():
                images, _, _ = renderer.render_grid_chunked(synthetic.analytic_field, cam, S, 64, 2.0, 6.0,
                                                            mode="color", chunk=S * S)
            rgb = images[:, :3].reshape(S, S, 3).cpu().numpy()
        else:
            rgb, _ = viz.render_preview(field, cam, S, 64, 2.0, 6.0, mode="color")
        viz.save_image(os.path.join(out_dir, f"{i:03d}.png"), rgb)
        frames.append(Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)))
    gif = os.path.join(nerf_d, "rotating.gif")
    frames[0].save(gif, save_all=True, append_images=frames[1:], duration=100, loop=0)
    print(f"{args.frames} frames -> {out_dir}; gif -> {gif}")


def cmd_check(args):
    """Print the shapes of the pipeline's artifacts."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts

    exp = exp_dir(args)
    cors = artifacts.cors_dir(exp, args.objid)
    pose_d = artifacts.pose_dir(exp, args.objid)
    for d, name in [
        (cors, "a1.npy"), (cors, "subvert1.npy"), (cors, "subnormal1.npy"),
        (pose_d, "negVec.npy"), (pose_d, "vert1_scaled.npy"),
        (pose_d, "feat1_scaled.npy"), (pose_d, "normals_scaled.npy"),
    ]:
        p = os.path.join(d, name)
        print(f"{p}: {np.load(p).shape}" if os.path.exists(p) else f"{p}: MISSING")
    for i in range(3):
        if artifacts.has_view_rays(cors, 224, i):
            _, pv, _, bv = artifacts.load_view_rays(cors, 224, i)
            print(f"view {i}: posVec {pv.shape} back {bv.shape}")


COMMANDS = {
    "train-nerf": cmd_train_nerf,
    "generate-cors": cmd_generate_cors,
    "train-pose": cmd_train_pose,
    "gen-feat": cmd_gen_feat,
    "inference": cmd_inference,
    "poses-est": cmd_poses_est,
    "rel-poses": cmd_rel_poses,
    "choose-image": cmd_choose_image,
    "icp": cmd_icp,
    "verify": cmd_verify,
    "check": cmd_check,
    "video": cmd_video,
}


def build_parser():
    p = argparse.ArgumentParser(prog="isr6d-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--objid", default=1, type=int)
        sp.add_argument("--dataset", default="ruapc")
        sp.add_argument("--UH", default=0, type=int)
        sp.add_argument("--root", default=".")
        sp.add_argument("--bop-root", default="bop")
        sp.add_argument("--cont", action="store_true")
        sp.add_argument("--synthetic", action="store_true")
        sp.add_argument("--synthetic-mesh", action="store_true",
                        help="mesh-rasterized synthetic data (the rasterized blob mesh)")
        sp.add_argument("--synthetic-views", default=8, type=int)
        sp.add_argument("--fsamps", default=0, type=int)
        sp.add_argument("--steps", default=0, type=int)
        sp.add_argument("--log-every", default=100, type=int)
        sp.add_argument("--grid-res", default=128, type=int)
        sp.add_argument("--act-dtype", default="float32", choices=("float32", "bfloat16"),
                        help="field activation storage (the field kernels run in its variant on the card)")
        sp.add_argument("--image-size", default=0, type=int, help="override stage image size (smoke runs)")
        sp.add_argument("--field-preset", default="full", choices=["full", "small"],
                        help="small = tiny NeRF for smoke runs")
        sp.add_argument("--viz-every", default=100, type=int,
                        help="training preview-image cadence (0 = off)")
        sp.add_argument("--device", default="cuda",
                        help="where the command runs: the card (cuda, the default; raises on a host without one) "
                             "or cpu")

    for name, fn in COMMANDS.items():
        sp = sub.add_parser(name)
        common(sp)
        sp.set_defaults(fn=fn)
        if name == "train-pose":
            sp.add_argument("--neg-only", action="store_true")
            sp.add_argument("--distractors", action="store_true",
                            help="paste the batch's other views as distractors, p=0.3")
            sp.add_argument("--bg-dir", default="", help="directory of background images")
            sp.add_argument("--distractor-dir", default="",
                            help="directory of other-object masked crops pasted as occluding distractors, p=0.3")
        if name == "rel-poses":
            sp.add_argument("--cal-gt", action="store_true")
            sp.add_argument("--cal-pred", action="store_true")
        if name == "icp":
            sp.add_argument("--icp-threshold", default=20.0, type=float)
        if name in ("inference", "poses-est"):
            sp.add_argument("--id", default=-1, type=int)
            sp.add_argument("--use-surf-eval", action="store_true",
                            help="SurfEmb hypothesis scoring + refinement instead of argmax-PnP")
        if name == "video":
            sp.add_argument("--frames", default=36, type=int, help="number of rotating views")
        if name == "inference":
            sp.add_argument("--full-frames", action="store_true",
                            help="raw rgb / mask_visib frames through the SurfEmb affine crop, camMat = Ms @ K")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # every command runs on the card unless --device names another, so on
    # a host without one every command raises here (even those that touch
    # no device)
    resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
