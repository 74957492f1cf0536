"""Configuration of the port (counterpart of config.py).

The port's own copy of the reference's frozen dataclasses, with the same
names, fields and defaults (the reference's scripts hard-code them; its
``config.py`` gathers them with their sources, cited beside each field).
A test holds them equal to the reference's field for field.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """NeRF field hyper-parameters (reference nerf.py:149-218)."""

    n_harmonic_functions: int = 60          # nerf.py:107
    omega0: float = 0.1                     # nerf.py:107
    # harmonic embedding: "direct" (one sin/cos per frequency) or "grouped"
    # (a double-angle ladder over base frequencies); training and every
    # later evaluation of a field must use the same one
    embed_method: str = "direct"
    n_hidden: int = 256                     # nerf.py:149
    feature_dim: int = 12                   # color_embedding_dims, nerf.py:149
    siren: bool = True                      # trainNerfFine.py:40
    density_bias: float = -1.5              # nerf.py:218
    softplus_beta: float = 10.0             # nerf.py:174
    # dtype of the MLP matmuls' operands (params and accumulation stay f32)
    compute_dtype: str = "bfloat16"
    # storage dtype of the activations between layers; the field kernels
    # have a variant for each
    act_dtype: str = "float32"
    # the field kernels for this field: None = auto (on for a CUDA device
    # with bf16 matmuls and bf16 or float32 activations), True / False to
    # force
    fused_kernel: bool | None = None


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Ray sampling / ray marching (trainNerfFine.py:130-137, pren.py)."""

    n_rays_per_image: int = 400             # trainNerfFine.py:133
    n_pts_coarse: int = 64                  # trainNerfFine.py:133
    n_pts_fine: int = 256                   # trainNerfFine.py:135
    add_input_samples: bool = True          # trainNerfFine.py:299
    grid_pts_per_ray: int = 256             # generateCors.py:135
    eps: float = 1e-10                      # pren.py:164
    surface_thickness: int = 1              # pren.py:165


@dataclasses.dataclass(frozen=True)
class NerfTrainConfig:
    """trainNerfFine.py:55-62,214-223."""

    lr: float = 1e-3
    # linear learning-rate warmup (the reference script has none)
    warmup_steps: int = 500
    batch_size: int = 3
    n_epochs: int = 500                     # n_iter, trainNerfFine.py:59
    loss_scale: float = 500.0               # trainNerfFine.py:334-335
    huber_scaling: float = 0.1              # nutil.py:157-164
    image_size: int = 200                   # maxB, trainNerfFine.py:61
    ckpt_every: int = 100                   # trainNerfFine.py:227
    pc_every: int = 1000                    # trainNerfFine.py:357
    seed: int = 1                           # torch.manual_seed(1)


@dataclasses.dataclass(frozen=True)
class PoseTrainConfig:
    """trainPose.py:60-77,208-236."""

    lr_cnn: float = 3e-4
    lr_mlp: float = 3e-5
    batch_size: int = 16
    sample_size: int = 1024                 # samples per image
    key_noise: float = 1e-3
    warmup_steps: int = 2000                # trainPose.py:229-236
    total_query_steps: int = 60000          # trainPose.py:214
    image_size: int = 224
    n_neg: int = 80000                      # FPS target, trainPose.py:338
    neg_bound: float = 1.2                  # trainPose.py:340
    neg_mesh_dist: float = 0.05             # trainPose.py:349-351
    mask_loss_scale: float = 1e-3           # BCE/1000, trainPose.py:430
    infonce_scale: float = 1e-3             # CE/1000, nutil.py:366,385
    ckpt_every: int = 100
    seed: int = 1
    # regularizers with no counterpart in the reference script (0.0 / 1.0 /
    # 0.0 are its behaviour): Gaussian jitter of the positive keys' sample
    # points, the InfoNCE temperature dividing the logits, and AdamW weight
    # decay on the trained feature head
    pos_noise: float = 0.0
    infonce_temp: float = 1.0
    head_weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class CorsConfig:
    """generateCors.py:110-141,297-341."""

    render_size: int = 224
    grid_pts_per_ray: int = 256             # rayCT
    density_threshold: float = 0.2          # thresholdFac
    mesh_filter_dist: float = 0.1           # generateCors.py:309,339
    outlier_nb_points: int = 20             # generateCors.py:257
    outlier_radius: float = 0.05
    n_subsurface: int = 1000                # FPS, generateCors.py:208
    normals_k: int = 400                    # neighborhood_size, generateCors.py:211
    back_len_div: float = 3.0               # generateCors.py:323


@dataclasses.dataclass(frozen=True)
class FeatConfig:
    """genFeat.py:160-228."""

    n_points: int = 80000
    bound: float = 1.2
    mc_threshold: float = 0.05
    mesh_dist: float = 0.05
    sample_loops: int = 19
    # the baked arrays' length is rounded up to this multiple (points cycled
    # to pad), so their shape is stable from run to run; 1 = exact count
    pad_multiple: int = 512


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """inference.py:31,215-294; poseEstSurf.py:13-15."""

    crop_res: int = 224
    crop_pad: float = 1.2                   # size = 224/max(w,h)/1.2
    down_sample: int = 3
    conf_keep_frac: float = 0.8             # top-80% confidence filter
    ransac_iters: int = 500
    reproj_err_px: float = 2.0
    max_poses: int = 10000                  # poseEstSurf
    max_pose_evaluations: int = 1000
    pose_batch_size: int = 500
    dist_2d_min: float = 0.1
    alpha: float = 1.5


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """icp.py:88-126, choosePose.py:116-151."""

    icp_threshold: float = 20.0
    icp_max_iters: int = 30
    agreement_metric: str = "adds"          # ADD-S < 0.1*diam
    agreement_frac: float = 0.1
    top_k_choices: int = 50


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """generate_bop_realsamples (cowrendersynth.py:610-747)."""

    dataset: str = "ruapc"
    objid: int = 1
    crop_offset: int = 5                    # offset=5 in every script of the reference
    max_b: int = 200
    diam_scaling: float = 1.8               # trainNerfFine.py:97
    # first/second half split (trainNerfFine.py:71-80)
    ruapc_total: int = 2561
    tless_total: int = 1001


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    field: FieldConfig = dataclasses.field(default_factory=FieldConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    nerf_train: NerfTrainConfig = dataclasses.field(default_factory=NerfTrainConfig)
    pose_train: PoseTrainConfig = dataclasses.field(default_factory=PoseTrainConfig)
    cors: CorsConfig = dataclasses.field(default_factory=CorsConfig)
    feat: FeatConfig = dataclasses.field(default_factory=FeatConfig)
    inference: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)
    registration: RegistrationConfig = dataclasses.field(default_factory=RegistrationConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def experiment_dir(self, root: str, uh: int) -> str:
        """Directory convention '{UH}_{dataset}_obj_{objid}' (trainNerfFine.py:44)."""
        return os.path.join(root, f"{uh}_{self.data.dataset}_obj_{self.data.objid}")


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
