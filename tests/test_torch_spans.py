"""The program's spans (``utils/profiling.py`` ``span``) and the launch
context of the hand-written kernels (``ops/cuda_build.py`` ``launch``), on
the CPU: a span costs one check while the profiler is off and opens a
``record_function`` while it records, and the NeRF step (fused through
K4's plain version, and chunked), the descriptor step, pose estimation and
SurfEmb's estimator show each of their stage spans under a CPU profiler,
nested as their modules document; SurfEmb's counters count its work."""

import contextlib

import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
    FieldConfig,
    NerfTrainConfig,
    PoseTrainConfig,
    RenderConfig,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as aug_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer as nt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer as pt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import profiling

torch.set_num_threads(1)

CPU = torch.device("cpu")
RENDER = RenderConfig(n_rays_per_image=24, n_pts_coarse=8, n_pts_fine=12)
TRAIN = NerfTrainConfig(batch_size=2, warmup_steps=4)
UNET = dict(widths=(8, 16, 16), stage_sizes=(1, 1, 1), decoder_width=8, dtype=torch.float32)
S = 32

# the stages of each path, in the order the host enters them, and the
# spans each encloses
NERF_FUSED = (["nerf.rays", "nerf.field", "nerf.adam"], {"nerf.field": ["nerf.coarse", "nerf.resample", "nerf.fine"]})
NERF_CHUNKED = (["nerf.rays", "nerf.field", "nerf.adam"], {"nerf.field": ["nerf.chunk"]})
POSE = (["pose.augment", "pose.forward", "pose.backward", "pose.adam"],
        {"pose.forward": ["pose.unet", "pose.head", "pose.loss"]})
INFER = (["infer.unet", "infer.k3", "infer.filter", "infer.draw", "infer.ransac"],
         {"infer.ransac": ["pnp.p3p", "pnp.score", "pnp.refine"]})


def _spans(fn) -> list:
    """(name, start, end) of every program span that ``fn`` opens under a
    CPU profiler, in the order they start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(profiling.SPAN_PREFIXES)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _assert_stages(spans, layout, counts=None):
    """Each top-level stage appears, none inside another, in this order;
    each child lies inside an instance of its parent and of no other
    top-level stage; ``counts``: instances of a name."""
    top, children = layout
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    names = top + [c for cs in children.values() for c in cs]
    assert set(by) == set(names), sorted(by)
    firsts = [by[n][0][1] for n in top]
    assert firsts == sorted(firsts)
    tops = [s for n in top for s in by[n]]
    assert not any(a is not b and _inside(a, b) for a in tops for b in tops)
    for parent, kids in children.items():
        for k in kids:
            for s in by[k]:
                homes = [t for t in tops if _inside(s, t)]
                assert [h[0] for h in homes] == [parent], (s, homes)
    for name, n in (counts or {}).items():
        assert len(by[name]) == n, (name, len(by[name]))


# ------------------------------------------------------------ the primitive


def test_span_off_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("nerf.rays"), profiling.span("kernel.density")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a as x:
        assert x is None


def test_span_on_opens_a_record_function():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s = profiling.span("infer.k3")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(4).sum()
    assert [e.name for e in prof.events() if e.name == "infer.k3"] == ["infer.k3"]


def test_launch_counts_once_a_launch_under_its_span(monkeypatch):
    """``launch`` makes the device current, names the launch
    ``kernel.<name>`` and counts it once it returns: on the wrapper's total
    and its device's entry; a launch that raises is not counted."""
    entered = []

    @contextlib.contextmanager
    def current(device):
        entered.append(device)
        yield

    monkeypatch.setattr(torch.cuda, "device", current)

    def wrapper():
        pass

    cuda_build.reset(wrapper)
    dev = torch.device("cuda", 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with cuda_build.launch(wrapper, "nn_min", dev):
                assert wrapper.launches == len(entered) - 1
    with pytest.raises(ValueError), cuda_build.launch(wrapper, "nn_min", dev):
        raise ValueError("launch failed")
    assert wrapper.launches == 3 and wrapper.per_device == {1: 3} and entered == [dev] * 4
    assert [e.name for e in prof.events() if e.name.startswith("kernel.")] == ["kernel.nn_min"] * 3


def test_launch_counts_each_variant_under_its_name(monkeypatch):
    """A wrapper whose kernel has variants launches each under its own
    name: the wrapper's total counts both, ``by_name`` each, and ``reset``
    clears all three counts."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())

    def wrapper():
        pass

    cuda_build.reset(wrapper)
    dev = torch.device("cuda", 0)
    for name in ("bundle_loss", "bundle_loss_act32", "bundle_loss_act32"):
        with cuda_build.launch(wrapper, name, dev):
            pass
    assert wrapper.launches == 3 and wrapper.by_name == {"bundle_loss": 1, "bundle_loss_act32": 2}
    cuda_build.reset(wrapper)
    assert (wrapper.launches, wrapper.per_device, wrapper.by_name) == (0, {}, {})


# ------------------------------------------------------------ the NeRF step


@pytest.fixture(scope="module")
def nerf_inputs():
    halves = [synthetic.make_scene(n_views=2, image_size=24, generator=torch.Generator().manual_seed(h), device=CPU)
              for h in range(2)]
    st = lambda f: torch.stack([getattr(s, f) for s in halves])  # noqa: E731
    cam = cam_lib.camera_from_bop(st("R_bop"), st("t_bop"), st("K"), 24)
    lo, hi = nt.depth_bounds(st("t_bop").reshape(-1, 3).numpy(), 2.0)
    return cam, st("images"), st("sils"), lo, hi


@pytest.mark.parametrize("fused,ray_chunk,n_chunks", [(True, nt.RAY_CHUNK, 0), (False, 16, 3)],
                         ids=["fused", "chunked"])
def test_nerf_step_spans(nerf_inputs, fused, ray_chunk, n_chunks):
    """2 halves x 2 cams x 24 rays: through K4's plain version in one chunk,
    or the field's own colour path in chunks of 16 (16 + 16 + 16)."""
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", fused_kernel=fused)
    states = [nt.init_state(cfg, TRAIN, torch.Generator().manual_seed(h), device=CPU) for h in range(2)]
    cam, images, sils, lo, hi = nerf_inputs
    gens = [torch.Generator().manual_seed(9 + h) for h in range(2)]
    out = []
    spans = _spans(lambda: out.append(nt.train_step(states, cam, images, sils, nt.make_optimizer(TRAIN), RENDER,
                                                    TRAIN, lo, hi, generators=gens, ray_chunk=ray_chunk)))
    assert torch.isfinite(out[0][1]).all()
    if fused:
        _assert_stages(spans, NERF_FUSED, {"nerf.coarse": 1, "nerf.fine": 1})
    else:
        _assert_stages(spans, NERF_CHUNKED, {"nerf.chunk": n_chunks})


# ------------------------------------------------------------ the descriptor step


def test_pose_step_spans():
    g = torch.Generator().manual_seed(0)
    scene = synthetic.make_scene(n_views=2, image_size=S, generator=g, device=CPU)
    field = NerfField(FieldConfig(n_harmonic_functions=8, n_hidden=48)).reset_parameters(g)
    cfg = PoseTrainConfig(batch_size=2, sample_size=16, warmup_steps=3)
    aug_cfg = aug_lib.AugmentConfig(crop_res=S, min_mask_sum=10.0)
    state = pt.init_pose_state(field, cfg, ResNetUNet(**UNET).reset_parameters(g), device=CPU)
    M, n_neg = 64, 100
    pos_vec = torch.randn((2, M, 3), generator=g) * 0.3
    xys = torch.rand((2, M, 2), generator=g) * 1.6 - 0.8
    neg = torch.randn((n_neg, 3), generator=g) * 0.3
    draws = pt.draw_pose_step(g, 2, S, n_neg, cfg, aug_cfg)
    out = []
    spans = _spans(lambda: out.append(pt.pose_train_step(
        state, pt.make_pose_optimizer(cfg), scene.images, scene.sils, pos_vec, xys, torch.ones((2, M), dtype=bool),
        neg, cfg, aug_cfg, draws, g)))
    assert torch.isfinite(out[0][1])
    # augmentation: the views and the sampled rays, then the sampled rays' xys
    _assert_stages(spans, POSE, {"pose.augment": 2, "pose.forward": 1, "pose.backward": 1, "pose.adam": 1})


# ------------------------------------------------------------ pose estimation


def test_estimate_poses_spans():
    g = torch.Generator().manual_seed(1)
    B, n_keys = 2, 300
    cnn = ResNetUNet(**UNET).reset_parameters(g).eval()
    images = torch.randn((B, S, S, 3), generator=g)
    masks = torch.ones((B, S, S))
    K = torch.tensor([[2.1 * S, 0.0, S / 2], [0.0, 2.1 * S, S / 2], [0.0, 0.0, 1.0]]).expand(B, 3, 3)
    verts = torch.randn((n_keys, 3), generator=g) * 0.3
    feats = torch.randn((n_keys, 12), generator=g)
    out = []
    spans = _spans(lambda: out.append(inference.estimate_poses(cnn, images, masks, K, verts, feats, n_hyp=20,
                                                               generator=torch.Generator().manual_seed(2))))
    assert out[0].R.shape == (B, 3, 3)
    _assert_stages(spans, INFER, {"infer.ransac": 1, "pnp.refine": 1})


# ------------------------------------------------- SurfEmb's pose estimator

SURF = (["surf.unet", "surf.distribution", "surf.sample", "surf.p3p", "surf.score", "surf.refine"],
        {"surf.refine": ["surf.refine_setup", "surf.bfgs"]})


def test_estimate_pose_surfemb_spans_and_counters(monkeypatch):
    """Two images through ``estimate_pose_surfemb`` under a CPU profiler:
    every ``surf.*`` span once an image, the refiner's two inside
    ``surf.refine``; the counters count what the shapes say (on the CPU two
    host reads an image: the cdf's row totals and the best score; the
    refiner none)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf, pose_refine

    monkeypatch.setattr(pose_est_surf, "SURF_COUNT", dict.fromkeys(pose_est_surf.SURF_COUNT, 0))
    monkeypatch.setattr(pose_refine, "REFINE_COUNT", dict.fromkeys(pose_refine.REFINE_COUNT, 0))
    g = torch.Generator().manual_seed(3)
    n_keys, steps = 300, 3
    cnn = ResNetUNet(**UNET).reset_parameters(g).eval()
    image = torch.randn((S, S, 3), generator=g)
    K = torch.tensor([[2.1 * S, 0.0, S / 2 - 0.5], [0.0, 2.1 * S, S / 2 - 0.5], [0.0, 0.0, 1.0]])
    verts = torch.randn((n_keys, 3), generator=g) * 0.3
    normals = verts / verts.norm(dim=-1, keepdim=True)
    feats = torch.randn((n_keys, 12), generator=g)
    cfg = InferenceConfig(max_poses=64, max_pose_evaluations=16)
    out = []

    def two_images():
        for seed in (4, 5):
            out.append(inference.estimate_pose_surfemb(cnn, image, K, verts, normals, feats, 1.0, cfg=cfg,
                                                       refine_steps=steps,
                                                       generator=torch.Generator().manual_seed(seed)))

    spans = _spans(two_images)
    assert len(out) == 2 and out[0][0].shape == (3, 3)
    _assert_stages(spans, SURF, {name: 2 for name in SURF[0] + SURF[1]["surf.refine"]})
    assert pose_est_surf.SURF_COUNT == {"images": 2, "hypotheses": 128, "scored": 32, "host_reads": 4}
    assert pose_refine.REFINE_COUNT == {"bfgs_steps": 2 * steps, "value_and_grad": 2 * (steps + 1),
                                        "trial_batches": 2 * steps, "host_reads": 0}
