"""Descriptor training, the port against the JAX reference at a small size
(32 px views, a 48-hidden field, a three-stage f32 ResNet-UNet, 2
views a batch x 32 samples): the augmentation ops, InfoNCE, and whole
``train_pose`` steps from a state carried across by ``convert``.  Every
random draw is the reference's, made along its key path with
``jax.random`` here and handed to the port as ``PoseDraws``:

    PRNGKey(seed) -> split -> (k_init, key); fold_in(key, done) per call,
    split per step -> step key -> (k_aug, k_sel, k_noise)
    k_aug -> split(., B)[b] -> split(., 18): the view's augment draws
    k_sel -> split(., B)[b]: categorical over the augmented in-bounds rays
    k_noise -> (k_noise', k_pos); k_noise' -> (k_pick, k_jitter)
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fields import _bf16_blocks_sum

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FieldConfig, PoseTrainConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models.unet import ResNetUNet as JUNet
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import augment as jaug
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import pose_trainer as jpt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import config as tconfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet as TUNet
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as taug
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer as tpt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train.nerf_trainer import step_generator, step_seed

torch.set_num_threads(1)

S, B, V, NS, M = 32, 2, 4, 32, 64
SEED = 3
# three stages: the deepest map is 2 x 2, so each GroupNorm group holds 8 values
UNET = dict(widths=(8, 16, 16), stage_sizes=(1, 1, 1), decoder_width=8)
AUG = jaug.AugmentConfig(crop_res=S, min_mask_sum=10.0, p_distractor=0.5, scale_jitter=0.15, trans_frac=0.2)
# unit loss scales (the reference's are 1e-3): grads well above Adam's eps
POSE = PoseTrainConfig(batch_size=B, sample_size=NS, warmup_steps=3, ckpt_every=1, infonce_scale=1.0,
                       mask_loss_scale=1.0)
FIELD = FieldConfig(n_harmonic_functions=8, n_hidden=48)
FIELD_NOSIREN = FieldConfig(n_harmonic_functions=8, n_hidden=48, siren=False)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_cfg(cfg):
    return getattr(tconfig, type(cfg).__name__)(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _aug_draws_fn(cfg, bank: int):
    """jitted: the reference's augment_view draws of a batch of view keys."""

    def one(kb):
        k = jax.random.split(kb, 18)
        u = jax.random.uniform
        kj, ki = jax.random.split(k[9], 3), jax.random.split(k[16], 4)
        j, tf = cfg.scale_jitter, cfg.trans_frac
        return dict(
            rot=u(k[0]), scale=u(k[1], minval=1 - j, maxval=1 + j), trans=u(k[2], (2,), minval=-tf, maxval=tf),
            occlude=jnp.stack([u(x) for x in jax.random.split(k[3], 4)]), occlude_on=u(k[4]),
            line=jnp.stack([u(x) for x in jax.random.split(k[5], 3)]), line_on=u(k[6]),
            background=(jax.random.randint(k[7], (), 0, bank) if bank else u(k[7], (8, 8, 3))),
            background_on=u(k[8]), gain=u(kj[0], (3,), minval=0.8, maxval=1.2),
            bias=u(kj[1], (3,), minval=-0.08, maxval=0.08), gamma=u(kj[2], minval=0.8, maxval=1.25),
            jitter_on=u(k[10]), border_on=u(k[11]),
            shift=jax.random.randint(jax.random.split(k[12])[0], (2,), -S // 2, S // 2),
            distractor_on=u(k[13]), sigma=u(k[14], minval=0.3, maxval=1.0), blur_on=u(k[15]),
            iso_intensity=u(ki[0], minval=0.1, maxval=0.5), iso_shift=u(ki[1], minval=0.01, maxval=0.05),
            iso_luma=jax.random.normal(ki[2], (S, S, 1)), iso_chroma=jax.random.normal(ki[3], (S, S, 3)),
            iso_on=u(k[17]))

    return jax.jit(jax.vmap(one))


def aug_draws(view_keys, cfg=AUG, bank: int = 0) -> taug.AugmentDraws:
    """The reference's augment_view draws for each view key, stacked."""
    got = _aug_draws_fn(cfg, bank)(view_keys)
    return taug.AugmentDraws(**{f: _t(got[f]) for f in taug.AugmentDraws._fields})


@functools.lru_cache(maxsize=None)
def _augment_fn(cfg, with_bank: bool):
    """jitted: the reference's augment_view over a batch, rolled-view
    distractors."""

    def run(keys, images, sils, bank):
        dis = (jnp.roll(images, 1, 0), jnp.roll(sils, 1, 0))
        return jax.vmap(jaug.augment_view, in_axes=(0, 0, 0, None, (0, 0), None))(
            keys, images, sils, cfg, dis, bank if with_bank else None)

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _select_fn(n: int):
    return jax.jit(lambda keys, xys, A, t, valid: jax.vmap(jaug.select_ray_samples, in_axes=(0, 0, 0, None))(
        keys, jax.vmap(jaug.transform_xys)(xys, A, t), valid, n))


def step_draws(key, images, sils, xys, valid, n_neg, cfg=POSE, aug_cfg=AUG) -> tpt.PoseDraws:
    """The reference step's draws from its step key (rolled-view
    distractors, no banks)."""
    k_aug, k_sel, k_noise = jax.random.split(key, 3)
    keys = jax.random.split(k_aug, images.shape[0])
    aug = _augment_fn(aug_cfg, False)(keys, images, sils, None)
    sel = _select_fn(cfg.sample_size)(jax.random.split(k_sel, images.shape[0]), xys, aug.A, aug.t, valid)
    k_noise, _ = jax.random.split(k_noise)
    k_pick, k_jitter = jax.random.split(k_noise)
    shape = (images.shape[0], cfg.sample_size)
    return tpt.PoseDraws(aug_draws(keys, aug_cfg), None, _t(sel).long(), None,
                         _t(jax.random.randint(k_pick, shape, 0, n_neg)).long(),
                         _t(jax.random.normal(k_jitter, shape + (3,))))


@pytest.fixture(scope="module")
def data():
    scene = jsyn.make_scene(n_views=V, image_size=S, key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    xys = rng.uniform(-1.1, 1.1, (V, M, 2)).astype(np.float32)
    return dict(images=np.array(scene.images), sils=np.array(scene.sils), xys=xys,
                pos=(rng.normal(size=(V, M, 3)) * 0.4).astype(np.float32), valid=rng.uniform(size=(V, M)) > 0.2,
                neg=(rng.normal(size=(50, 3)) * 0.4).astype(np.float32))


# ----------------------------------------------------------------- the ops


def test_augment_config_matches_reference():
    assert taug.AugmentConfig._fields == jaug.AugmentConfig._fields
    assert taug.AugmentConfig() == tuple(jaug.AugmentConfig())


def test_augment_view_with_replayed_draws(data):
    """Every output of a batch of augmented views, with distractors and with a
    background bank: the ops are elementwise and gathers, so only f32
    roundings in another order remain (the rgb's pow, exp, sqrt)."""
    idx = np.array([1, 3])
    img, sil = jnp.asarray(data["images"][idx]), jnp.asarray(data["sils"][idx])
    bank = np.random.default_rng(1).uniform(size=(5, S, S, 3)).astype(np.float32)
    for n_bank in (0, 5):
        keys = jax.random.split(jax.random.PRNGKey(11 + n_bank), 2)
        dis = (jnp.roll(img, 1, 0), jnp.roll(sil, 1, 0))
        want = _augment_fn(AUG, bool(n_bank))(keys, img, sil, jnp.asarray(bank) if n_bank else None)
        got = taug.augment_view(_t(img), _t(sil), taug.AugmentConfig(*AUG), aug_draws(keys, bank=n_bank),
                                (_t(dis[0]), _t(dis[1])), _t(bank) if n_bank else None)
        for f in jaug.Augmented._fields:
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=2e-5, err_msg=f)


def test_warp_ops_match_reference():
    """The packed warp against the reference's, and against the port's own
    three separate warps.  A nearest tap may flip only where the source
    coordinate sits within 1e-4 of a pixel edge (A's inverse is a closed
    form here, an LU solve there)."""
    rng = np.random.default_rng(2)
    rgb = rng.uniform(size=(3, S, S, 3)).astype(np.float32)
    mf = (rng.uniform(size=(3, S, S)) > 0.5).astype(np.float32)
    mc = mf * (rng.uniform(size=(3, S, S)) > 0.3)
    th = rng.uniform(0, 2 * np.pi, 3)
    A = (np.stack([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]).transpose(2, 0, 1)
         * rng.uniform(0.7, 1.4, (3, 1, 1))).astype(np.float32)
    t = rng.uniform(-0.2, 0.2, (3, 2)).astype(np.float32)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(jaug.warp_all_ndc))(*map(jnp.asarray, (rgb, mf, mc, A, t)))]
    got = [x.numpy() for x in taug.warp_all_ndc(*map(_t, (rgb, mf, mc, A, t)))]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    px, py = (x.numpy() for x in taug._source_pixels(_t(A), _t(t), S))
    edge = (np.abs(px - np.round(px)) < 1e-4) | (np.abs(py - np.round(py)) < 1e-4)
    for g, w in zip(got[1:], want[1:]):
        assert ((g != w) <= edge).all()
    sep = taug.warp_affine_ndc(_t(rgb), _t(A), _t(t))
    np.testing.assert_allclose(sep.numpy(), got[0], atol=1e-6)
    near = taug.warp_affine_ndc(_t(mf), _t(A), _t(t), nearest=True).numpy()
    assert ((near != got[1]) <= edge).all()
    ref_near = np.asarray(jax.jit(jax.vmap(lambda m, a, b: jaug.warp_affine_ndc(m, a, b, nearest=True)))(
        jnp.asarray(mf), jnp.asarray(A), jnp.asarray(t)))
    assert ((near != ref_near) <= edge).all()


def test_blur_noise_and_xys_transform_match_reference():
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(2, S, S, 3)).astype(np.float32)
    sigma = np.array([0.3, 0.9], np.float32)
    want = np.asarray(jax.jit(jax.vmap(jaug.gaussian_blur3))(jnp.asarray(img), jnp.asarray(sigma)))
    np.testing.assert_allclose(taug.gaussian_blur3(_t(img), _t(sigma)).numpy(), want, atol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    # augment_view's ISO noise key is split(key, 18)[16]
    iso = jax.jit(jax.vmap(lambda k, x: jaug.iso_noise(jax.random.split(k, 18)[16], x)))
    want = np.asarray(iso(keys, jnp.asarray(img)))
    d = aug_draws(keys)
    got = taug.iso_noise(_t(img), d.iso_intensity, d.iso_shift, d.iso_luma, d.iso_chroma).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    xys = rng.uniform(-1, 1, (2, 7, 2)).astype(np.float32)
    A = rng.normal(size=(2, 2, 2)).astype(np.float32)
    t = rng.normal(size=(2, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(jaug.transform_xys)(*map(jnp.asarray, (xys, A, t))))
    np.testing.assert_allclose(taug.transform_xys(*map(_t, (xys, A, t))).numpy(), want, atol=1e-6)


def test_select_ray_samples_support():
    """The port draws from the reference's distribution: uniform over the
    valid in-bounds rays, ray 0 alone when there are none."""
    xys = np.array([[[0.5, 0.2], [1.2, 0.0], [-0.3, -0.99], [0.1, 0.1]],
                    [[1.5, 0.0], [0.0, -1.5], [2.0, 2.0], [1.0, 0.0]]], np.float32)
    valid = np.array([[True, True, True, False], [True, True, True, True]])
    got = taug.select_ray_samples(_t(xys), _t(valid), 400, torch.Generator().manual_seed(0)).numpy()
    want = np.stack([np.asarray(jaug.select_ray_samples(jax.random.PRNGKey(i), jnp.asarray(xys[i]),
                                                        jnp.asarray(valid[i]), 400)) for i in range(2)])
    for g, w in zip(got, want):
        assert set(g.tolist()) == set(w.tolist())
    assert set(got[0].tolist()) == {0, 2} and set(got[1].tolist()) == {0}


def test_info_nce_matches_reference():
    rng = np.random.default_rng(6)
    q, k = rng.normal(size=(2, 2, 5, 4)).astype(np.float32)
    kn = rng.normal(size=(2, 7, 4)).astype(np.float32)
    for temp in (1.0, 2.5):
        want = float(jpt.info_nce_with_neg(jnp.asarray(q), jnp.asarray(k), jnp.asarray(kn), 1e-3, temp=temp))
        got = float(tpt.info_nce_with_neg(_t(q), _t(k), _t(kn), 1e-3, temp=temp))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    key = jax.random.PRNGKey(8)
    want = float(jpt.info_nce_in_batch(jnp.asarray(q), jnp.asarray(k), key, neg_frac=0.6))
    perm = _t(jax.random.permutation(key, 5)).long()
    np.testing.assert_allclose(float(tpt.info_nce_in_batch(_t(q), _t(k), perm, neg_frac=0.6)), want, rtol=1e-6)


# ------------------------------------------------------------ train_pose


@pytest.fixture(scope="module")
def reference_run(data):
    """3 steps of the reference's train_pose from a fresh state, one step a
    call (ckpt_every=1), the state kept after each."""
    return _reference_run(data, FIELD)


@pytest.fixture(scope="module")
def reference_runs(data):
    """``_reference_run`` per field config, each run once."""
    cache = {}

    def run(field_cfg):
        if field_cfg not in cache:
            cache[field_cfg] = _reference_run(data, field_cfg)
        return cache[field_cfg]

    return run


def _reference_run(data, field_cfg):
    jf = jfields.NerfField(field_cfg)
    jcnn = JUNet(**UNET, dtype=jnp.float32)
    st0 = jpt.init_pose_state(jf, jfields.init_field(jf, jax.random.PRNGKey(1)), POSE, jax.random.PRNGKey(2), S,
                              cnn=jcnn)
    bank = jpt.RayBank(*(jnp.asarray(data[k]) for k in ("pos", "xys", "pos", "xys", "valid", "valid")))
    states = []
    _, _, losses = jpt.train_pose(jf, st0.nerf_params, data["images"], data["sils"], bank, data["neg"], cfg=POSE,
                                  aug_cfg=AUG, n_steps=3, seed=SEED, cnn=jcnn, resume_state=st0, mesh=None,
                                  steps_per_call=1,
                                  on_checkpoint=lambda st, i: states.append(jax.tree.map(np.array, st)))
    return jax.tree.map(np.array, st0), states, np.asarray(losses)


def reference_draws(data, step: int):
    """The draws of step ``step`` of the reference's train_pose at one step a
    call, on that step's batch."""
    key = jax.random.split(jax.random.PRNGKey(SEED))[1]
    _, sub = jax.random.split(jax.random.fold_in(key, step))
    idx = jpt_schedule(data)[step]
    return step_draws(sub, *(jnp.asarray(data[k][idx]) for k in ("images", "sils", "xys", "valid")),
                      data["neg"].shape[0])


def jpt_schedule(data, n_steps=3):
    rng = np.random.default_rng(SEED)
    return np.stack([rng.permutation(V)[:B] for _ in range(n_steps)])


def _port_state(st, field_cfg=FIELD):
    return convert.pose_state_from_jax(st, _port_cfg(field_cfg), TUNet(**UNET, dtype=torch.float32), device="cpu")


def _port_field(field_cfg=FIELD):
    return tfields.NerfField(_port_cfg(field_cfg)).reset_parameters(torch.Generator().manual_seed(1))


def _port_bank(data):
    return tpt.RayBank(*(_t(data[k]) for k in ("pos", "xys", "pos", "xys", "valid", "valid")))


def test_train_pose_steps_match_reference(data, reference_run):
    """Step 1's loss and grads, and the params after each of 3 steps.  Grads
    are read from the reference's first moments after step 1 (mu = 0.1 g).
    Grad bars: per tensor, 1e-3 of its max |g| plus 1e-5 of the max |g|
    over all (tensors whose grads cancel analytically, the keys' output
    bias under the shift-invariant softmax and GroupNorm at 1x1
    resolution, read f32 noise)."""
    _check_train_pose_steps(data, reference_run, FIELD, "feature_layer.out", ())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_train_pose_steps_match_reference_nosiren(data, reference_runs, compute):
    """The same with the softplus MLP head (siren=False): feat1 / feat2
    train, and their Adam moments cross through ``pose_state_from_jax`` in
    ``named_parameters()`` order.  The keys pass a sigmoid, so no head
    tensor's grad cancels analytically.  Each step's loss is held to the
    reference's to 1e-6 relative, but steps 2-3 with bf16 products (below).

    With f32 products the params after each of the 3 steps are held as the
    SIREN test holds them, except that an element whose step-1 grad lies
    within its grad bar of 0 may step anywhere within twice the summed rates
    (Adam's step there follows the grad's f32 noise).

    With bf16 products a bias grad of the head is the sum of its layer's
    bf16 row cotangents: the port sums them in f32, the compiled reference
    (``lax.reduce_sum`` of a bf16 array, XLA on the CPU) row by row in bf16,
    which strays by ~3 % of the max here.  So the port's rows, summed the
    reference's way, are held to the reference's bias grads at the bar of
    every other tensor (as
    test_torch_fields.py::test_nosiren_head_grads_match_flax shows bit for
    bit outside a step), and the port's own grad to their f32 sum.  The
    params are held after step 1 only, as far as the grad bar allows Adam's
    first step (as the card's test of a step does; an element whose grad is
    near 0 may step anywhere within twice the rate): from step 2 on, the
    bias elements whose grads sit near 0 have parted by up to the rate, and
    the grads that read them follow.  Steps 2-3 are held by their losses to
    3e-5 relative: they part by 1.1e-5 here, 3 % of the loss's own move
    from step to step."""
    field_cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, siren=False, compute_dtype=compute)
    bf16 = compute == "bfloat16"
    _check_train_pose_steps(data, reference_runs(field_cfg), field_cfg, "feat2",
                            ("feat1.bias", "feat2.bias") if bf16 else (), first_step_only=bf16,
                            near_zero_slack=not bf16, later_loss_rtol=3e-5 if bf16 else 1e-6)


def _check_train_pose_steps(data, run, field_cfg, out_layer, bf16_summed, first_step_only=False,
                            near_zero_slack=False, later_loss_rtol=1e-6):
    st0, ref_states, ref_losses = run
    assert jpt_schedule(data).tolist() == tpt.view_schedule(V, B, 3, SEED).tolist()
    seen = []

    def hook(state, step):
        grads = {n: p.grad.clone() for n, p in list(state.cnn.named_parameters())
                 + list(state.field.named_parameters()) if p.grad is not None}
        seen.append((copy.deepcopy(state), grads))

    start = _port_state(st0, field_cfg)
    head_names = [n for n, _ in start.field.named_parameters() if n.split(".")[0] in tfields.FEATURE_HEAD_MODULES]
    assert len(start.opt.head_mu) == len(head_names) and all(
        m.shape == p.shape for m, p in zip(start.opt.head_mu, tpt.head_params(start.field)))
    rows = []                       # the head layers' row cotangents of each call, in forward order
    dense = tfields._dense_bf16

    def recorded(x, weight, bias):
        y = dense(x, weight, bias)
        i = len(rows)
        rows.append(None)
        y.register_hook(lambda g: rows.__setitem__(i, g.to(torch.bfloat16).float().reshape(-1, g.shape[-1])))
        return y

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfields, "_dense_bf16", recorded)
        state, losses = tpt.train_pose(start.field, data["images"], data["sils"], _port_bank(data), data["neg"],
                                       cfg=_port_cfg(POSE), aug_cfg=taug.AugmentConfig(*AUG), n_steps=3,
                                       seed=SEED, resume_state=start, on_checkpoint=hook, device="cpu",
                                       draws=lambda i: reference_draws(data, i))
    assert len(seen) == 3 and state.step == 3 and state.opt.count == 3
    assert np.isfinite(losses).all() and len(losses) == 3
    np.testing.assert_allclose(losses[:1], ref_losses[:1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(losses[1:], ref_losses[1:], rtol=later_loss_rtol, atol=0)
    st1 = ref_states[0]
    mu_cnn = convert.params_from_jax(st1.opt_state.inner_states["cnn"].inner_state[0].mu[1])
    mu_head = convert._feature_head_state(st1.opt_state.inner_states["train"].inner_state[0].mu[0]["params"])
    want = {n: mu.numpy() / 0.1 for n, mu in {**mu_cnn, **mu_head}.items()}
    got = seen[0][1]
    assert set(got) == set(want)
    g_all = max(np.abs(w).max() for w in want.values())
    grad_bars = {}
    for n, w in want.items():
        bar = grad_bars[n] = 1e-3 * np.abs(w).max() + 1e-5 * g_all
        g = got[n]
        if n in bf16_summed:
            # step 1's two feature calls (positives, negatives): feat1, feat2, feat1, feat2
            calls = [rows[i] for i in ((0, 2) if n.startswith("feat1") else (1, 3))]
            own = sum(r.sum(0).to(torch.bfloat16).float() for r in calls)
            assert np.abs(g.numpy() - own.numpy()).max() <= 1e-6 * np.abs(w).max(), n
            # the compiled reference's reduction of the port's rows: row by row in bf16
            g = sum(_bf16_blocks_sum(r, blocks=1) for r in calls)
            grad_bars[n] = max(bar, float(np.abs(got[n].numpy() - w).max()))   # what Adam's first step reads
        assert np.abs(g.numpy() - w).max() <= bar, n
    # params after each step: Adam's update is scale-free, and where a grad's
    # steps partly cancel its direction follows their f32 roundings, so each
    # param is held to 1e-6 plus 5 % of its group's summed rates (a wrong
    # grad moves it by up to twice the rate a step), and all but 1 % to
    # 1e-6.  The keys' output bias has a grad of 0 (the softmax is shift-
    # invariant): Adam steps it along the f32 noise, up to the rate a step
    opt = tpt.PoseOptimizer(_port_cfg(POSE))
    if first_step_only:
        _check_first_step_params(seen[0][0], ref_states[0], want, grad_bars, opt)
        return
    for k, ((port, _), ref) in enumerate(zip(seen, ref_states)):
        refp = {**convert.params_from_jax(ref.cnn_params), **convert.params_from_jax(ref.nerf_params)}
        errs = []
        for group, base in ((port.cnn, POSE.lr_cnn), (port.field, POSE.lr_mlp)):
            rates = sum(opt.learning_rate(base, i) for i in range(k + 1))
            for n, p in group.named_parameters():
                err = np.abs(p.detach().numpy() - refp[n].numpy()).ravel()
                # the head's bf16-summed bias grads (the non-SIREN head) differ by their
                # summation: Adam's step on an element near 0 may move by up to twice the rate
                bar = 2.0 * rates if n == "feature_layer.out.bias" or n in bf16_summed else 1e-6 + 0.05 * rates
                if near_zero_slack and n in want:
                    # an element whose step-1 grad is within its bar of 0
                    bar = np.where(np.abs(want[n]).ravel() <= grad_bars[n], 2.0 * rates, bar)
                assert (err <= bar).all(), (k, n, float(err.max()))
                errs.append(err)
        assert (np.concatenate(errs) > 1e-6).mean() < 0.01, k
    # frozen trunk, moving head; the step-1 loss to f32 rounding
    f0 = convert.params_from_jax(st0.nerf_params)
    assert torch.equal(state.field.trunk1.weight, f0["trunk1.weight"])
    assert not torch.equal(state.field.get_parameter(f"{out_layer}.weight"), f0[f"{out_layer}.weight"])


def _check_first_step_params(port, ref, grads, grad_bars, opt):
    """The params after step 1: Adam's first step moves each by rate * g /
    (|g| + eps), and a grad error delta moves that by at most delta * eps /
    (|g| - delta + eps)^2 of the rate (up to twice the rate where |g| is
    within delta of 0)."""
    refp = {**convert.params_from_jax(ref.cnn_params), **convert.params_from_jax(ref.nerf_params)}
    eps = 1e-8
    for group, base in ((port.cnn, POSE.lr_cnn), (port.field, POSE.lr_mlp)):
        rate = opt.learning_rate(base, 0)
        for n, p in group.named_parameters():
            err = np.abs(p.detach().numpy() - refp[n].numpy())
            if n not in grads:          # frozen: bit for bit
                assert err.max() == 0.0, n
                continue
            near = np.maximum(np.abs(grads[n]) - grad_bars[n], 0.0) + eps
            bar = 1e-6 + rate * np.minimum(grad_bars[n] * eps / near**2, 2.0)
            assert (err <= bar).all(), (n, float(err.max()))


def test_train_pose_resumes_exactly(data):
    """4 steps against 2, then a resume to 4 from a copy of the state: the
    same losses, params and Adam moments, bit for bit (draws from (seed,
    step))."""
    _check_resume(data, FIELD)


def test_train_pose_resumes_exactly_nosiren(data):
    _check_resume(data, FIELD_NOSIREN)


def _check_resume(data, field_cfg):
    field = _port_field(field_cfg)
    cnn = TUNet(**UNET, dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(0))
    kw = dict(cfg=_port_cfg(POSE), aug_cfg=taug.AugmentConfig(*AUG), seed=SEED, cnn=cnn, device="cpu")
    args = (field, data["images"], data["sils"], _port_bank(data), data["neg"])
    full, full_losses = tpt.train_pose(*args, n_steps=4, **kw)
    saved = []
    _, head = tpt.train_pose(*args, n_steps=2, on_checkpoint=lambda st, i: saved.append(copy.deepcopy(st)), **kw)
    end, tail = tpt.train_pose(*args, n_steps=4, resume_state=saved[-1], **kw)
    assert head + tail == full_losses and end.step == full.step == 4 and end.opt.count == 4
    for a, b in zip(list(end.cnn.parameters()) + list(end.field.parameters()) + end.opt.cnn_nu + end.opt.head_mu,
                    list(full.cnn.parameters()) + list(full.field.parameters()) + full.opt.cnn_nu + full.opt.head_mu):
        assert torch.equal(a, b)
    assert not torch.equal(next(iter(full.cnn.parameters())), next(iter(cnn.parameters())))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_pose_optimizer_matches_optax(weight_decay):
    """The grouped optimizer against the reference's make_pose_optimizer on
    a small tree: the feature head at lr_mlp (AdamW with
    head_weight_decay), the CNN at lr_cnn, the trunk frozen; three updates
    inside the warmup and one past it."""
    cfg = PoseTrainConfig(warmup_steps=3, head_weight_decay=weight_decay)
    rng = np.random.default_rng(10)
    shapes = {"head": (4, 3), "trunk": (3, 2), "cnn": (2, 3, 1, 1)}
    vals = {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}
    grads = [{k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()} for _ in range(4)]

    def jtree(d):
        return ({"params": {"feature_layer": {"kernel": jnp.asarray(d["head"])},
                            "trunk1": {"kernel": jnp.asarray(d["trunk"])}}},
                {"params": {"Conv_0": {"kernel": jnp.asarray(d["cnn"])}}})

    tx = jpt.make_pose_optimizer(cfg)
    params = jtree(vals)
    state = tx.init(params)

    class Field(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.feature_layer = torch.nn.Module()
            self.feature_layer.weight = torch.nn.Parameter(_t(vals["head"]))
            self.trunk1 = torch.nn.Module()
            self.trunk1.weight = torch.nn.Parameter(_t(vals["trunk"]))

    field = Field()
    cnn = torch.nn.Module()
    cnn.weight = torch.nn.Parameter(_t(vals["cnn"]))
    opt = tpt.PoseOptimizer(_port_cfg(cfg))
    ostate = opt.init(field, cnn)
    for g in grads:
        upd, state = tx.update(jtree(g), state, params)
        params = jax.tree.map(lambda a, b: a + b, params, upd)
        field.feature_layer.weight.grad, field.trunk1.weight.grad = _t(g["head"]), _t(g["trunk"])
        cnn.weight.grad = _t(g["cnn"])
        ostate = opt.update(field, cnn, ostate)
        np.testing.assert_allclose(field.feature_layer.weight.detach().numpy(),
                                   np.asarray(params[0]["params"]["feature_layer"]["kernel"]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(cnn.weight.detach().numpy(), np.asarray(params[1]["params"]["Conv_0"]["kernel"]),
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(field.trunk1.weight.detach().numpy(), vals["trunk"])
    assert ostate.count == 4


def test_train_pose_distractor_bank(data):
    """A distractor bank whose picked rows are the batch's rolled views
    gives the step without a bank bit for bit; a bank with p_distractor 0
    is refused."""
    cfg = _port_cfg(POSE)
    aug_cfg = taug.AugmentConfig(*AUG)
    images, sils = _t(data["images"][:2]), _t(data["sils"][:2])
    bank = (torch.roll(images, 1, 0), torch.roll(sils, 1, 0))
    draws = tpt.draw_pose_step(torch.Generator().manual_seed(4), 2, S, 50, cfg, aug_cfg, n_distractors=2)
    assert draws.pick.shape == (2,)
    draws = draws._replace(pick=torch.tensor([0, 1]))
    field = _port_field()
    cnn = TUNet(**UNET, dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(0))
    args = (images, sils, _t(data["pos"][:2]), _t(data["xys"][:2]), _t(data["valid"][:2]), _t(data["neg"]), cfg,
            aug_cfg)
    losses = []
    for dis in (None, bank):
        state = tpt.init_pose_state(field, cfg, cnn, device="cpu")
        gen = torch.Generator().manual_seed(5)
        _, loss, _ = tpt.pose_train_step(state, tpt.make_pose_optimizer(cfg), *args, draws, gen,
                                         distractor_bank=dis)
        losses.append(float(loss))
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="p_distractor"):
        tpt.train_pose(field, data["images"], data["sils"], _port_bank(data), data["neg"], cfg=cfg,
                       aug_cfg=aug_cfg._replace(p_distractor=0.0), n_steps=1, distractor_bank=bank, device="cpu")


@pytest.mark.parametrize("n_bg", [0, 3])
def test_reseeded_generator_draws_what_a_fresh_step_generator_draws(data, n_bg):
    """``train_pose`` keeps one generator a run and reseeds it each step
    with ``step_seed(seed, step)``: after the draws of the steps before,
    it draws what a fresh ``step_generator(seed, step)`` draws, every
    draw of ``draw_pose_step`` (distractor picks, the augmentation with
    background noise or bank rows, positive-key noise, negatives and their
    jitter) and the sampled rays of ``select_ray_samples``."""
    cfg = dataclasses.replace(_port_cfg(POSE), pos_noise=0.01)
    aug_cfg = taug.AugmentConfig(*AUG)
    xys, valid = _t(data["xys"][:B]), _t(data["valid"][:B])
    kept = torch.Generator()
    for step in (0, 1, 2, 7):
        got = []
        for g in (step_generator(SEED, step, "cpu"), kept.manual_seed(step_seed(SEED, step))):
            d = tpt.draw_pose_step(g, B, S, 50, cfg, aug_cfg, n_bg=n_bg, n_distractors=4)
            got.append(list(d.aug) + [d.pick, d.pos_noise, d.neg_idx, d.neg_jitter,
                                      taug.select_ray_samples(xys, valid, cfg.sample_size, g)])
        assert all(torch.equal(a, b) for a, b in zip(*got)), step
    assert got[0][len(d.aug)] is not None and got[0][len(d.aug) + 1] is not None


def test_cpu_steps_leave_the_graph_counter_untouched(data):
    """A descriptor step on the CPU runs eagerly and is not counted among
    the step's CUDA calls (``POSE_GRAPH_COUNT``); nothing is remembered
    for a graph."""
    before = dict(tpt.POSE_GRAPH_COUNT)
    seen, graphs_ = dict(tpt._SEEN), dict(tpt._GRAPHS)
    cfg = _port_cfg(POSE)
    aug_cfg = taug.AugmentConfig(*AUG)
    cnn = TUNet(**UNET, dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(0))
    state = tpt.init_pose_state(_port_field(), cfg, cnn, device="cpu")
    gen = torch.Generator().manual_seed(5)
    draws = tpt.draw_pose_step(gen, B, S, 50, cfg, aug_cfg)
    args = (_t(data["images"][:B]), _t(data["sils"][:B]), _t(data["pos"][:B]), _t(data["xys"][:B]),
            _t(data["valid"][:B]), _t(data["neg"]), cfg, aug_cfg)
    for _ in range(3):
        state, loss, _ = tpt.pose_train_step(state, tpt.make_pose_optimizer(cfg), *args, draws, gen)
    assert state.step == 3 and bool(torch.isfinite(loss))
    assert tpt.POSE_GRAPH_COUNT == before and dict(tpt._SEEN) == seen and dict(tpt._GRAPHS) == graphs_


def test_nocs_map_matches_reference():
    """Valid rays write their hits into the pixels their xys land on; rays
    out of bounds or invalid write nothing; where rays share a pixel the
    last one writes, as the reference's scatter does on the CPU."""
    rng = np.random.default_rng(9)
    res, n = 24, 300
    xys = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    xys[-1] = xys[-2] = xys[0]                         # three rays on one pixel, the last two valid
    valid[-1] = valid[-2] = True
    got = taug.nocs_map(_t(xys), _t(pos), torch.from_numpy(valid), res=res)
    want = np.asarray(jaug.nocs_map(jnp.asarray(xys), jnp.asarray(pos), jnp.asarray(valid), res=res))
    np.testing.assert_array_equal(got.numpy(), want)
    px = int((1.0 - xys[0, 0]) * 0.5 * (res - 1)), int((1.0 - xys[0, 1]) * 0.5 * (res - 1))
    np.testing.assert_array_equal(got[px[1], px[0]].numpy(), pos[-1])
    assert got.shape == (res, res, 3) and 0 < int(got.abs().sum(-1).gt(0).sum()) < valid.sum()
