"""NeRF training, the port against the JAX reference at a small size (8
harmonics, 48 hidden, 2 halves x 2 cams x 24 rays, 8 coarse + 12 fine
points): the plain K4 against the reference's Pallas loss kernel in
interpret mode, its hand backward against autograd, the optimizer against
optax, and whole train steps (single-chunk through K4, chunked through
K5/K6 or autograd at a 16-ray chunk).  Every random draw is the
reference's, made along its key path with ``jax.random`` here and handed
to the port:

    fold_in(PRNGKey(seed + h), done) -> split per step -> (k_rays, k_pdf)
    k_rays -> (k_xy, k_z): ray xys, depth jitter
    split(k_pdf, n_chunks)[i]: chunk i's resampling uniforms
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FieldConfig, NerfTrainConfig, RenderConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import field_kernel as jfk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import nerf_trainer as jnt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as tcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as tfk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer as tnt

torch.set_num_threads(1)

RENDER = RenderConfig(n_rays_per_image=24, n_pts_coarse=8, n_pts_fine=12)
TRAIN = NerfTrainConfig(batch_size=2, warmup_steps=4)
SEED = 1


def _cfg(fused_kernel=True, embed="direct"):
    return FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", embed_method=embed,
                       fused_kernel=fused_kernel)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def step_draws(key, n_cams, render=RENDER, ray_chunk=tnt.RAY_CHUNK):
    """The reference train step's draws from its per-step key: the rays
    are cut into chunks of min(ray_chunk, rays), and chunk i resamples with
    uniforms from split(k_pdf, n_chunks)[i] (the padded rows of a ragged
    last chunk are drawn and unused)."""
    n, Pc, Pf = render.n_rays_per_image, render.n_pts_coarse, render.n_pts_fine
    k_rays, k_pdf = jax.random.split(key)
    k_xy, k_z = jax.random.split(k_rays)
    xys = jax.random.uniform(k_xy, (n_cams, n, 2), minval=-1.0, maxval=1.0)
    u = jax.random.uniform(k_z, (n_cams, n, Pc))
    chunk = min(ray_chunk, n_cams * n)
    keys = jax.random.split(k_pdf, -(-n_cams * n // chunk))
    u_pdf = jnp.concatenate([jax.random.uniform(k, (chunk, Pf), maxval=1.0 - 1e-6) for k in keys])[:n_cams * n]
    return xys, u, u_pdf


def stacked_draws(keys, n_cams, render=RENDER, ray_chunk=tnt.RAY_CHUNK):
    per_half = [step_draws(k, n_cams, render, ray_chunk) for k in keys]
    return tuple(_t(np.stack([np.asarray(d[i]) for d in per_half])) for i in range(3))


def fused_schedule_draws(seed, n_halves, total, spc, n_cams, render=RENDER, ray_chunk=tnt.RAY_CHUNK):
    """Per-step draws of the reference's train_nerf_fused (and, for one
    half, of its train_nerf): each call of ``spc`` steps folds ``done``
    into PRNGKey(seed + h), then splits per step."""
    steps = [[] for _ in range(total)]
    for h in range(n_halves):
        for done in range(0, total, spc):
            k = jax.random.fold_in(jax.random.PRNGKey(seed + h), done)
            for i in range(done, min(done + spc, total)):
                k, sub = jax.random.split(k)
                steps[i].append(sub)
    return [stacked_draws(ks, n_cams, render, ray_chunk) for ks in steps]


@pytest.fixture(scope="module")
def scene():
    halves = [jsyn.make_scene(n_views=4, image_size=24, key=jax.random.PRNGKey(uh)) for uh in (0, 1)]
    st = {f: np.stack([np.asarray(getattr(s, f)) for s in halves]) for f in ("images", "sils", "R_bop", "t_bop", "K")}
    st["min_d"], st["max_d"] = jnt.depth_bounds(st["t_bop"].reshape(-1, 3), 2.0)
    return st


# ---------------------------------------------------------------- K4 plain


def _bundle_case(embed, R, P, seed):
    cfg = _cfg(True, embed)
    jf = jfields.NerfField(cfg)
    params = _np_tree(jfields.init_field(jf, jax.random.PRNGKey(seed)))
    params["params"]["density_layer"]["bias"][:] = 0.0   # densities across (0, 1), not in softplus's tail
    tf = tfields.NerfField(cfg)
    tf.load_state_dict(convert.params_from_jax(params))
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(R, P, 3)) * 0.6).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    col = rng.uniform(size=(R, 3)).astype(np.float32)
    sil = (rng.uniform(size=(R, 1)) > 0.5).astype(np.float32)
    valid = np.ones((R, 1), np.float32)
    valid[::4] = 0.0
    return cfg, params, tf, pts, dirs, col, sil, valid


@pytest.mark.parametrize("embed,R,P", [("direct", 6, 9), ("direct", 5, 512), ("grouped", 7, 12)])
def test_bundle_loss_plain_matches_pallas_kernel(embed, R, P):
    """Ragged R (5 rays against the reference's 2-ray tiles at P = 512),
    valid = 0 rows and the coarse pass's weights."""
    cfg, params, tf, pts, dirs, col, sil, valid = _bundle_case(embed, R, P, seed=R + P)
    hs, scale = 0.1, 500.0 / R
    gk, (ce_k, se_k), w_k = jfk.bundle_loss_grads(
        params, *map(jnp.asarray, (pts, dirs, col, sil, valid)), cfg, huber_scaling=hs, scale=scale,
        want_weights=True, interpret=True)
    ce, se, w = tfk.bundle_loss_grads([tf], *(_t(x)[None] for x in (pts, dirs, col, sil, valid)), cfg, hs, scale,
                                      want_weights=True)
    # the reference's own bars against flax are 2e-2 (tests/test_field_kernel.py);
    # against its kernel the port rounds at the same points, so only f32
    # sums in another order (the composite's prefix sum, the matmuls) remain
    np.testing.assert_allclose(float(ce[0]), float(ce_k), rtol=1e-5)
    np.testing.assert_allclose(float(se[0]), float(se_k), rtol=1e-5)
    assert w.shape == (1, R, P)
    np.testing.assert_allclose(w[0].numpy(), np.asarray(w_k), atol=1e-6)
    ref = convert.params_from_jax(_np_tree(gk))
    du_bar = _du_rounding_bar(cfg, tf, pts, dirs, col, sil, valid, hs, scale)
    checked = 0
    for name, p in tf.named_parameters():
        if name.startswith("feature_layer"):
            assert p.grad is None and float(np.abs(ref[name].numpy()).max()) == 0.0
            continue
        s = max(float(np.abs(ref[name].numpy()).max()), 1e-3)
        err = np.abs(p.grad.numpy() - ref[name].numpy())
        bar = 1e-4 * s + 4.0 * du_bar.get(name, 0.0)
        assert (err <= bar).all(), (name, float((err / bar).max()))
        checked += 1
    assert checked == 10


def _du_rounding_bar(cfg, tf, pts, dirs, col, sil, valid, hs, scale):
    """How far the f32 rounding of the composite's reverse prefix sum may
    move the two grads that contract the unrounded f32 du over a ray's
    points (density_layer weight and bias).  Both versions take
    sum_{j>p} T_j as the ray's total minus an inclusive prefix (the
    reference by a triangular product, the port by cumsum): past the ray's
    opaque front the exact tail is ~0 and the difference keeps an absolute
    error of a few f32 ulps of sum |T| (the port's own, against f64: up to
    2.6), scaled by sigmoid'.  Returned: one such ulp a point, contracted
    with |h2b| (weight) or summed (bias); the test allows 4.  At P = 512
    the wd error follows the port's own rounding pattern (correlation
    0.999) and reaches 1.5e-4 of its max, 0.38 of the bar; every other
    block rounds its cotangents to bf16 first and keeps the flat 1e-4."""
    R, P = pts.shape[:2]
    fm = torch.from_numpy(tfk.fmat_of(cfg))
    weights = tuple(b[None] for b in tfk.loss_weights(tf))
    dn = _t(dirs)[None]
    dn = dn / dn.norm(dim=-1, keepdim=True)
    tgt = torch.cat([_t(col), _t(sil), _t(valid), torch.zeros(R, 3)], -1)[None]
    b = tfk._bundle_forward(_t(pts)[None], dn, tgt, fm, weights, tfk.ladder_of(cfg), cfg.softplus_beta, hs)
    gf = (scale / 3.0) * b.v * b.dcol / (hs * b.rc)
    gw = (gf[:, :, None, :] * b.field.rgb.reshape(1, R, P, 3)).sum(-1)
    ulp = 2.0 ** -24 * (gw * b.w).abs().sum(-1, keepdim=True).expand(1, R, P).reshape(R * P).double()
    delta = ulp * tfk._sig_from_act(b.field.raw[0, :, 0], cfg.softplus_beta).double()
    return {"density_layer.weight": (b.field.h2b[0].double().abs().T @ delta)[None].numpy(),
            "density_layer.bias": float(delta.sum())}


def test_bundle_loss_hand_backward_matches_autograd(monkeypatch):
    """The plain K4's hand backward against torch.autograd of its own
    forward.  Rounding to bf16 is straight-through for autograd, so the
    forward values are the kernel's; the hand backward also rounds its
    cotangents and reads sigmoid' from the rounded activations, which moves
    each grad block by a few bf16 ulps of its largest entry."""
    cfg, _, tf, pts, dirs, col, sil, valid = _bundle_case("grouped", 6, 10, seed=11)
    ladder = tfk.ladder_of(cfg)
    fm = torch.from_numpy(tfk.fmat_of(cfg))
    weights = tuple(b[None].clone() for b in tfk.loss_weights(tf))
    dn = _t(dirs)[None]
    dn = dn / dn.norm(dim=-1, keepdim=True)
    tgt = torch.cat([_t(col), _t(sil), _t(valid), torch.zeros(6, 3)], -1)[None]
    hs, scale = 0.1, 500.0 / 6
    hand, loss, _ = tfk.bundle_loss_plain(_t(pts)[None], dn, tgt, fm, weights, ladder, 10.0, hs, scale, False)
    monkeypatch.setattr(tfk, "_bf16", lambda x: x + (x.to(torch.bfloat16).float() - x).detach())
    ws = [w.clone().requires_grad_(True) for w in weights]
    f = tfk._bundle_forward(_t(pts)[None], dn, tgt, fm, ws, ladder, 10.0, hs)
    torch.testing.assert_close(f.loss, loss, rtol=1e-6, atol=0)
    (scale * f.loss.sum()).backward()
    for name, a, w in zip(tfk.LOSS_BLOCKS, hand, ws):
        s = max(float(w.grad.abs().max()), 1e-3)
        np.testing.assert_allclose(a.numpy() / s, w.grad.numpy() / s, atol=3e-2, err_msg=name)


def test_bundle_loss_dispatch_on_cpu():
    cfg, _, tf, pts, dirs, col, sil, valid = _bundle_case("direct", 3, 5, seed=2)
    before = tfk.bundle_loss_cuda.launches
    tfk.bundle_loss_grads([tf], *(_t(x)[None] for x in (pts, dirs, col, sil, valid)), cfg, 0.1, 1.0)
    assert tfk.bundle_loss_cuda.launches == before      # CPU tensors take the plain version
    w = tuple(b[None] for b in tfk.loss_weights(tf))
    with pytest.raises(ValueError):
        tfk.bundle_loss_op(torch.zeros((1, 3, 5, 3), device="meta"), None, None, None, w, 0, 10.0, 0.1, 1.0, False)


def test_freeze_spec_partition():
    f = tfields.NerfField(_cfg())
    labels = tfields.freeze_spec(train_feature_head=False)(f)
    assert {n for n, lab in labels.items() if lab == "freeze"} == {n for n, _ in f.named_parameters()
                                                                   if n.startswith("feature_layer.")}
    flipped = tfields.freeze_spec(train_feature_head=True)(f)
    assert all((labels[n] == "train") != (flipped[n] == "train") for n in labels)
    f.extra = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="unknown NerfField module 'extra'"):
        tfields.freeze_spec(False)(f)


# ---------------------------------------------------------------- optimizer


def test_optimizer_matches_optax_over_warmup():
    cfg = _cfg()
    jf = jfields.NerfField(cfg)
    train = NerfTrainConfig(warmup_steps=4, lr=1e-3)
    jstate, tx = jnt.init_state(jf, train, jax.random.PRNGKey(3))
    pair = (jstate.params_coarse, jstate.params_fine)
    opt_state = jstate.opt_state
    tstate = convert.train_state_from_jax(_np_tree(jstate), cfg, device="cpu")
    opt = tnt.make_optimizer(train)
    rng = np.random.default_rng(4)
    count = 0
    feat_before = [p.detach().clone() for f in (tstate.coarse, tstate.fine) for n, p in f.named_parameters()
                   if n.startswith("feature_layer")]
    params = tnt.train_params(tstate)
    for step in range(7):                       # across the warmup's end (count 4)
        grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 10 ** step), pair)
        updates, opt_state = tx.update(grads, opt_state, pair)
        pair = jax.tree.map(lambda p, u: p + u, pair, updates)
        for f, g in zip((tstate.coarse, tstate.fine), grads):
            sd = convert.params_from_jax(_np_tree(g))
            for n, p in f.named_parameters():
                p.grad = sd[n]                 # the feature head's too: it must stay frozen
        count = opt.update(params, [p.grad for p in params], tstate.opt.mu, tstate.opt.nu, count)
        for f, p_ref in zip((tstate.coarse, tstate.fine), pair):
            ref = convert.params_from_jax(_np_tree(p_ref))
            for n, p in f.named_parameters():
                # identical grads: only f32 rounding of the update formula differs
                np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=1e-6, rtol=0,
                                           err_msg=f"step {step} {n}")
    assert count == 7
    feat_after = [p for f in (tstate.coarse, tstate.fine) for n, p in f.named_parameters()
                  if n.startswith("feature_layer")]
    assert all(torch.equal(a, b) for a, b in zip(feat_before, feat_after))
    # the rate at count k is optax's schedule at k (read before the increment)
    sched = jnp.asarray([float(optax_lr) for optax_lr in map(_optax_rate(train), range(7))])
    np.testing.assert_allclose([opt.learning_rate(k) for k in range(7)], np.asarray(sched), rtol=1e-7)


def _optax_rate(train):
    import optax

    return optax.linear_schedule(train.lr * 0.02, train.lr, train.warmup_steps)


# ---------------------------------------------------------------- train steps


def _one_step(scene, fused_kernel, render=RENDER, ray_chunk=tnt.RAY_CHUNK):
    """One step of both halves in each package from the same reference
    init, batch and draws."""
    cfg = _cfg(fused_kernel)
    jf = jfields.NerfField(cfg)
    tx = jnt.make_optimizer(TRAIN)
    step = jnt.make_train_step(jf, tx, render, TRAIN, scene["min_d"], scene["max_d"], ray_chunk)
    states = [jnt.init_state(jf, TRAIN, jax.random.PRNGKey(SEED + h))[0] for h in range(2)]
    idx = np.array([[0, 2], [3, 1]])
    hh = np.arange(2)[:, None]
    R, t, K = (scene[k][hh, idx] for k in ("R_bop", "t_bop", "K"))
    images, sils = scene["images"][hh, idx], scene["sils"][hh, idx]
    keys = [jax.random.PRNGKey(100 + h) for h in range(2)]
    jcam_b = jcam.camera_from_bop(jnp.asarray(R), jnp.asarray(t), jnp.asarray(K), 24)
    vstep = jax.vmap(step, in_axes=(0, jcam.Camera(0, 0, 0, 0, None), 0, 0, 0))
    jnew, jloss, jaux = vstep(jax.tree.map(lambda *x: jnp.stack(x), *states), jcam_b, jnp.asarray(images),
                              jnp.asarray(sils), jnp.stack(keys))
    tstates = [convert.train_state_from_jax(_np_tree(s), cfg, device="cpu") for s in states]
    tnew, tloss, taux = tnt.train_step(tstates, tcam.camera_from_bop(_t(R), _t(t), _t(K), 24), _t(images), _t(sils),
                                       tnt.make_optimizer(TRAIN), render, TRAIN, scene["min_d"], scene["max_d"],
                                       draws=stacked_draws(keys, 2, render, ray_chunk), ray_chunk=ray_chunk)
    return jnew, jloss, jaux, tnew, tloss, taux


def _compare_step(jnew, jloss, tnew, tloss, loss_rtol, grad_atol):
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=loss_rtol)
    lr0 = tnt.make_optimizer(TRAIN).learning_rate(0)
    for h, st in enumerate(tnew):
        jst = jax.tree.map(lambda x: np.asarray(x[h]), jnew)
        assert st.step == int(jst.step) == 1 and st.opt.count == 1
        adam = jst.opt_state.inner_states["train"].inner_state[0]
        for i, (f, jp) in enumerate(((st.coarse, jst.params_coarse), (st.fine, jst.params_fine))):
            ref_p = convert.params_from_jax(jp)
            # first moment after one update = 0.1 * grad: the reference's grads
            ref_g = {n: v / np.float32(0.1) for n, v in convert._field_state(
                {**adam.mu[i]["params"], "feature_layer": jp["params"]["feature_layer"]}).items()}
            for n, p in f.named_parameters():
                if n.startswith("feature_layer"):
                    assert p.grad is None
                    np.testing.assert_array_equal(p.detach().numpy(), ref_p[n].numpy())
                    continue
                s = max(float(np.abs(ref_g[n].numpy()).max()), 1e-3)
                np.testing.assert_allclose(p.grad.numpy() / s, ref_g[n].numpy() / s, atol=grad_atol,
                                           err_msg=f"half {h} {i} {n}")
                # Adam's first update is about lr(0) * sign(grad): a grad near 0
                # that the two round differently may move by up to 2 lr(0)
                np.testing.assert_allclose(p.detach().numpy(), ref_p[n].numpy(), atol=2.01 * lr0, rtol=0)


def test_train_step_matches_reference_kernel_step(scene):
    jnew, jloss, jaux, tnew, tloss, taux = _one_step(scene, fused_kernel=True)
    # the same kernel numerics on rays and depths that differ by f32 ulps
    _compare_step(jnew, jloss, tnew, tloss, loss_rtol=1e-4, grad_atol=1e-2)
    np.testing.assert_allclose(taux["color"].numpy(), np.asarray(jaux["color"]), rtol=1e-4)
    np.testing.assert_allclose(taux["sil"].numpy(), np.asarray(jaux["sil"]), rtol=1e-4)


def test_autograd_step_matches_reference_flax_step(scene):
    # both take the field's own differentiable path: flax's autodiff and
    # torch's autograd round the cotangents of the bf16 casts alike
    jnew, jloss, _, tnew, tloss, _ = _one_step(scene, fused_kernel=None)
    _compare_step(jnew, jloss, tnew, tloss, loss_rtol=1e-4, grad_atol=3e-2)


CHUNK = 16


@pytest.mark.parametrize("n_rays", [24, 20])
def test_chunked_kernel_step_matches_reference(scene, n_rays, monkeypatch):
    """2 cams x 24 rays = 3 chunks of 16; x 20 = 2 chunks and a ragged 8,
    which the reference pads with rows of weight 0.  The reference runs its
    split kernels K5/K6 interpreted, the port their plain versions, one
    forward per pass and chunk (no K4)."""
    render = RenderConfig(n_rays_per_image=n_rays, n_pts_coarse=8, n_pts_fine=12)
    calls = []
    fwd = tfk.field_color_fwd_op

    def counted(pts, *args):
        calls.append(pts.shape[:3])
        return fwd(pts, *args)

    monkeypatch.setattr(tfk, "field_color_fwd_op", counted)
    monkeypatch.setattr(tfk, "bundle_loss_op", None)     # a K4 call would raise
    jnew, jloss, jaux, tnew, tloss, taux = _one_step(scene, True, render, ray_chunk=CHUNK)
    n = 2 * n_rays
    sizes = [min(CHUNK, n - i) for i in range(0, n, CHUNK)]
    assert calls == [(2, c, P) for c in sizes for P in (8, 20)]
    # the same kernel numerics; the composite and its backward are autograd's
    # against JAX's, so the cotangents reaching K6 differ by f32 rounding
    _compare_step(jnew, jloss, tnew, tloss, loss_rtol=1e-4, grad_atol=1e-2)
    np.testing.assert_allclose(taux["color"].numpy(), np.asarray(jaux["color"]), rtol=1e-4)
    np.testing.assert_allclose(taux["sil"].numpy(), np.asarray(jaux["sil"]), rtol=1e-4)


def test_chunked_autograd_step_matches_reference_flax_step(scene):
    # 3 chunks of 16 through the fields' own colour paths: flax's remat scan
    # against the port's backward per chunk
    render = RenderConfig(n_rays_per_image=24, n_pts_coarse=8, n_pts_fine=12)
    jnew, jloss, _, tnew, tloss, _ = _one_step(scene, None, render, ray_chunk=CHUNK)
    _compare_step(jnew, jloss, tnew, tloss, loss_rtol=1e-4, grad_atol=3e-2)


# ------------------------------------------------------------ fused training


N_STEPS, SPC = 4, 2


@pytest.fixture(scope="module")
def fused_runs(scene):
    cfg = _cfg(True)
    jf = jfields.NerfField(cfg)
    captured = []
    orig = jnt._cached_or_fresh

    def spy(*args):
        fn = orig(*args)

        def wrapped(state, cam_all, images, sils, chunk_idx, subs):
            captured.append(np.asarray(chunk_idx))
            return fn(state, cam_all, images, sils, chunk_idx, subs)

        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnt, "_cached_or_fresh", spy)
        jstates, jlosses = jnt.train_nerf_fused(
            scene["images"], scene["sils"], scene["R_bop"], scene["t_bop"], scene["K"], jf, render_cfg=RENDER,
            train_cfg=TRAIN, n_steps=N_STEPS, seed=SEED, steps_per_call=SPC, mesh=None)
    # the port from the reference's init (train_state_from_jax of fresh states)
    inits = [convert.train_state_from_jax(_np_tree(jnt.init_state(jf, TRAIN, jax.random.PRNGKey(SEED + h))[0]), cfg,
                                             device="cpu")
             for h in range(2)]
    draws = fused_schedule_draws(SEED, 2, N_STEPS, SPC, TRAIN.batch_size)
    tstates, tlosses = tnt.train_nerf_fused(
        scene["images"], scene["sils"], scene["R_bop"], scene["t_bop"], scene["K"], cfg, RENDER, TRAIN,
        n_steps=N_STEPS, seed=SEED, init_states=inits, draws=lambda i: draws[i], device="cpu")
    return dict(jstates=jstates, jlosses=np.asarray(jlosses), captured=np.concatenate(captured, 1),
                tstates=tstates, tlosses=tlosses, cfg=cfg)


def test_fused_training_matches_reference(fused_runs):
    r = fused_runs
    assert r["tlosses"].shape == r["jlosses"].shape == (2, N_STEPS)
    # the reference's view schedule, as its own program received it
    n_views = 4
    for h in range(2):
        np.testing.assert_array_equal(tnt.half_schedule(n_views, TRAIN.batch_size, N_STEPS, SEED + h),
                                      r["captured"][h])
    # per-step losses: the same views, draws and kernel numerics; after the
    # first step the params differ by Adam's near-zero-grad sign flips
    np.testing.assert_allclose(r["tlosses"], r["jlosses"], rtol=2e-2)
    for h in range(2):
        assert r["tstates"][h].step == int(np.asarray(r["jstates"][h].step)) == N_STEPS


def test_train_state_from_jax_round_trip(fused_runs):
    """Every number of a trained reference state lands in the port's state:
    mapped back to the flax layout it is bit-identical."""
    r = fused_runs
    jst = _np_tree(r["jstates"][1])
    st = convert.train_state_from_jax(jst, r["cfg"], device="cpu")
    adam, sched = jst.opt_state.inner_states["train"].inner_state
    assert st.step == int(jst.step) == N_STEPS and st.opt.count == int(adam.count) == int(sched.count) == N_STEPS
    names = [n for n, _ in tnt.trainable(st.coarse)]
    for i, (f, jp) in enumerate(((st.coarse, jst.params_coarse), (st.fine, jst.params_fine))):
        for n, p in f.state_dict().items():
            np.testing.assert_array_equal(p.numpy(), convert.params_from_jax(jp)[n].numpy())
        k = len(names)
        for moments, ours in ((adam.mu[i], st.opt.mu[i * k:(i + 1) * k]), (adam.nu[i], st.opt.nu[i * k:(i + 1) * k])):
            for n, t in zip(names, ours):
                mod, leaf = n.split(".")
                ref = moments["params"][mod]["kernel" if leaf == "weight" else "bias"]
                back = t.numpy().T if leaf == "weight" else t.numpy()
                np.testing.assert_array_equal(back, ref)
    # and the port continues from it exactly as from its own state
    assert [p.shape for p in tnt.train_params(st)] == [m.shape for m in st.opt.mu]
