"""One half's NeRF training (``train_nerf``), the port against the JAX
reference at the small size of test_torch_train.py, its steps chunked at 16
rays (40 rays a step: chunks of 16, 16 and a ragged 8) so that the split
kernels K5/K6 run (interpreted in the reference, their plain versions in
the port); exact resume through ``checkpoint``; and ``extract_point_cloud``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import CHUNK, SEED, TRAIN, _cfg, _np_tree, fused_schedule_draws

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FieldConfig, RenderConfig, replace
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import nerf_trainer as jnt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer as tnt

torch.set_num_threads(1)

HALF_RENDER = RenderConfig(n_rays_per_image=20, n_pts_coarse=8, n_pts_fine=12)   # 40 rays: chunks 16 + 16 + 8
HALF_STEPS, HALF_SPC = 4, 2


@pytest.fixture(scope="module")
def half():
    """Half 0 of test_torch_train.py's scene: images, sils, R_bop, t_bop, K."""
    s = jsyn.make_scene(n_views=4, image_size=24, key=jax.random.PRNGKey(0))
    return tuple(np.array(getattr(s, f)) for f in ("images", "sils", "R_bop", "t_bop", "K"))


@pytest.fixture(scope="module")
def half_runs(half):
    """The reference's train_nerf on half 0 with its split kernels
    interpreted at a 16-ray chunk, and the port's from the same init,
    schedule and draws."""
    cfg = _cfg(True)
    jf = jfields.NerfField(cfg)
    with pytest.MonkeyPatch.context() as mp:
        # train_nerf builds its step with make_multi_step's default chunk
        mp.setattr(jnt.make_multi_step, "__defaults__", (CHUNK, None))
        mp.setattr(jnt, "_cached_or_fresh", lambda cache_fn, fresh_fn, *key: fresh_fn())
        jstate, jlosses = jnt.train_nerf(*half, jf, render_cfg=HALF_RENDER, train_cfg=TRAIN,
                                         n_steps=HALF_STEPS, seed=SEED, steps_per_call=HALF_SPC, mesh=None)
    init = jnt.init_state(jf, TRAIN, jax.random.PRNGKey(SEED))[0]
    init_params = tuple(convert.params_from_jax(_np_tree(p)) for p in (init.params_coarse, init.params_fine))
    draws = fused_schedule_draws(SEED, 1, HALF_STEPS, HALF_SPC, TRAIN.batch_size, HALF_RENDER, CHUNK)
    tstate, tlosses = tnt.train_nerf(*half, cfg, HALF_RENDER, TRAIN, n_steps=HALF_STEPS, seed=SEED,
                                     init_params=init_params, draws=lambda i: draws[i], ray_chunk=CHUNK,
                                     device="cpu")
    return dict(jstate=_np_tree(jstate), jlosses=np.asarray(jlosses), tstate=tstate, tlosses=tlosses, cfg=cfg)


def test_train_nerf_matches_reference(half_runs):
    r = half_runs
    assert len(r["tlosses"]) == len(r["jlosses"]) == HALF_STEPS
    # the same views, draws and kernel numerics; after the first step the
    # params differ by Adam's near-zero-grad sign flips
    np.testing.assert_allclose(r["tlosses"], r["jlosses"], rtol=2e-2)
    st, jst = r["tstate"], r["jstate"]
    assert st.step == int(jst.step) == HALF_STEPS and st.opt.count == HALF_STEPS
    # each update moves a parameter by about the rate or less (Adam), so two
    # runs whose grads differ in sign near zero part by at most 2 x the rates
    opt = tnt.make_optimizer(TRAIN)
    bound = 2.01 * sum(opt.learning_rate(k) for k in range(HALF_STEPS))
    for f, jp in ((st.coarse, jst.params_coarse), (st.fine, jst.params_fine)):
        ref = convert.params_from_jax(jp)
        for n, p in f.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=bound, rtol=0, err_msg=n)
    # the reference's single-half state crosses over whole
    back = convert.train_state_from_jax(jst, r["cfg"], device="cpu")
    assert back.step == HALF_STEPS and back.opt.count == HALF_STEPS
    assert [m.shape for m in back.opt.mu] == [p.shape for p in tnt.train_params(back)]


def test_train_nerf_resume_is_exact(half, tmp_path):
    """5 steps against 3, save_state, load_state and resume to 5: params,
    Adam moments and the losses of steps 4-5 are bit-identical; the hook
    fires every ckpt_every steps and at the end."""
    cfg = _cfg(True)
    kw = dict(render_cfg=HALF_RENDER, train_cfg=replace(TRAIN, ckpt_every=2), seed=SEED, ray_chunk=CHUNK,
              device="cpu")
    hooked = []
    full, losses = tnt.train_nerf(*half, cfg, n_steps=5, on_checkpoint=lambda st, i: hooked.append(i), **kw)
    assert hooked == [2, 4, 5] and len(losses) == 5
    _, first = tnt.train_nerf(*half, cfg, n_steps=3,
                              on_checkpoint=lambda st, i: checkpoint.save_latest(str(tmp_path), st), **kw)
    resumed = checkpoint.load_state(str(tmp_path / checkpoint.STATE), cfg, device="cpu")
    assert resumed.step == resumed.opt.count == 3
    end, rest = tnt.train_nerf(*half, cfg, n_steps=5, resume_state=resumed, **kw)
    assert first + rest == losses
    assert end.step == 5 and end.opt.count == full.opt.count == 5
    for a, b in zip(tnt.train_params(end) + end.opt.mu + end.opt.nu, tnt.train_params(full) + full.opt.mu + full.opt.nu):
        assert torch.equal(a, b)


def test_checkpoint_round_trips_and_overwrites_latest(tmp_path):
    _check_checkpoint(tmp_path, _cfg(True))


def test_checkpoint_round_trips_nosiren(tmp_path):
    """A field with the softplus MLP head (siren=False): its frozen feat1 /
    feat2 travel in the fields' state dicts, with no moments."""
    cfg = _cfg(True, siren=False)
    st = _check_checkpoint(tmp_path, cfg)
    assert {n for n, _ in st.fine.named_parameters()} - {n for n, _ in tnt.trainable(st.fine)} == {
        "feat1.weight", "feat1.bias", "feat2.weight", "feat2.bias"}


def _check_checkpoint(tmp_path, cfg):
    st = tnt.init_state(cfg, TRAIN, torch.Generator().manual_seed(0), device="cpu")
    for i, (m, v) in enumerate(zip(st.opt.mu, st.opt.nu)):
        m.fill_(0.5 + i)
        v.fill_(0.25 * i)
    st = st._replace(opt=st.opt._replace(count=7), step=7)
    d = str(tmp_path)
    checkpoint.save_latest(d, st)
    with torch.no_grad():
        st.fine.trunk1.bias.add_(1.0)
    checkpoint.save_latest(d, st._replace(step=9))
    assert sorted(os.listdir(d)) == sorted([checkpoint.LATEST, checkpoint.LATEST_FINE, checkpoint.STATE])
    assert all(checkpoint.exists(os.path.join(d, name)) for name in os.listdir(d))
    assert not checkpoint.exists(os.path.join(d, "missing"))
    tree, step = checkpoint.load(os.path.join(d, checkpoint.LATEST_FINE), device="cpu")
    assert step == 9 and all(torch.equal(tree[k], v) for k, v in st.fine.state_dict().items())
    back = checkpoint.load_state(os.path.join(d, checkpoint.STATE), cfg, device="cpu")
    assert back.step == 9 and back.opt.count == 7
    for a, b in zip(tnt.train_params(back) + back.opt.mu + back.opt.nu, tnt.train_params(st) + st.opt.mu + st.opt.nu):
        assert torch.equal(a, b)
    # moments that do not fit the field's trained parameters are refused
    obj = torch.load(os.path.join(d, checkpoint.STATE), weights_only=True)
    obj["mu"].append(torch.zeros(1))
    torch.save(obj, os.path.join(d, "bad"))
    with pytest.raises(ValueError, match="Adam mu"):
        checkpoint.load_state(os.path.join(d, "bad"), cfg, device="cpu")
    for f, g in ((back.coarse, st.coarse), (back.fine, st.fine)):
        assert all(torch.equal(a, b) for a, b in zip(f.state_dict().values(), g.state_dict().values()))
    return back


def test_extract_point_cloud_matches_reference():
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16")
    planted = convert.planted_field_params(cfg, seed=0)
    jv, jt = jnt.extract_point_cloud(jfields.NerfField(cfg), jax.tree.map(jnp.asarray, planted), grid_res=40)
    tf = tfields.NerfField(cfg)
    tf.load_state_dict(convert.params_from_jax(planted))
    tv, tt = tnt.extract_point_cloud(tf, grid_res=40)
    assert tv.shape[1] == 3 and tt.shape[1] == 3 and tv.shape[0] > 100
    # jnp.linspace and torch.linspace put most grid coordinates an ulp apart,
    # and the reference's jitted grid elides some bf16 roundings of its eager
    # field (ROADMAP C): a shell voxel's density moves by up to ~1e-3, which
    # can move a vertex along its edge or, rarely, flip a crossing
    assert abs(tv.shape[0] - jv.shape[0]) <= 0.01 * jv.shape[0]
    d = np.sqrt(((tv[:, None, :] - jv[None, :, :]) ** 2).sum(-1))
    chamfer = d.min(1).mean() + d.min(0).mean()
    assert chamfer < 0.01 * (2.0 / 39), chamfer
