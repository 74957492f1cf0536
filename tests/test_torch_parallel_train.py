"""The stages that train or precompute on a device mesh, on the CPU:
``generate_cors`` (views dealt over the entries), NeRF training (the rays
of a step split over the entries, single-chunk through K4's plain version
and chunked at 16 rays through K5 / K6's) and descriptor training (the
views of a step split).

The reference runs on ``mesh_lib.make_mesh(n)`` over the virtual CPU
devices of ``conftest.py``, the port on ``Mesh(("cpu",) * n)``, from the
same init, schedule and draws as the unsharded parity tests this file
borrows from.  The bars: the port's sharded run against its unsharded
run at the reference's own sharded-against-single bars
(``test_parallel_pipeline.py``: NeRF losses rtol 1e-4, params rtol 1e-3 /
atol 2e-5; descriptor losses rtol 5e-3, params within twice the summed
rates), and against the reference's sharded run at the unsharded parity
test's bar for the standing divergence (losses rtol 2e-2 after Adam's
near-zero sign flips).  A 1-entry mesh is bit-identical to no mesh; two
sharded runs are bit-identical; the artifacts of ``generate_cors`` are
bit-identical whatever the mesh.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from test_torch_cors import _near_threshold, _pixels, _port, cors_pair  # noqa: F401
from test_torch_pose_train import (POSE, SEED as POSE_SEED, UNET, _port_bank, _port_cfg, _port_field,
                                   _port_state, _reference_run, data, reference_draws)  # noqa: F401
from test_torch_pose_train import AUG, FIELD as POSE_FIELD
from test_torch_train import CHUNK, RENDER, SEED, TRAIN, _cfg, _np_tree, fused_schedule_draws, scene  # noqa: F401
from test_torch_train_nerf import HALF_RENDER, HALF_SPC, HALF_STEPS, half  # noqa: F401

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.parallel import mesh as jmesh
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import artifacts as jart
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import generate_cors as jgc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import nerf_trainer as jnt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import pose_trainer as jpt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet as TUNet
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as tmesh
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import generate_cors as tgc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as taug
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer as tnt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer as tpt

torch.set_num_threads(1)


def cpu_mesh(n):
    return tmesh.Mesh(["cpu"] * n)


def _params(states):
    return [p.detach().clone() for st in states for p in tnt.train_params(st)]


def _assert_params_close(a, b, rtol=1e-3, atol=2e-5):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol, atol=atol)


# ----------------------------------------------------------- generate_cors


@pytest.mark.parametrize("cors_pair", ["f32"], indirect=True)
def test_generate_cors_on_a_mesh(cors_pair):  # noqa: F811
    """4 views dealt over 1-3 entries: every artifact bit-identical to the
    unsharded run's.  Against the reference's run on a 2-device mesh, the
    unsharded parity test's rule: a ray kept by one side only, or whose
    hits moved, has a cause at its threshold."""
    c = cors_pair
    S = c["S"]
    names = ["a1.npy", "subvert1.npy", "subnormal1.npy"]
    for n in (1, 2, 3):
        out = tgc.generate_cors(c["field"], *c["args"], str(c["root"] / f"port_mesh{n}"), 1, _port(c["cc"]),
                                grid_res=c["G"], mesh=cpu_mesh(n))
        for name in names:
            np.testing.assert_array_equal(jart.load_array(out, name), jart.load_array(c["tdir"], name))
        for v in range(c["V"]):
            for a, b in zip(jart.load_view_rays(out, S, v), jart.load_view_rays(c["tdir"], S, v)):
                np.testing.assert_array_equal(a, b)
    jdir = jgc.generate_cors(jfields.NerfField(c["cfg"]), jax.tree.map(np.asarray, c["params"]),
                             *c["args"], str(c["root"] / "jax_mesh2"), 1, c["cc"], grid_res=c["G"],
                             mesh=jmesh.make_mesh(2))
    kept = 0
    for v in range(c["V"]):
        xj, pj, bxj, bj = jart.load_view_rays(jdir, S, v)
        xt, pt, bxt, bt = jart.load_view_rays(c["tdir"], S, v)
        for (xa, ha), (xb, hb) in (((xj, pj), (xt, pt)), ((bxj, bj), (bxt, bt))):
            a, b = dict(zip(_pixels(xa, S), ha)), dict(zip(_pixels(xb, S), hb))
            moved = [p for p in set(a) & set(b) if np.abs(a[p] - b[p]).max() > 1e-5]
            flips = sorted((set(a) ^ set(b)) | set(moved))
            if flips:
                assert _near_threshold(c, v, np.asarray(flips)).all(), (v, flips)
            kept += len(set(a) & set(b))
    assert kept > 100


# ------------------------------------------------------------ NeRF training


N_STEPS, SPC = 4, 2


@pytest.fixture(scope="module")
def fused_setup(scene):  # noqa: F811
    cfg = _cfg(True)
    jf = jfields.NerfField(cfg)
    inits = [_np_tree(jnt.init_state(jf, TRAIN, jax.random.PRNGKey(SEED + h))[0]) for h in range(2)]
    draws = fused_schedule_draws(SEED, 2, N_STEPS, SPC, TRAIN.batch_size)
    args = tuple(scene[k] for k in ("images", "sils", "R_bop", "t_bop", "K"))

    def port(mesh):
        states = [convert.train_state_from_jax(s, cfg, device="cpu") for s in inits]
        return tnt.train_nerf_fused(*args, cfg, RENDER, TRAIN, n_steps=N_STEPS, seed=SEED, init_states=states,
                                    draws=lambda i: draws[i], device=None if mesh else "cpu", mesh=mesh)

    return dict(cfg=cfg, jf=jf, args=args, port=port, single=port(None))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_fused_training_on_a_mesh(fused_setup, n):
    """Both halves, 2 cams x 24 rays a step through K4's plain version, the
    rays split over n entries (n = 3: 16 + 16 + 16; each entry's K4 scales
    by the global ray count)."""
    f = fused_setup
    st0, l0 = f["single"]
    st1, l1 = f["port"](cpu_mesh(n))
    if n == 1:
        assert np.array_equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(_params(st0), _params(st1)))
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    _assert_params_close(_params(st1), _params(st0))
    assert [s.step for s in st1] == [N_STEPS] * 2 and all(s.opt.count == N_STEPS for s in st1)
    if n == 2:
        # a second sharded run is bit-identical
        st2, l2 = f["port"](cpu_mesh(n))
        assert np.array_equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(_params(st1), _params(st2)))
    if n in (2, 4):
        _, jl = jnt.train_nerf_fused(*f["args"], f["jf"], render_cfg=RENDER, train_cfg=TRAIN, n_steps=N_STEPS,
                                     seed=SEED, steps_per_call=SPC, mesh=jmesh.make_mesh(n))
        # test_torch_train.py's bar for the standing divergence
        np.testing.assert_allclose(l1, np.asarray(jl), rtol=2e-2)


@pytest.fixture(scope="module")
def chunked_setup(half):  # noqa: F811
    cfg = _cfg(True)
    jf = jfields.NerfField(cfg)
    init = jnt.init_state(jf, TRAIN, jax.random.PRNGKey(SEED))[0]
    init_params = tuple(convert.params_from_jax(_np_tree(p)) for p in (init.params_coarse, init.params_fine))
    draws = fused_schedule_draws(SEED, 1, HALF_STEPS, HALF_SPC, TRAIN.batch_size, HALF_RENDER, CHUNK)

    def port(mesh, **kw):
        return tnt.train_nerf(*half, cfg, HALF_RENDER, TRAIN, n_steps=HALF_STEPS, seed=SEED, init_params=init_params,
                              draws=lambda i: draws[i], ray_chunk=CHUNK, device=None if mesh else "cpu", mesh=mesh,
                              **kw)

    return dict(jf=jf, port=port, single=port(None))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_chunked_training_on_a_mesh(chunked_setup, half, n, monkeypatch):  # noqa: F811
    """One half, 40 rays a step at a 16-ray chunk: each entry chunks its
    own rays through K5 / K6's plain versions (n = 2: 16 + 4 per entry),
    resampling with its rows of the step's draws; the checkpoint hook sees
    home's state."""
    c = chunked_setup
    st0, l0 = c["single"]
    calls = []
    fwd = tnt.field_kernel.field_color_fwd_op
    monkeypatch.setattr(tnt.field_kernel, "field_color_fwd_op", lambda pts, *a: calls.append(pts.shape[1]) or fwd(
        pts, *a))
    monkeypatch.setattr(tnt.field_kernel, "bundle_loss_op", None)     # a K4 call would raise
    seen = []
    st1, l1 = c["port"](cpu_mesh(n), on_checkpoint=lambda st, step: seen.append(step))
    shards = [s.stop - s.start for s in tmesh.slices(40, cpu_mesh(n))]
    per_step = [min(CHUNK, r - i) for r in shards for i in range(0, r, CHUNK) for _ in (0, 1)]
    assert calls == per_step * HALF_STEPS
    assert seen == [k for k in range(1, HALF_STEPS + 1) if k % TRAIN.ckpt_every == 0 or k == HALF_STEPS]
    if n == 1:
        assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(_params([st0]), _params([st1])))
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    _assert_params_close(_params([st1]), _params([st0]))
    if n == 2:  # the reference's compile of its sharded chunked step takes ~10 s a mesh size here
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnt.make_multi_step, "__defaults__", (CHUNK, None))
            mp.setattr(jnt, "_cached_or_fresh", lambda cache_fn, fresh_fn, *key: fresh_fn())
            _, jl = jnt.train_nerf(*half, c["jf"], render_cfg=HALF_RENDER, train_cfg=TRAIN, n_steps=HALF_STEPS,
                                   seed=SEED, steps_per_call=HALF_SPC, mesh=jmesh.make_mesh(n))
        np.testing.assert_allclose(l1, np.asarray(jl), rtol=2e-2)


def _step_args(scene):  # noqa: F811
    """Both halves' first two cameras and their images: train_step's
    (cam, images, sils) after the states and before the optimizer."""
    idx = np.array([[0, 1], [2, 3]])
    hh = np.arange(2)[:, None]
    T = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    cam = tnt.cam_lib.camera_from_bop(*(T(scene[k][hh, idx]) for k in ("R_bop", "t_bop", "K")), 24)
    return cam, T(scene["images"][hh, idx]), T(scene["sils"][hh, idx])


def _fresh_states():
    return [tnt.init_state(_cfg(True), TRAIN, torch.Generator().manual_seed(h), device="cpu") for h in range(2)]


def assert_step_matches(new, want, grads, want_grads, rates, grad_tol=1e-4):
    """One step of a sharded run against the unsharded step from the same
    state and draws.  The summed grads are the unsharded step's to f32 sum
    order: each tensor within ``grad_tol`` of its max |g| plus 1e-5 of
    every grad's max (a tensor whose grad is 0, such as the keys' output
    bias under the shift-invariant softmax, holds f32 noise; a shard
    weighted wrongly moves its share of every grad).  The params after the
    step are at the reference's bar (rtol 1e-3, atol 2e-5), but where the
    unsharded grad sits within that sum-order error of 0: there Adam's
    first step (~ the rate times sign(g)) may go the other way, so those
    elements are held to twice their rate (``rates``: one per tensor)."""
    g_all = max(float(g.abs().max()) for g in want_grads)
    for a, b, g, gw, rate in zip(new, want, grads, want_grads, rates):
        bar_g = grad_tol * float(gw.abs().max()) + 1e-5 * g_all
        assert float((g - gw).abs().max()) <= bar_g
        bar = torch.where(gw.abs() <= bar_g, torch.full_like(b, 2.0 * rate), 2e-5 + 1e-3 * b.abs())
        assert bool(((a - b).abs() <= bar).all())


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("ray_chunk", [tnt.RAY_CHUNK, CHUNK], ids=["fused", "chunked"])
def test_train_step_grads_on_a_mesh(scene, ray_chunk, n):  # noqa: F811
    """One step of both halves (2 cams x 24 rays: single-chunk through K4's
    plain version, or at a 16-ray chunk through K5 / K6's; n = 3 cuts 16 +
    16 + 16 rays, chunked 16 | 16 | 16), from the same fresh states and
    draws, on n entries against no mesh."""
    cam, images, sils = _step_args(scene)
    opt = tnt.make_optimizer(TRAIN)
    runs = []
    for mesh in (None, cpu_mesh(n)):
        draws = tnt.draw([torch.Generator().manual_seed(9 + h) for h in range(2)], 2, RENDER, torch.device("cpu"))
        new, loss, _ = tnt.train_step(_fresh_states(), cam, images, sils, opt, RENDER, TRAIN, scene["min_d"],
                                      scene["max_d"], draws=draws, ray_chunk=ray_chunk, mesh=mesh)
        runs.append((new, loss, [p.grad.clone() for st in new for p in tnt.train_params(st)]))
    (s0, l0, g0), (s1, l1, g1) = runs
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-5)
    assert_step_matches(_params(s1), _params(s0), g1, g0, [opt.learning_rate(0)] * len(g0))


def test_train_step_replicas_follow_home(scene):  # noqa: F811
    """After a sharded step every entry's copy holds home's new weights (in
    place, the same tensors as before the step)."""
    states = _fresh_states()
    mesh = cpu_mesh(3)
    reps = tnt.replicate_states(states, mesh)
    before = [p.data_ptr() for rep in reps for st in rep for p in tnt.train_params(st)]
    g = [torch.Generator().manual_seed(9 + h) for h in range(2)]
    new, loss, _ = tnt.train_step(states, *_step_args(scene), tnt.make_optimizer(TRAIN), RENDER, TRAIN,
                                  scene["min_d"], scene["max_d"], generators=g, mesh=mesh, replicas=reps)
    assert torch.isfinite(loss).all()
    home = _params(new)
    for rep in reps:
        assert all(torch.equal(a, b) for a, b in zip(_params(rep), home))
    assert before == [p.data_ptr() for rep in reps for st in rep for p in tnt.train_params(st)]


# ------------------------------------------------------- descriptor training


@pytest.fixture(scope="module")
def pose_runs(data):  # noqa: F811
    """3 steps of the reference's train_pose on a 2-device mesh, and the
    port's unsharded from the same state and draws."""
    st0, _, jlosses = _reference_run_on(data, jmesh.make_mesh(2))
    port = lambda mesh, **kw: tpt.train_pose(  # noqa: E731
        None, data["images"], data["sils"], _port_bank(data), data["neg"], cfg=_port_cfg(POSE),
        aug_cfg=taug.AugmentConfig(*AUG), n_steps=3, seed=POSE_SEED, resume_state=_port_state(st0),
        device=None if mesh else "cpu", draws=lambda i: reference_draws(data, i), mesh=mesh, **kw)
    return dict(jlosses=jlosses, port=port, single=port(None))


def _reference_run_on(data, mesh):
    """``test_torch_pose_train._reference_run`` with the reference's
    train_pose on ``mesh``."""
    train_pose = jpt.train_pose
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpt, "train_pose", lambda *a, **kw: train_pose(*a, **{**kw, "mesh": mesh}))
        return _reference_run(data, POSE_FIELD)


def _pose_params(state):
    return [p.detach().clone() for p in list(state.cnn.parameters()) + list(state.field.parameters())]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_train_pose_on_a_mesh(pose_runs, n, capsys):
    """2 views a step split 1 + 1 (n = 4 cuts to the widest sub-mesh that
    divides the batch, 2, as the reference does): each entry's loss weighted
    by its share of the views."""
    r = pose_runs
    s0, l0 = r["single"]
    s1, l1 = r["port"](cpu_mesh(n))
    if n == 1:
        assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(_pose_params(s0), _pose_params(s1)))
    if n == 4:
        assert "a 2-device sub-mesh" in capsys.readouterr().out
    np.testing.assert_allclose(l1, l0, rtol=5e-3)
    np.testing.assert_allclose(l1, r["jlosses"], rtol=5e-3)
    max_move = 3 * POSE.lr_cnn
    for a, b in zip(_pose_params(s1), _pose_params(s0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2 * max_move)
    if n == 2:
        s2, l2 = r["port"](cpu_mesh(n))
        assert l1 == l2 and all(torch.equal(a, b) for a, b in zip(_pose_params(s1), _pose_params(s2)))


def test_pose_step_on_uneven_shards(data):  # noqa: F811
    """A 4-view step over 3 entries (2 + 1 + 1) against the unsharded step
    from the same state and draws, sampled rays drawn in the step on home:
    the loss, the summed grads (each entry's weighted by its share, 2/4 or
    1/4) and the params after the step (``assert_step_matches``)."""
    base = tpt.init_pose_state(_port_field(POSE_FIELD), _port_cfg(POSE), TUNet(**UNET, dtype=torch.float32),
                               torch.Generator().manual_seed(0), device="cpu")
    idx = np.arange(4)
    T = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    g = torch.Generator().manual_seed(5)
    draws = tpt.draw_pose_step(g, 4, 32, data["neg"].shape[0], _port_cfg(POSE), taug.AugmentConfig(*AUG))
    out = []
    for mesh in (None, cpu_mesh(3)):
        st = copy.deepcopy(base)
        new, loss, aux = tpt.pose_train_step(st, tpt.make_pose_optimizer(_port_cfg(POSE)), T(data["images"][idx]),
                                             T(data["sils"][idx]), T(data["pos"][idx]), T(data["xys"][idx]),
                                             T(data["valid"][idx]), T(data["neg"]), _port_cfg(POSE),
                                             taug.AugmentConfig(*AUG), draws, torch.Generator().manual_seed(7),
                                             mesh=mesh)
        trained = list(new.cnn.parameters()) + tpt.head_params(new.field)
        out.append((new, loss, aux, [p.detach().clone() for p in trained], [p.grad.clone() for p in trained]))
    (a, la, xa, pa, ga), (b, lb, xb, pb, gb) = out
    np.testing.assert_allclose(float(lb), float(la), rtol=1e-5)
    np.testing.assert_allclose(float(xb["nce"]), float(xa["nce"]), rtol=1e-5)
    opt = tpt.make_pose_optimizer(_port_cfg(POSE))
    n_cnn = len(list(a.cnn.parameters()))
    rates = [opt.learning_rate(POSE.lr_cnn if k < n_cnn else POSE.lr_mlp, 0) for k in range(len(pa))]
    assert_step_matches(pb, pa, gb, ga, rates)
    # the frozen trunk is untouched
    for p, q in zip(a.field.trunk1.parameters(), b.field.trunk1.parameters()):
        assert torch.equal(p, q)
