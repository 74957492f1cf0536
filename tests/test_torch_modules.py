"""The helpers the port's CLI brought along, each against the JAX
package's original on the same numpy inputs: the image-folder banks, the
visualization helpers (and the standard-library PNG writer against
Pillow's), the full-grid render, the analytic stand-in field, ADD-S, the
registration helpers, Euler angles, the pose-stage checkpoints, and the
fixed-order backward of the sampled query read."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import rotations as jrot
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import metrics as jmetrics
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import registration as jreg
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.render import renderer as jrend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import augment as jaug
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.utils import viz as jviz
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import config as tconfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic as tsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as tcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import rotations as trot
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import grid_sample
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics as tmetrics
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import registration as treg
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer as trend
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as taug
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint, pose_trainer
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Five images of three sizes and formats (objects on black, one all
    black), and a file that is not an image."""
    d = tmp_path_factory.mktemp("bank")
    rng = np.random.default_rng(0)
    for i, (h, w, ext) in enumerate([(40, 52, "png"), (33, 33, "PNG"), (64, 20, "bmp"), (48, 48, "png"),
                                     (17, 29, "png")]):
        img = np.zeros((h, w, 3), np.uint8)
        if i != 3:
            img[h // 4: 3 * h // 4, w // 5: 4 * w // 5] = rng.integers(1, 255, (3 * h // 4 - h // 4,
                                                                            4 * w // 5 - w // 5, 3))
        Image.fromarray(img).save(d / f"im{i}.{ext}")
    (d / "notes.txt").write_text("not an image")
    return str(d)


@pytest.mark.parametrize("max_images", [3, 256])
def test_image_banks_match_reference(image_dir, max_images):
    np.testing.assert_array_equal(taug.load_background_bank(image_dir, 24, max_images),
                                  jaug.load_background_bank(image_dir, 24, max_images))
    for a, b in zip(taug.load_distractor_bank(image_dir, 24, max_images),
                    jaug.load_distractor_bank(image_dir, 24, max_images)):
        np.testing.assert_array_equal(a, b)


def test_image_bank_of_an_empty_folder_raises(tmp_path):
    with pytest.raises(ValueError, match="no images"):
        taug.load_background_bank(str(tmp_path), 8)


def test_viz_helpers_match_reference():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(9, 11, 12)).astype(np.float32)
    mask = (rng.uniform(size=(9, 11)) > 0.3).astype(np.float32)
    for kw in ({}, {"mask": mask}, {"mask": mask, "demean": True}, {"demean": True}):
        np.testing.assert_array_equal(tviz.emb_vis(emb, **kw), jviz.emb_vis(emb, **kw))
    imgs = [rng.uniform(size=(7, 5, 4)).astype(np.float32), rng.uniform(size=(6, 5)).astype(np.float32),
            rng.uniform(size=(7, 4, 3)).astype(np.float32)]
    for kw in ({}, {"rows": 1, "cols": 3, "fill": False}, {"rows": 2, "cols": 2, "rgb": False},
               {"rows": 3, "cols": 1, "pad": 3}):
        np.testing.assert_array_equal(tviz.image_grid(imgs, **kw), jviz.image_grid(imgs, **kw))
    with pytest.raises(ValueError):
        tviz.image_grid(imgs, rows=2)
    # the camera ring: the same f32 rotations (sin / cos of the same f32
    # angles; XLA's and torch's may round the last bit apart)
    for n in (1, 7, 36):
        Rt, tt = tviz.rotating_views(n, 3.5)
        Rj, tj = jviz.rotating_views(n, 3.5)
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1.2e-7)
        np.testing.assert_array_equal(tt, tj)
        assert Rt.dtype == Rj.dtype == np.float32


def test_euler_zyx_matches_reference():
    e = np.random.default_rng(2).uniform(-3.2, 3.2, (5, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(trot.euler_zyx_to_matrix(_t(e)).numpy(), np.asarray(jrot.euler_zyx_to_matrix(e)),
                               atol=2e-7)


@pytest.mark.parametrize("shape", [(6, 5, 3), (6, 5), (4, 3, 4)])
def test_save_image_writes_what_pillow_writes(tmp_path, shape):
    """The standard-library PNG decodes (with Pillow) to the pixels
    Pillow's own writer stores for the same image."""
    img = np.random.default_rng(3).uniform(-0.2, 1.2, shape).astype(np.float32)
    if len(shape) == 3 and shape[-1] == 4:
        img = img[..., :3]
    tviz.save_image(str(tmp_path / "a" / "port.png"), img)
    jviz.save_image(str(tmp_path / "ref.png"), img)
    with Image.open(tmp_path / "a" / "port.png") as a, Image.open(tmp_path / "ref.png") as b:
        assert a.mode == b.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _planted(cfg):
    p = convert.planted_field_params(tconfig.FieldConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
    field = NerfField(tconfig.FieldConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
    field.load_state_dict(convert.params_from_jax(p))
    return p, field


def test_render_preview_and_grid_render_match_reference():
    """A small planted f32 field rendered from one synthetic camera: colour
    and silhouette to 2e-5; the analytic field's full-grid render in both
    modes to 2e-5."""
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, compute_dtype="float32")
    p, field = _planted(cfg)
    sc = jsyn.make_scene(n_views=2, image_size=20, key=jax.random.PRNGKey(4))
    S = 20
    jc = jcam.camera_from_bop(sc.R_bop, sc.t_bop, sc.K, S)[1]
    tc = tcam.camera_from_bop(*(_t(x) for x in (sc.R_bop, sc.t_bop, sc.K)), S)[1]
    rgb_j, sil_j = jviz.render_preview(jfields.NerfField(cfg), jax.tree.map(jnp.asarray, p), jc, S, 24, 2.0, 6.0)
    rgb_t, sil_t = tviz.render_preview(field, tc, S, 24, 2.0, 6.0)
    assert float(sil_t.max()) > 0.5 and float(sil_t.min()) < 0.1
    np.testing.assert_allclose(rgb_t, rgb_j, atol=2e-5)
    np.testing.assert_allclose(sil_t, sil_j, atol=2e-5)
    for thr in (True, False):
        want = jrend.render_grid_chunked(jsyn.analytic_field, jc, S, 32, 2.0, 6.0, mode="feature",
                                         threshold_mode=thr, chunk=128)
        got = trend.render_grid_chunked(tsyn.analytic_field, tc, S, 32, 2.0, 6.0, mode="feature",
                                        threshold_mode=thr, chunk=128)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_analytic_field_matches_reference():
    pts = np.random.default_rng(5).uniform(-1.0, 1.0, (7, 9, 3)).astype(np.float32)
    tf, jf = tsyn.AnalyticField("cpu"), jsyn.AnalyticField()
    np.testing.assert_allclose(tf.features(_t(pts)).numpy(), np.asarray(jf.features(pts)), atol=2e-6)
    for mode in ("color", "feature", "both"):
        for a, b in zip(tf(_t(pts), None, mode), jf(pts, None, mode)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    for mode in ("color", "feature"):
        for a, b in zip(tsyn.analytic_field(_t(pts), None, mode), jsyn.analytic_field(pts, None, mode)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    assert next(tf.parameters()).numel() == 0 and not hasattr(tf, "cfg")


def test_adds_metric_matches_reference():
    """ADD-S with and without a separate NN-target cloud, and the 0.1 x
    diameter criterion: to 1e-6 (the reference's CPU neighbour search
    squares distances the expanded way, the port's K2 twin takes exact
    differences; the nearest neighbours agree)."""
    rng = np.random.default_rng(6)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    surf = rng.normal(size=(500, 3)).astype(np.float32)
    Rg = np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rng.normal(size=3)))).astype(np.float32)
    Re = np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rng.normal(size=3) * 0.2))).astype(np.float32) @ Rg
    tg, te = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    for sp in (None, surf):
        want = float(jmetrics.adds_metric(verts, Rg, tg, Re, te, surface_points=sp))
        got = float(tmetrics.adds_metric(_t(verts), _t(Rg), _t(tg), _t(Re), _t(te),
                                         surface_points=None if sp is None else _t(sp)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
        for sym in (False, True):
            for diam in (0.5 * want / 0.1, 2.0 * want / 0.1):
                assert bool(tmetrics.pose_correct(_t(verts), _t(Rg), _t(tg), _t(Re), _t(te), diam, sym,
                                                  None if sp is None else _t(sp))) == bool(
                    jmetrics.pose_correct(verts, Rg, tg, Re, te, diam, sym, sp))


def test_registration_helpers_match_reference():
    """Relative poses to 1e-6; the agreement errors to 1e-4 (both square
    distances as |a|^2 + |b|^2 - 2 a.b, in f32: where a pair's clouds
    nearly coincide the square root lifts the sum-order rounding to
    ~1e-5); the same agreements, best image and top-k."""
    rng = np.random.default_rng(7)
    N = 9
    R = np.stack([np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rng.normal(size=3)))) for _ in range(N)])
    R = R.astype(np.float32)
    t = rng.normal(size=(N, 3)).astype(np.float32)
    Rp = np.stack([np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rng.normal(size=3) * (0.02 if i % 3 else 0.6))))
                   for i in range(N)]).astype(np.float32) @ R
    tp = t + rng.normal(size=(N, 3)).astype(np.float32) * 0.01
    verts = rng.normal(size=(120, 3)).astype(np.float32)
    (jRg, jtg), (jRp, jtp) = jreg.relative_pose_tensor(R, t), jreg.relative_pose_tensor(Rp, tp)
    (tRg, ttg), (tRp, ttp) = treg.relative_pose_tensor(_t(R), _t(t)), treg.relative_pose_tensor(_t(Rp), _t(tp))
    np.testing.assert_allclose(tRg.numpy(), np.asarray(jRg), atol=1e-6)
    np.testing.assert_array_equal(ttg.numpy(), np.asarray(jtg))
    diam = 3.0
    agree_j, err_j = jreg.agreement_matrix(jRg, jtg, jRp, jtp, jnp.asarray(verts), diam, pair_chunk=16)
    agree_t, err_t = treg.agreement_matrix(tRg, ttg, tRp, ttp, _t(verts), diam, pair_chunk=16)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), atol=1e-4)
    np.testing.assert_array_equal(agree_t.numpy(), np.asarray(agree_j))
    assert 0 < int(agree_t.sum()) < N * N
    for k in (3, 50):
        bt, tt = treg.choose_best_image(agree_t.numpy(), top_k=k)
        bj, tj = jreg.choose_best_image(np.asarray(agree_j), top_k=k)
        assert bt == bj
        np.testing.assert_array_equal(tt, tj)


def _small_cnn():
    return ResNetUNet(widths=(8, 16, 16), stage_sizes=(1, 1, 1), decoder_width=8, dtype=torch.float32)


def test_pose_checkpoint_round_trip(tmp_path):
    """``save_pose_latest`` then ``load_pose_state``: the field, the CNN,
    both groups' moments, the count and the step come back bit for bit;
    the field and the CNN are also readable alone, and moments of another
    architecture are refused."""
    _check_pose_checkpoint(tmp_path, tconfig.FieldConfig(n_harmonic_functions=8, n_hidden=48))


def test_pose_checkpoint_round_trip_nosiren(tmp_path):
    """The same with the softplus MLP head (siren=False): feat1 / feat2 and
    their moments."""
    _check_pose_checkpoint(tmp_path, tconfig.FieldConfig(n_harmonic_functions=8, n_hidden=48, siren=False))


def _check_pose_checkpoint(tmp_path, cfg):
    field = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(1))
    state = pose_trainer.init_pose_state(field, tconfig.PoseTrainConfig(),
                                         _small_cnn().reset_parameters(torch.Generator().manual_seed(2)), device="cpu")
    g = torch.Generator().manual_seed(3)
    opt = state.opt
    for t in opt.head_mu + opt.head_nu + opt.cnn_mu + opt.cnn_nu:
        t.copy_(torch.rand(t.shape, generator=g))
    state = state._replace(opt=opt._replace(count=7), step=9)
    checkpoint.save_pose_latest(str(tmp_path), state)
    back = checkpoint.load_pose_state(str(tmp_path / checkpoint.STATE), cfg, _small_cnn(), device="cpu")
    assert back.step == 9 and back.opt.count == 7
    assert [p.shape for p in pose_trainer.head_params(back.field)] == [m.shape for m in back.opt.head_mu]
    for mod in ("field", "cnn"):
        for (n, a), (_, b) in zip(getattr(state, mod).state_dict().items(), getattr(back, mod).state_dict().items()):
            assert torch.equal(a, b), n
    for name in ("head_mu", "head_nu", "cnn_mu", "cnn_nu"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(opt, name), getattr(back.opt, name)))
    tree, step = checkpoint.load(str(tmp_path / checkpoint.ENCODER), device="cpu")
    assert step == 9 and all(torch.equal(tree[n], p) for n, p in state.cnn.state_dict().items())
    tree, _ = checkpoint.load(str(tmp_path / checkpoint.LATEST), device="cpu")
    assert all(torch.equal(tree[n], p) for n, p in state.field.state_dict().items())
    other = ResNetUNet(widths=(8, 16, 16), stage_sizes=(1, 1, 1), decoder_width=8, n_class=13, dtype=torch.float32)
    other.out = torch.nn.Conv2d(8, 13, 3, padding=1)
    with pytest.raises((ValueError, RuntimeError)):
        checkpoint.load_pose_state(str(tmp_path / checkpoint.STATE), cfg, other, device="cpu")


def test_gather_rows_backward_matches_gather():
    """The sampled read's fixed-order backward sums repeated rows to the
    same grads as ``torch.gather``'s (to f32 rounding of the sum order)."""
    g = torch.Generator().manual_seed(8)
    flat = torch.randn((3, 50, 12), generator=g, requires_grad=True)
    idx = torch.randint(0, 50, (3, 400), generator=g)          # many repeats
    w = torch.randn((3, 400, 12), generator=g)
    (grid_sample.gather_rows(flat, idx) * w).sum().backward()
    got, flat.grad = flat.grad.clone(), None
    (torch.gather(flat, 1, idx[..., None].expand(-1, -1, 12)) * w).sum().backward()
    torch.testing.assert_close(got, flat.grad, rtol=1e-6, atol=1e-6)
    assert torch.equal(grid_sample.gather_rows(flat, idx), torch.gather(flat, 1, idx[..., None].expand(-1, -1, 12)))


def test_analytic_field_custom_forward_matches_reference():
    pts = np.random.default_rng(6).uniform(-1.0, 1.0, (5, 4, 3)).astype(np.float32)
    got = tsyn.AnalyticField("cpu").custom_forward(_t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(jsyn.AnalyticField().custom_forward(pts)), atol=2e-6)
    assert got.shape == (5, 4, 13) and not got[..., -1].any()
