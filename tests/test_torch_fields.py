"""Port parity: NerfField (every head, both embeddings) and ResNetUNet against
the flax reference, through ``convert.params_from_jax`` (CPU)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import unet as junet
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import unet as tunet

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_field(cfg, params):
    f = tfields.NerfField(cfg)
    f.load_state_dict(convert.params_from_jax(_np_tree(params)))
    return f


def _check_field_heads(cfg):
    jf = jfields.NerfField(cfg)
    params = jfields.init_field(jf, jax.random.PRNGKey(0))
    tf = port_field(cfg, params)
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(5, 7, 3)) * 0.5).astype(np.float32)
    dirs = rng.normal(size=(5, 3)).astype(np.float32)
    pt, dt = torch.from_numpy(pts), torch.from_numpy(dirs)
    with torch.no_grad():
        # same bf16 rounding points as flax; only f32 summation order and the
        # sin/cos ulps (doubled per ladder rung, 2^(L-1) at most) differ
        np.testing.assert_allclose(tf.embed(pt).numpy(), np.asarray(jf.apply(params, pts, method=jf.embed)),
                                   atol=1e-5)
        np.testing.assert_allclose(tf.density(pt).numpy(), np.asarray(jf.apply(params, pts, method=jf.density)),
                                   atol=1e-5)
        np.testing.assert_allclose(tf.color(pt, dt).numpy(),
                                   np.asarray(jf.apply(params, pts, dirs, method=jf.color)), atol=1e-5)
        np.testing.assert_allclose(tf.features(pt).numpy(),
                                   np.asarray(jf.apply(params, pts, method=jf.features)), atol=1e-5)
        np.testing.assert_allclose(tfields.eval_features(tf, pt).numpy(),
                                   np.asarray(jfields.eval_features(jf, params, pts)), atol=1e-5)
        dens_t, both_t = tf(pt, dt, mode="both")
        dens_j, both_j = jf.apply(params, pts, dirs, "both")
        np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j), atol=1e-5)
        np.testing.assert_allclose(both_t.numpy(), np.asarray(both_j), atol=1e-5)
        for name in ("density_and_features", "custom_forward"):
            got, want = getattr(tf, name)(pt), jf.apply(params, pts, method=getattr(jf, name))
            for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("embed", ["direct", "grouped"])
@pytest.mark.parametrize("compute,act", [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                                         ("float32", "float32")])
def test_field_heads_match_flax(embed, compute, act):
    _check_field_heads(FieldConfig(n_harmonic_functions=8, n_hidden=48, compute_dtype=compute, act_dtype=act,
                                   embed_method=embed))


@pytest.mark.parametrize("embed", ["direct", "grouped"])
@pytest.mark.parametrize("compute,act", [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                                         ("float32", "float32")])
def test_nosiren_field_heads_match_flax(embed, compute, act):
    """The softplus MLP head on the embedding (siren=False): flax's rounding
    points (feat1 / feat2 on the compute dtype, the softplus in f32 and not
    stored in act_dtype), the same bar as the SIREN head's."""
    _check_field_heads(FieldConfig(n_harmonic_functions=8, n_hidden=48, compute_dtype=compute, act_dtype=act,
                                   embed_method=embed, siren=False))


def test_nosiren_head_rounds_as_flax_does():
    """With f32 products and bf16 storage the head's softplus stays in f32:
    rounding it to bf16 (as the trunk's ``_act`` does) moves the keys by
    more than the bar.  (With bf16 products feat2 rounds its input anyway.)"""
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, compute_dtype="float32", act_dtype="bfloat16",
                      siren=False)
    jf = jfields.NerfField(cfg)
    params = jfields.init_field(jf, jax.random.PRNGKey(4))
    tf = port_field(cfg, params)
    pts = (np.random.default_rng(2).normal(size=(400, 3)) * 0.5).astype(np.float32)
    want = np.asarray(jf.apply(params, pts, method=jf.features))
    pt = torch.from_numpy(pts)
    with torch.no_grad():
        np.testing.assert_allclose(tf.features(pt).numpy(), want, atol=1e-5)
        h = tf._act(tf._matmul(tf.embed(pt), tf.feat1))
        stored = torch.sigmoid(tf._matmul(h, tf.feat2)).numpy()
    assert np.abs(stored - want).max() > 1e-4


def _check_init(cfg):
    # full width: same shapes as the flax tree, same per-layer statistics
    tf = tfields.NerfField(cfg).reset_parameters(torch.Generator().manual_seed(0))
    jf = jfields.NerfField(cfg)
    params = _np_tree(jfields.init_field(jf, jax.random.PRNGKey(0)))
    sd = convert.params_from_jax(params)
    ours = tf.state_dict()
    assert set(sd) == set(ours)
    for k, v in sd.items():
        assert ours[k].shape == v.shape, k
        # std within 10% (>= 768 draws per tensor), biases equal where constant
        if v.numel() >= 768:
            assert abs(float(ours[k].std()) / float(v.std()) - 1.0) < 0.1, k
    assert float(tf.density_layer.bias.detach()) == cfg.density_bias
    return tf, params


def test_port_init_follows_flax_distributions():
    _check_init(FieldConfig())


def test_nosiren_port_init_follows_flax_distributions():
    """feat1 / feat2 drawn lecun-normal with zero biases, after every other
    head: the trunk, density and colour weights of a seed do not depend on
    ``siren``, in the port as in flax (which folds its init keys by module
    name)."""
    tf, params = _check_init(FieldConfig(siren=False))
    assert not tf.feat1.bias.any() and not tf.feat2.bias.any()
    siren = tfields.NerfField(FieldConfig()).reset_parameters(torch.Generator().manual_seed(0)).state_dict()
    jsiren = convert.params_from_jax(_np_tree(jfields.init_field(jfields.NerfField(FieldConfig()),
                                                                 jax.random.PRNGKey(0))))
    ref = convert.params_from_jax(params)
    for name, v in tf.state_dict().items():
        if name.split(".")[0] in tfields.NON_FEATURE_MODULES:
            assert torch.equal(v, siren[name]) and torch.equal(ref[name], jsiren[name]), name


def _check_planted(cfg):
    planted = convert.planted_field_params(cfg, seed=3)
    ref = jfields.init_field(jfields.NerfField(cfg), jax.random.PRNGKey(0))
    flat_p = flax.traverse_util.flatten_dict(planted)
    flat_r = flax.traverse_util.flatten_dict(ref)
    assert {k: v.shape for k, v in flat_p.items()} == {k: v.shape for k, v in flat_r.items()}
    # the planted density is a closed blob of radius ~0.5 in flax as well
    jf = jfields.NerfField(cfg)
    r = np.float32([0.0, 0.3, 0.45, 0.6, 0.9, 1.2])
    for d in (np.float32([1, 0, 0]), np.float32([0, -0.6, 0.8])):
        dens = np.asarray(jf.apply(planted, r[:, None] * d, method=jf.density))[:, 0]
        assert (dens[:3] > 0.9).all() and (dens[3:] < 1e-3).all(), dens
    return planted


def test_planted_tree_matches_flax_layout():
    _check_planted(FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16"))


def test_nosiren_planted_tree_matches_flax_layout():
    """A planted non-SIREN field: feat1 / feat2 beside the same planted
    density, and the trunk drawn as the SIREN field's of the same seed."""
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", siren=False)
    planted = _check_planted(cfg)["params"]
    siren = convert.planted_field_params(FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16"),
                                         seed=3)["params"]
    for name in tfields.NON_FEATURE_MODULES:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(planted[name][leaf], siren[name][leaf])
    assert not planted["feat1"]["bias"].any() and planted["feat2"]["kernel"].shape == (48, 12)
    f = tfields.NerfField(cfg)
    f.load_state_dict(convert.params_from_jax(_np_tree({"params": planted})))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_matches_flax(dtype):
    widths = (16, 32, 64, 128)
    jnet = junet.ResNetUNet(widths=widths, dtype=jnp.dtype(dtype))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 48, 48, 3)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-trivial norm parameters so the scale/bias mapping is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(p))), v.shape)
        if "GroupNorm" in str(p) else v, params)
    tnet = tunet.ResNetUNet(widths=widths, dtype=getattr(torch, dtype))
    tnet.load_state_dict(convert.params_from_jax(_np_tree(params)))
    yj = np.asarray(jnet.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x)).numpy()
    assert yt.shape == yj.shape == (2, 48, 48, 13)
    err = np.abs(yt - yj)
    if dtype == "float32":
        # same graph in f32: only summation order differs
        assert float(err.max()) < 1e-4, err.max()
    else:
        # every conv output rounds to bf16 in both frameworks, but XLA's and
        # oneDNN's f32 sums differ in order, so rounding flips compound over
        # 20 layers: a percent of the output's spread at the median
        std = float(yj.std())
        assert float(np.median(err)) < 1e-2 * std and float(err.max()) < 0.1 * std, (np.median(err), err.max())
    img = rng.uniform(size=(4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(tunet.normalize_image(torch.from_numpy(img)).numpy(),
                               np.asarray(junet.normalize_image(jnp.asarray(img))), atol=1e-6)


def _bf16_blocks_sum(rows: torch.Tensor, blocks: int = 4) -> torch.Tensor:
    """XLA's CPU reduction of a bf16 array over its rows: ``blocks``
    contiguous blocks, each summed row by row with every partial rounded
    to bf16, then the block sums the same way."""
    def seq(part):
        s = torch.zeros(part.shape[1:])
        for r in part:
            s = (s + r).to(torch.bfloat16).float()
        return s

    return seq(torch.stack([seq(b) for b in rows.float().chunk(blocks)]))


def test_nosiren_head_grads_match_flax():
    """Grads of the softplus MLP head: the weights' bit for bit; each bias's
    is the sum of the same bf16 row cotangents, which the port takes in
    f32 and flax (``lax.reduce_sum`` of a bf16 array, XLA on the CPU) in
    bf16 over 4 blocks of rows.  Summed that way, the port's rows give the
    reference's bias grads bit for bit; that is the whole of the
    difference (~1 % of the max here), and the descriptor-step test bounds
    the head's biases by it."""
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, siren=False)
    jf = jfields.NerfField(cfg)
    params = _np_tree(jfields.init_field(jf, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(128, 3)) * 0.4).astype(np.float32)
    c = rng.normal(size=(128, 12)).astype(np.float32)
    ref = convert.params_from_jax(_np_tree(jax.grad(lambda p: jnp.sum(jf.apply(p, pts, method=jf.features) * c))(
        params)))
    tf = port_field(cfg, params)
    rows = {}
    dense = tfields._dense_bf16

    def recorded(x, weight, bias):      # each layer's row cotangents, as its output rounding passes them on
        y = dense(x, weight, bias)
        name = "feat1" if weight is tf.feat1.weight else "feat2"
        y.register_hook(lambda g: rows.__setitem__(name, g.to(torch.bfloat16).float()))
        return y

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfields, "_dense_bf16", recorded)
        (tf.features(torch.from_numpy(pts)) * torch.from_numpy(c)).sum().backward()
    for name in ("feat1", "feat2"):
        assert torch.equal(tf.get_parameter(f"{name}.weight").grad, ref[f"{name}.weight"]), name
        got = tf.get_parameter(f"{name}.bias").grad
        assert torch.equal(got, rows[name].sum(0).to(torch.bfloat16).float())
        assert torch.equal(_bf16_blocks_sum(rows[name].to(torch.bfloat16)), ref[f"{name}.bias"]), name
        assert not torch.equal(got, ref[f"{name}.bias"])


def test_denormalize_image_matches_flax():
    img = np.random.default_rng(3).normal(size=(2, 5, 5, 3)).astype(np.float32)
    got = tunet.denormalize_image(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(junet.denormalize_image(jnp.asarray(img))), atol=1e-6)
    np.testing.assert_allclose(tunet.normalize_image(got).numpy(), img, atol=1e-5)
