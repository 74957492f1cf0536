"""The split colour pair K5/K6 (``field_kernel.field_color`` / ``FieldColor``),
the port's plain versions against the reference's ``field_color`` with its
Pallas kernels ``_fwd_kernel`` / ``_bwd_kernel`` in interpret mode, at a
small size (8 harmonics, 32-48 hidden) on inputs drawn with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import field_kernel as jfk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as tfk

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _case(embed, n_halves, R, P, n_hidden, seed):
    """Reference params per half (density bias 0, so densities spread over
    (0, 1)), the port's fields loaded from them, and points / directions."""
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=n_hidden, act_dtype="bfloat16", embed_method=embed)
    jf = jfields.NerfField(cfg)
    params, tf = [], []
    for h in range(n_halves):
        p = _np_tree(jfields.init_field(jf, jax.random.PRNGKey(seed + h)))
        p["params"]["density_layer"]["bias"][:] = 0.0
        params.append(p)
        f = tfields.NerfField(cfg)
        f.load_state_dict(convert.params_from_jax(p))
        tf.append(f)
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n_halves, R, P, 3)) * 0.6).astype(np.float32)
    dirs = rng.normal(size=(n_halves, R, 3)).astype(np.float32)
    return cfg, params, tf, pts, dirs


CASES = [  # embed, halves, rays, points, hidden
    ("direct", 1, 6, 9, 32),
    ("direct", 2, 3, 512, 48),      # 3 rays against the reference's 2-ray tiles at P = 512: ragged R
    ("grouped", 2, 7, 12, 48),
    ("grouped", 1, 5, 64, 32),
]


@pytest.mark.parametrize("embed,n_halves,R,P,n_hidden", CASES)
def test_field_color_forward_matches_pallas_kernel(embed, n_halves, R, P, n_hidden):
    cfg, params, tf, pts, dirs = _case(embed, n_halves, R, P, n_hidden, seed=R + P)
    with torch.no_grad():
        dens, rgb = tfk.field_color(tf, torch.from_numpy(pts), torch.from_numpy(dirs), cfg)
    assert dens.shape == (n_halves, R, P, 1) and rgb.shape == (n_halves, R, P, 3)
    for h in range(n_halves):
        dk, rk = jfk.field_color(params[h], jnp.asarray(pts[h]), jnp.asarray(dirs[h]), cfg, interpret=True)
        # the same rounding points; only f32 sums in another order (and the
        # ladder's sin/cos ulps) remain.  Where they flip a bf16 rounding of
        # an embedding or hidden value, that point moves by up to ~1e-4
        # (one point of 84 in the grouped case); every other agrees to f32 ulps
        for got, want in ((dens[h].numpy(), np.asarray(dk)), (rgb[h].numpy(), np.asarray(rk))):
            err = np.abs(got - want)
            assert err.max() < 1e-3 and (err > 2e-6).mean() <= 0.02, (err.max(), (err > 2e-6).mean())


def _mixed_loss(dens, rgb, R):
    # tests/test_field_kernel.py's loss: both heads, so every block gets a gradient
    return (dens * 0.7).sum() / R + (rgb * torch.cos(rgb)).sum() / R


@pytest.mark.parametrize("embed,n_halves,R,P,n_hidden", [CASES[0], CASES[2], CASES[3]])
def test_field_color_grads_match_pallas_kernel(embed, n_halves, R, P, n_hidden):
    """Autograd through FieldColor (the plain K6) against jax.value_and_grad
    through the reference's custom VJP (its K6 interpreted)."""
    cfg, params, tf, pts, dirs = _case(embed, n_halves, R, P, n_hidden, seed=3 + R)
    dens, rgb = tfk.field_color(tf, torch.from_numpy(pts), torch.from_numpy(dirs), cfg)
    loss = _mixed_loss(dens, rgb, R)
    loss.backward()
    for h in range(n_halves):
        def loss_k(p):
            d, r = jfk.field_color(p, jnp.asarray(pts[h]), jnp.asarray(dirs[h]), cfg, interpret=True)
            return (jnp.sum(d * 0.7) + jnp.sum(r * jnp.cos(r))) / R

        _, g = jax.value_and_grad(loss_k)(jax.tree.map(jnp.asarray, params[h]))
        ref = convert.params_from_jax(_np_tree(g))
        checked = 0
        for name, p in tf[h].named_parameters():
            if name.startswith("feature_layer"):
                assert p.grad is None and float(np.abs(ref[name].numpy()).max()) == 0.0
                continue
            s = max(float(np.abs(ref[name].numpy()).max()), 1e-3)
            # same rounding points and f32 accumulation; a cotangent rounded to
            # bf16 on the other side of a tie moves a block by ~1 bf16 ulp of s
            np.testing.assert_allclose(p.grad.numpy() / s, ref[name].numpy() / s, atol=1e-3, err_msg=name)
            checked += 1
        assert checked == 10


def test_field_color_hand_backward_matches_autograd(monkeypatch):
    """The plain K6 against torch.autograd of the plain K5's own forward,
    with bf16 rounding straight-through for autograd: the hand backward
    also rounds its cotangents and reads sigmoid' from the rounded
    activations, which the reference's own kernel-vs-flax test bounds at
    3e-2 of each block's max (tests/test_field_kernel.py)."""
    cfg, _, tf, pts, dirs = _case("grouped", 2, 5, 10, 48, seed=11)
    ladder, beta = tfk.ladder_of(cfg), cfg.softplus_beta
    fm = torch.from_numpy(tfk.fmat_of(cfg))
    weights = tuple(torch.stack(b) for b in zip(*(tfk.loss_weights(f) for f in tf)))
    dn = torch.from_numpy(dirs)
    dn = dn / dn.norm(dim=-1, keepdim=True)
    p = torch.from_numpy(pts)
    rng = np.random.default_rng(5)
    gdens = torch.from_numpy(rng.normal(size=(2, 5, 10, 1)).astype(np.float32))
    grgb = torch.from_numpy(rng.normal(size=(2, 5, 10, 3)).astype(np.float32))
    dens, rgb, res = tfk.field_color_fwd_plain(p, dn, fm, weights, ladder, beta, "bfloat16")
    assert all(res[k].dtype == torch.bfloat16 for k in tfk.RESIDUALS)
    assert res["es"].shape == (2, 5, 10, 3 * 8) and res["h1"].shape == (2, 5, 10, 48)
    hand = tfk.field_color_bwd_plain(dn, fm, weights, res, dens, rgb, gdens, grgb, ladder, beta, "bfloat16")
    monkeypatch.setattr(tfk, "_bf16", lambda x: x + (x.to(torch.bfloat16).float() - x).detach())
    ws = [w.clone().requires_grad_(True) for w in weights]
    d2, r2, _ = tfk.field_color_fwd_plain(p, dn, fm, ws, ladder, beta, "bfloat16")
    torch.testing.assert_close(d2, dens, rtol=0, atol=0)
    torch.testing.assert_close(r2, rgb, rtol=0, atol=0)
    ((d2 * gdens).sum() + (r2 * grgb).sum()).backward()
    for name, a, w in zip(tfk.LOSS_BLOCKS, hand, ws):
        assert a.shape == w.shape, name
        s = max(float(w.grad.abs().max()), 1e-3)
        np.testing.assert_allclose(a.numpy() / s, w.grad.numpy() / s, atol=3e-2, err_msg=name)


@pytest.mark.parametrize("embed,n_halves,R,P,n_hidden", CASES)
def test_record_views_round_trip(embed, n_halves, R, P, n_hidden):
    """K5's residuals on the card are views of per-point records (K4's
    layout: es | ec padded to a multiple of 16, h1 | h2 | c1 | dh1 | dh2 |
    dc1 of 256).  The plain residuals written through record_views land in
    their slots of the record, in the reference's shapes, and leave every
    padding column and cotangent slot zero.  field_color_heads,
    which holds K5's heads to its own residuals on the card, gives the plain
    forward's heads from its residuals."""
    cfg, _, tf, pts, dirs = _case(embed, n_halves, R, P, n_hidden, seed=R * P)
    E = 3 * cfg.n_harmonic_functions
    ep = -(-E // 16) * 16
    weights = tuple(torch.stack(b) for b in zip(*(tfk.loss_weights(f) for f in tf)))
    dn = torch.from_numpy(dirs)
    dn = dn / dn.norm(dim=-1, keepdim=True)
    dens, rgb, res = tfk.field_color_fwd_plain(torch.from_numpy(pts), dn, torch.from_numpy(tfk.fmat_of(cfg)),
                                               weights, tfk.ladder_of(cfg), cfg.softplus_beta, "bfloat16")
    # the heads read only the rounded h1 and c1: from the residuals alone, the same bits
    heads = tfk.field_color_heads(res, weights, cfg.softplus_beta)
    assert torch.equal(heads[0], dens) and torch.equal(heads[1], rgb)
    rec = torch.zeros((n_halves, R, P, 2 * ep + 6 * 256), dtype=torch.bfloat16)
    views = tfk.record_views(rec, E, n_hidden)
    assert tuple(views) == tfk.RESIDUALS
    for k in tfk.RESIDUALS:
        width = E if k in ("es", "ec") else n_hidden
        assert views[k].shape == res[k].shape == (n_halves, R, P, width), k
        views[k].copy_(res[k])
    filled = torch.zeros(rec.shape[-1], dtype=torch.bool)
    slots = dict(es=(0, E), ec=(ep, E), h1=(2 * ep, n_hidden), h2=(2 * ep + 256, n_hidden),
                 c1=(2 * ep + 512, n_hidden))
    for k, (start, width) in slots.items():
        assert torch.equal(rec[..., start:start + width], res[k]), k
        filled[start:start + width] = True
    assert not rec[..., ~filled].any()

def test_field_color_dispatch_on_cpu():
    cfg, _, tf, pts, dirs = _case("direct", 1, 3, 5, 32, seed=2)
    before = (tfk.field_color_fwd_cuda.launches, tfk.field_color_bwd_cuda.launches)
    dens, rgb = tfk.field_color(tf, torch.from_numpy(pts), torch.from_numpy(dirs), cfg)
    (dens.sum() + rgb.sum()).backward()
    # CPU tensors take the plain versions
    assert (tfk.field_color_fwd_cuda.launches, tfk.field_color_bwd_cuda.launches) == before
    w = tuple(b[None] for b in tfk.loss_weights(tf[0]))
    meta = torch.zeros((1, 3, 5, 3), device="meta")
    with pytest.raises(ValueError):
        tfk.field_color_fwd_op(meta, None, None, w, 0, 10.0, cfg.act_dtype)
    with pytest.raises(ValueError):
        tfk.field_color_bwd_op(None, None, w, None, meta[..., :1], None, None, None, 0, 10.0, cfg.act_dtype)
    # K6 reads K5's records; named residuals alone are refused
    _, _, res = tfk.field_color_fwd_plain(torch.from_numpy(pts), torch.from_numpy(dirs),
                                          torch.from_numpy(tfk.fmat_of(cfg)), w, 0, 10.0, "bfloat16")
    with pytest.raises(ValueError, match="record"):
        tfk.field_color_bwd_cuda(None, None, w, res, None, None, None, None, 0, 10.0, "bfloat16")


def test_color_weights_carry_grads_back_unpermuted():
    """Grads of the grouped ladder's permuted blocks land on the parameters'
    own rows: d(sum(block * X)) / d(param) is X mapped back."""
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=32, act_dtype="bfloat16", embed_method="grouped")
    f = tfields.NerfField(cfg).reset_parameters(torch.Generator().manual_seed(0))
    blocks = tfk.color_weights(f)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=b.shape).astype(np.float32)) for b in blocks]
    sum((b * x).sum() for b, x in zip(blocks, xs)).backward()
    inv = torch.from_numpy(np.argsort(tfk.ladder_perm(8, tfk.ladder_of(cfg))))
    g = dict(zip(tfk.LOSS_BLOCKS, xs))
    for k in ("w1s", "w1c", "wc1ds", "wc1dc"):
        g[k] = g[k][inv]
    torch.testing.assert_close(f.trunk1.weight.grad, torch.cat([g["w1s"], g["w1c"]]).T, rtol=0, atol=0)
    torch.testing.assert_close(f.color1.weight.grad, torch.cat([g["wc1h"], g["wc1ds"], g["wc1dc"]]).T,
                               rtol=0, atol=0)
    torch.testing.assert_close(f.density_layer.weight.grad, g["wd"][None], rtol=0, atol=0)
    assert all(p.grad is None for n, p in f.named_parameters() if n.startswith("feature_layer"))
