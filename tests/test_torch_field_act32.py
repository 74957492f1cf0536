"""The field kernels' float32-activation variant on the CPU: the plain
twins of K4 and of K5 / K6 at ``act_dtype="float32"``, ``FieldConfig()``'s
default, against the autograd of the kernels' own forward and against the
benchmark's plain reference (``portbench/reference``); the bf16 twins
against the expressions they computed before the variant existed; the
NeRF step at ``FieldConfig()`` against the reference's ``nerf.train``; K1
against the float32 twin's densities; and ``field_kernel.enabled`` over
devices, product and activation dtypes and the ``fused_kernel`` flag.

The kernels' numerics (``ops/field_kernel.py``): every product takes bf16
operands with f32 accumulation, and its cotangent is rounded to bf16 where
it enters the backward's products; the density head reads the unrounded
h2.  With f32 activations nothing else is rounded, so the float32 twin is
the exact gradient of that forward (``_kernel_forward`` below,
differentiated by autograd) up to f32 sums in another order.  The bf16 twin takes sigmoid'
and the density head's weight grad from activations rounded to bf16, which
parts it from that gradient by the rounding: the cases hold both sides of
that line.
"""

import itertools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
    FieldConfig,
    NerfTrainConfig,
    RenderConfig,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField, _bf16, softplus_beta
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer
from portbench.harness import compare, scene, weights
from portbench.reference import nerf as ref_nerf
from portbench.reference.field import Field, is_head
from portbench.reference.precision import Precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_harmonic_functions=8, n_hidden=48)
WIDTHS = {"small": SMALL, "256": dict(n_harmonic_functions=8, n_hidden=256)}
SIG_LEAVES = ("trunk1.weight", "trunk2.weight", "color1.weight", "density_layer.weight")


def _bf(x):
    return x.to(torch.bfloat16).to(torch.float32)


class _Product(torch.autograd.Function):
    """a @ w on bf16 operands with f32 accumulation; the backward rounds the
    cotangent to bf16 before both of its products, as the kernels do."""

    @staticmethod
    def forward(ctx, a, w):
        ab, wb = _bf(a), _bf(w)
        ctx.save_for_backward(ab, wb)
        return ab @ wb

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        gb = _bf(g)
        return gb @ wb.transpose(-1, -2), ab.transpose(-1, -2) @ gb


def _kernel_forward(fields, pts, dirs, cfg):
    """dens (H, R, P), rgb (H, R, P, 3) of the kernels' forward, built from
    each field's differentiable blocks (``color_weights``)."""
    beta, ladder = float(cfg.softplus_beta), fk.ladder_of(cfg)
    fm = torch.from_numpy(fk.fmat_of(cfg))
    mm = _Product.apply
    H, R, P, _ = pts.shape
    dn = dirs / dirs.norm(dim=-1, keepdim=True)
    dens, rgb = [], []
    for h, f in enumerate(fields):
        w = dict(zip(fk.LOSS_BLOCKS, fk.color_weights(f)))
        s, c = fk._embed_plain(pts[h].reshape(-1, 3), fm, ladder)
        h1 = softplus_beta(mm(s, w["w1s"]) + mm(c, w["w1c"]) + w["b1"], beta)
        h2 = softplus_beta(mm(h1, w["w2"]) + w["b2"], beta)
        raw = softplus_beta(h2 @ w["wd"][:, None] + w["bd"], beta)
        ds, dc = fk._embed_plain(dn[h], fm, ladder)
        dpart = mm(ds, w["wc1ds"]) + mm(dc, w["wc1dc"]) + w["bc1"]
        c1 = softplus_beta(mm(h2, w["wc1h"]).reshape(R, P, -1) + dpart[:, None], beta)
        rgb.append(torch.sigmoid(mm(c1.reshape(R * P, -1), w["wc2"]) + w["bc2"]).reshape(R, P, 3))
        dens.append((1.0 - torch.exp(-raw)).reshape(R, P))
    return torch.stack(dens), torch.stack(rgb)


def _bundle_loss(dens, rgb, col, sil, hs: float, scale: float):
    """K4's loss of densities and colours: the EA composite, huber colour
    (mean over channels) and silhouette, summed over rays, times ``scale``."""
    img, opac, _ = ref_nerf.composite(dens, rgb, eps=0.0)
    return scale * (ref_nerf.huber(img, col, hs).mean(-1).sum() + ref_nerf.huber(opac, sil, hs).sum())


def _rays(H, R, P, seed):
    """Rays through the object's box from a sphere of radius 4, sorted
    depths, random colour and silhouette targets."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((H, R, 3), generator=g)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.1 * torch.randn((H, R, 3), generator=g)
    z = torch.sort(2.0 + 4.0 * torch.rand((H, R, P), generator=g), -1).values
    col = torch.rand((H, R, 3), generator=g)
    sil = (torch.rand((H, R, 1), generator=g) > 0.5).float()
    return o[:, :, None] + d[:, :, None] * z[..., None], d, col, sil


def _fields(cfg, H, seed):
    """H fields of ``cfg`` with the benchmark's random weights (density head
    drawn 8x the init's spread, so the composite sees a non-empty field)."""
    fc = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    g = torch.Generator().manual_seed(seed)
    params = [weights.field_params(g, fc, 8.0) for _ in range(H)]
    fields = []
    for p in params:
        f = NerfField(cfg)
        f.load_state_dict(p)
        fields.append(f)
    return fc, params, fields


def _init_fields(cfg, H, seed):
    """H fields of ``cfg`` at the field's own init, density bias 0, so the
    densities spread over (0, 1) (as the kernels' card tests draw them)."""
    fields = []
    for h in range(H):
        f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(seed + h))
        torch.nn.init.zeros_(f.density_layer.bias)
        fields.append(f)
    return fields


def _grads(fields):
    return {(h, n): p.grad.detach().clone() for h, f in enumerate(fields) for n, p in f.named_parameters()
            if p.grad is not None}


def _twin_grads(path, cfg, fields, pts, d, col, sil, hs, scale):
    """The parameters' grads of one K4 call (``k4``) or of FieldColor's K5 /
    K6 under the same loss (``k5k6``), through the plain twins of
    ``cfg.act_dtype``."""
    for f in fields:
        f.zero_grad(set_to_none=True)
    if path == "k4":
        fk.bundle_loss_grads(fields, pts, d, col, sil, torch.ones_like(sil), cfg, hs, scale)
    else:
        with torch.enable_grad():
            dens, rgb = fk.field_color(fields, pts, d, cfg)
            _bundle_loss(dens[..., 0], rgb, col, sil, hs, scale).backward()
    return _grads(fields)


def _autograd_grads(cfg, fields, pts, d, col, sil, hs, scale):
    for f in fields:
        f.zero_grad(set_to_none=True)
    with torch.enable_grad():
        dens, rgb = _kernel_forward(fields, pts, d, cfg)
        _bundle_loss(dens, rgb, col, sil, hs, scale).backward()
    return _grads(fields)


def _leaf_gaps(got, want):
    """Each leaf's max abs gap over the leaf's max |g|."""
    return {k: float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-12) for k in want}


@pytest.mark.parametrize("path", ["k4", "k5k6"])
@pytest.mark.parametrize("embed", ["direct", "grouped"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_act32_twins_are_the_kernel_forwards_gradient(path, embed, width):
    """The float32 twins against autograd through the kernels' forward on
    seeded random weights, at 48 and at 256 hidden units: f32 sums in
    another order (the hand composite backward, sigmoid' as 1 - exp(-beta
    h) against autograd's sigmoid(beta x)) keep every leaf within 2e-4 of
    its max |g|, bf16 cotangent roundings that flip included.  The bf16 twin
    on the same inputs parts from it on the sigmoid'-carrying leaves by the
    activations' bf16 rounding (2^-9 relative in each sigmoid' factor): its
    worst such leaf is at least 3x the float32 twin's."""
    H, R, P, hs = 2, 24, 16, 0.1
    scale = 500.0 / R
    pts, d, col, sil = _rays(H, R, P, 7)
    gaps = {}
    for act in ("float32", "bfloat16"):
        cfg = FieldConfig(**WIDTHS[width], embed_method=embed, act_dtype=act, fused_kernel=True)
        fields = _init_fields(cfg, H, 11)
        want = _autograd_grads(cfg, fields, pts, d, col, sil, hs, scale)
        got = _twin_grads(path, cfg, fields, pts, d, col, sil, hs, scale)
        assert set(got) == set(want)
        gaps[act] = _leaf_gaps(got, want)
    assert max(gaps["float32"].values()) < 2e-4, gaps["float32"]
    sig = [k for k in gaps["float32"] if k[1] in SIG_LEAVES]
    assert max(gaps["bfloat16"][k] for k in sig) > 3.0 * max(gaps["float32"][k] for k in sig), gaps


@pytest.mark.parametrize("path", ["k4", "k5k6"])
@pytest.mark.parametrize("seed", [3, 5])
def test_act32_twins_against_the_reference(path, seed):
    """The float32 twins against ``portbench/reference``'s field at the
    configuration's precision (bf16 products, f32 storage), autograd
    through its composite and huber loss.  The reference rounds each
    product's result and each bias add to bf16 (flax's ``Dense``), the
    kernels accumulate in f32: up to ~1.8e-2 of a leaf's norm at this size
    over seeds 3-5, the density head's leaves the widest; 0.04 holds it."""
    H, R, P, hs = 2, 24, 16, 0.1
    scale = 500.0 / R
    cfg = FieldConfig(**SMALL, fused_kernel=True)
    assert cfg.act_dtype == "float32"
    fc, params, fields = _fields(cfg, H, seed)
    pts, d, col, sil = _rays(H, R, P, seed)
    got = _twin_grads(path, cfg, fields, pts, d, col, sil, hs, scale)
    ref = {}
    for h, p in enumerate(params):
        cur = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        field = Field(fc, cur, Precision("bfloat16"), Precision("float32"))
        dens, rgb = field.forward(pts[h], d[h])
        _bundle_loss(dens, rgb, col[h], sil[h], hs, scale).backward()
        ref.update({(h, k): v.grad for k, v in cur.items() if not is_head(k)})
    assert set(got) == set(ref)
    gap, at = compare.worst_leaf_gap(got, ref)
    assert gap < 0.04, (gap, at)


def test_k1_is_the_float32_twins_density():
    """K1 (forward only, one kernel for either activation dtype): its plain
    version's densities are the float32 twin's (K5's plain forward at
    ``act_dtype`` "float32") on the same points, and the bf16 twin's: the
    forward does not depend on the activations' storage."""
    cfg = FieldConfig(**SMALL, fused_kernel=True)
    _, _, (field,) = _fields(cfg, 1, 2)
    pts, d, _, _ = _rays(1, 7, 43, 3)
    k1 = fk.density_plain(pts.reshape(-1, 3), fk.density_weights(field), fk.ladder_of(cfg),
                          float(cfg.softplus_beta))
    weights = tuple(b[None] for b in fk.loss_weights(field))
    fm = torch.from_numpy(fk.fmat_of(cfg))
    dn = d / d.norm(dim=-1, keepdim=True)
    for act in fk.ACT_DTYPES:
        dens, _, _ = fk.field_color_fwd_plain(pts, dn, fm, weights, fk.ladder_of(cfg), float(cfg.softplus_beta), act)
        torch.testing.assert_close(dens.reshape(-1, 1), k1, rtol=0, atol=1e-6)
    assert fk.density_eval_fn(field) != field.density


@pytest.mark.parametrize("device,compute,act,flag", list(itertools.product(
    ("cpu", "cuda"), ("bfloat16", "float32"), ("bfloat16", "float32"), (None, True, False))))
def test_enabled_over_devices_dtypes_and_flag(device, compute, act, flag):
    """Forced (``fused_kernel`` True / False) whatever the field; auto on a
    CUDA device for bf16 products, with either activation dtype (each has
    its variant), and never for float32 products or on the CPU."""
    cfg = FieldConfig(compute_dtype=compute, act_dtype=act, fused_kernel=flag)
    want = flag if flag is not None else (device == "cuda" and compute == "bfloat16")
    assert fk.enabled(cfg, device) is want


def test_act_dtype_outside_the_variants_is_refused():
    cfg = FieldConfig(**SMALL)
    _, _, (field,) = _fields(cfg, 1, 4)
    pts, d, col, sil = _rays(1, 3, 5, 4)
    with pytest.raises(ValueError, match="activation dtype"):
        fk.bundle_loss_grads([field], pts, d, col, sil, torch.ones_like(sil),
                             FieldConfig(**SMALL, act_dtype="float16"), 0.1, 1.0)


# ------------------------------------ the bf16 twins as they computed before


def _old_field_backward(f, du, grgb, weights, R, P, beta):
    """``_field_backward`` as it read before the float32 variant: every
    sigmoid' and dwd from the rounded activations."""
    w2, wd, wc1h, wc2 = weights[3], weights[5], weights[7], weights[11]
    nH, bf, t = du.shape[0], _bf16, fk._t
    dc2p = grgb * f.rgb * (1.0 - f.rgb)
    dc2pb = bf(dc2p)
    dwc2 = t(f.c1b) @ dc2pb
    dbc2 = dc2p.sum(1)
    dc1p = (dc2pb @ t(bf(wc2))) * fk._sig_from_act(f.c1b, beta)
    dc1pb = bf(dc1p)
    dwc1h = t(f.h2b) @ dc1pb
    dbc1 = dc1p.sum(1)
    ddpart = bf(dc1p.reshape(nH, R, P, -1).sum(2))
    dwc1ds = t(f.dsb) @ ddpart
    dwc1dc = t(f.dcb) @ ddpart
    dwd = (t(f.h2b) @ du)[..., 0]
    dbd = du.sum(1)
    dh2p = (dc1pb @ t(bf(wc1h)) + du @ wd[:, None, :]) * fk._sig_from_act(f.h2b, beta)
    dh2pb = bf(dh2p)
    dw2 = t(f.h1b) @ dh2pb
    db2 = dh2p.sum(1)
    dh1p = (dh2pb @ t(bf(w2))) * fk._sig_from_act(f.h1b, beta)
    dh1pb = bf(dh1p)
    return (t(f.es) @ dh1pb, t(f.ec) @ dh1pb, dh1p.sum(1), dw2, db2, dwd, dbd, dwc1h, dwc1ds, dwc1dc, dbc1,
            dwc2, dbc2)


def _old_bundle_loss_plain(pts, dirs, tgt, fmat, weights, ladder, beta, hs, scale):
    """``bundle_loss_plain`` as it read before the float32 variant."""
    nH, R, P, _ = pts.shape
    b = fk._bundle_forward(pts, dirs, tgt, fmat, weights, ladder, beta, hs)
    f, A, w, v = b.field, b.A, b.w, b.v
    rgbr = f.rgb.reshape(nH, R, P, 3)
    gf = (scale / 3.0) * v * b.dcol / (hs * b.rc)
    gO = scale * v * b.dsil / (hs * b.rs)
    gw = (gf[:, :, None, :] * rgbr).sum(-1)
    grgb = (w[..., None] * gf[:, :, None, :]).reshape(nH, R * P, 3)
    T = gw * w
    rev_excl = T.sum(-1, keepdim=True) - torch.cumsum(T, -1)
    g_raw = gw * (A - w) - rev_excl + gO * b.eS
    du = g_raw.reshape(nH, R * P, 1) * fk._sig_from_act(f.raw, beta)
    return _old_field_backward(f, du, grgb, weights, R, P, beta), b.loss, w


def _old_field_color(pts, dirs, fmat, weights, ladder, beta, gdens, grgb):
    """K5's and K6's plain versions as they read before the float32
    variant: the residuals, dens, rgb and the 13 grads."""
    nH, R, P, _ = pts.shape
    N = R * P
    f = fk._field_forward(pts, dirs, fmat, weights, ladder, beta)
    res = dict(h1=f.h1b, h2=f.h2b, c1=f.c1b, es=f.es, ec=f.ec)
    res = {k: v.reshape(nH, R, P, -1).to(torch.bfloat16) for k, v in res.items()}
    dens, rgb = (1.0 - torch.exp(-f.raw)).reshape(nH, R, P, 1), f.rgb.reshape(nH, R, P, 3)
    ds, dc = fk._embed_plain(dirs.reshape(-1, 3), fmat, ladder)
    acts = {k: res[k].to(torch.float32).reshape(nH, N, -1) for k in fk.RESIDUALS}
    g = SimpleNamespace(h1b=acts["h1"], h2b=acts["h2"], c1b=acts["c1"], es=acts["es"], ec=acts["ec"],
                        dsb=_bf16(ds).reshape(nH, R, -1), dcb=_bf16(dc).reshape(nH, R, -1), rgb=rgb.reshape(nH, N, 3))
    d = dens.reshape(nH, N, 1)
    du = gdens.reshape(nH, N, 1) * (1.0 - d) * (1.0 - torch.exp(beta * torch.log1p(-d)))
    return res, dens, rgb, _old_field_backward(g, du, grgb.reshape(nH, N, 3), weights, R, P, beta)


@pytest.mark.parametrize("embed,R,P", [("direct", 9, 77), ("grouped", 5, 16)])
def test_bf16_twins_compute_what_they_did(embed, R, P):
    """At ``act_dtype`` "bfloat16" K4's, K5's and K6's plain versions give
    the bits they gave before the float32 variant existed."""
    cfg = FieldConfig(**SMALL, embed_method=embed, act_dtype="bfloat16", fused_kernel=True)
    fields = _init_fields(cfg, 2, 13)
    pts, d, col, sil = _rays(2, R, P, 13)
    dn = d / d.norm(dim=-1, keepdim=True)
    valid = torch.ones_like(sil)
    valid[:, ::3] = 0.0
    tgt = torch.cat([col, sil, valid, torch.zeros_like(col)], -1)
    weights = tuple(torch.stack(b) for b in zip(*(fk.loss_weights(f) for f in fields)))
    fm, ladder, beta = torch.from_numpy(fk.fmat_of(cfg)), fk.ladder_of(cfg), float(cfg.softplus_beta)
    args = (pts, dn, tgt, fm, weights, ladder, beta, 0.1, 500.0 / R)
    old = _old_bundle_loss_plain(*args)
    new = fk.bundle_loss_plain(*args, True, "bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(new[0], old[0]))
    assert torch.equal(new[1], old[1]) and torch.equal(new[2], old[2])
    g = torch.Generator().manual_seed(R)
    gdens, grgb = torch.randn((2, R, P, 1), generator=g), torch.randn((2, R, P, 3), generator=g)
    res_o, dens_o, rgb_o, grads_o = _old_field_color(pts, dn, fm, weights, ladder, beta, gdens, grgb)
    dens, rgb, res = fk.field_color_fwd_plain(pts, dn, fm, weights, ladder, beta, "bfloat16")
    assert torch.equal(dens, dens_o) and torch.equal(rgb, rgb_o)
    assert list(res) == list(res_o) and all(torch.equal(res[k], res_o[k]) for k in res)
    grads = fk.field_color_bwd_plain(dn, fm, weights, res, dens, rgb, gdens, grgb, ladder, beta, "bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_o))


TRAFFIC = dict(halves=2, views_per_half=6, image_size=32, cams_per_step=2, rays_per_image=12, n_pts_coarse=8,
               n_pts_fine=16, add_input_samples=True, lr=1e-3, warmup_steps=500, loss_scale=500.0,
               huber_scaling=0.1, depth_margin=2.0)


def _train_steps(cfg, steps: int, seed: int, ray_chunk: int = nerf_trainer.RAY_CHUNK):
    """``steps`` of the program's train_step at ``cfg`` and the reference's
    ``nerf.train`` from the same weights, views and draws (the reference's
    fine passes on the program's depths), as the benchmark's check holds
    them: each step's loss, the first grads, the parameters after."""
    tr = TRAFFIC
    fc = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    g = torch.Generator().manual_seed(seed)
    H, V, S, B, n = tr["halves"], tr["views_per_half"], tr["image_size"], tr["cams_per_step"], tr["rays_per_image"]
    halves = [scene.views(g, V, S) for _ in range(H)]
    data = {k: torch.stack([h[k] for h in halves]) for k in halves[0]}
    tz = data["t"][..., 2].abs()
    lo, hi = float(tz.min()) - tr["depth_margin"], float(tz.max()) + tr["depth_margin"]
    init = [{p: weights.field_params(g, fc, 8.0) for p in ("coarse", "fine")} for _ in range(H)]
    render = RenderConfig(n_rays_per_image=n, n_pts_coarse=tr["n_pts_coarse"], n_pts_fine=tr["n_pts_fine"])
    train = NerfTrainConfig(lr=tr["lr"], warmup_steps=tr["warmup_steps"], batch_size=B, loss_scale=tr["loss_scale"],
                            huber_scaling=tr["huber_scaling"])
    states = [nerf_trainer.init_state(cfg, train, init_params=(h["coarse"], h["fine"]), device="cpu") for h in init]
    opt = nerf_trainer.make_optimizer(train)
    cams = cam_lib.camera_from_bop(data["R"], data["t"], data["K"], S)
    hh = torch.arange(H)[:, None]
    rng = np.random.default_rng(seed)
    batches, draws, losses, depths = [], [], [], []
    resample = nerf_trainer.raymarch.importance_resample
    for k in range(steps):
        idx = torch.as_tensor(np.stack([rng.choice(V, B, replace=False) for _ in range(H)]))
        cam = cam_lib.Camera(cams.R[hh, idx], cams.T[hh, idx], cams.focal[hh, idx], cams.principal[hh, idx], S)
        dr = (torch.rand((H, B, n, 2), generator=g) * 2.0 - 1.0, torch.rand((H, B, n, tr["n_pts_coarse"]), generator=g),
              torch.rand((H, B * n, tr["n_pts_fine"]), generator=g) * (1.0 - 1e-6))
        seen = []
        nerf_trainer.raymarch.importance_resample = lambda *a, **kw: seen.append(resample(*a, **kw)) or seen[-1]
        try:
            states, loss, _ = nerf_trainer.train_step(states, cam, data["images"][hh, idx], data["sils"][hh, idx], opt,
                                                      render, train, lo, hi, draws=dr, ray_chunk=ray_chunk)
        finally:
            nerf_trainer.raymarch.importance_resample = resample
        if k == 0:
            first = {(h, p, nm): m.clone() / (1 - nerf_trainer.Adam.b1) for h, st in enumerate(states)
                     for (p, nm), m in zip([(p, nm) for p, f in (("coarse", st.coarse), ("fine", st.fine))
                                            for nm, _ in nerf_trainer.trainable(f)], st.opt.mu)}
        batches.append([{"images": data["images"][h, idx[h]], "sils": data["sils"][h, idx[h]],
                         "R": data["R"][h, idx[h]], "t": data["t"][h, idx[h]], "K": data["K"][h, idx[h]],
                         "min_depth": lo, "max_depth": hi} for h in range(H)])
        draws.append(dr)
        losses.append(loss)
        depths.append([torch.cat([z[h] for z in seen], 0) for h in range(H)])
    after = {(h, p, nm): q.detach().clone() for h, st in enumerate(states)
             for (p, nm), q in zip([(p, nm) for p, f in (("coarse", st.coarse), ("fine", st.fine))
                                    for nm, _ in nerf_trainer.trainable(f)], nerf_trainer.train_params(st))}
    prog = {"losses": torch.stack(losses), "grads": first, "params": after}
    ref = ref_nerf.train(fc, tr, init, batches, draws, (Precision("bfloat16"), Precision("float32")), depths)
    ref["init"] = {(h, p, k): v for h, half in enumerate(init) for p in half for k, v in half[p].items()}
    return prog, ref


@pytest.mark.parametrize("flag,ray_chunk,path", [
    (True, nerf_trainer.RAY_CHUNK, "k4"),            # K4's float32 twin, one call a pass
    (True, 16, "k5k6"),                              # K5 / K6's float32 twins in chunks of 16 + 8
    (None, nerf_trainer.RAY_CHUNK, "plain"),         # the field's own autograd path
])
def test_train_step_at_field_config_default_against_reference(flag, ray_chunk, path, monkeypatch):
    """Three steps of ``train_step`` at ``FieldConfig()``'s numerics (60
    harmonics cut to 8 and 256 hidden to 48 for the CPU) against the
    reference's ``nerf.train`` at bf16 products and f32 storage, held as
    the benchmark's check holds them (``compare.training_checks``); each
    step's field passes take the path named, in the float32 variant.  At
    this size the kernels' numerics (f32 accumulation against the
    reference's bf16-rounded products and bias adds) read up to loss 1.4e-3,
    grad 1.6e-2 and change 3.6e-2 over seeds 29-37, the field's own path up
    to 2e-5 / 1.7e-3 / 6.3e-4; ``siren-act32.nerf-fused``'s limits are set
    at the published widths, where the products' roundings average out
    over 256 units, so the bf16 cell's wider limits hold here."""
    calls = []
    for name in ("bundle_loss_op", "field_color_fwd_op"):
        op = getattr(fk, name)
        monkeypatch.setattr(fk, name, lambda *a, _op=op, _n=name: calls.append((_n, a[-1])) or _op(*a))
    cfg = FieldConfig(**SMALL, fused_kernel=flag)
    assert cfg.act_dtype == "float32"
    prog, ref = _train_steps(cfg, 3, 29, ray_chunk)
    want = {"k4": [("bundle_loss_op", "float32")] * 6, "k5k6": [("field_color_fwd_op", "float32")] * 12,
            "plain": []}[path]
    assert calls == want
    limits = json.load(open(os.path.join(ROOT, "portbench", "traffic", "nerf-fused.json")))["limits"]
    checks = {n: (v, limits[n]) for n, v, _ in compare.training_checks(prog, ref, limits)}
    assert all(v <= lim for v, lim in checks.values()), checks
