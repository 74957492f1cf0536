"""The field ops: kernels K1 (``csrc/density.cu``), K4
(``csrc/bundle_loss.cu``) and K5/K6 (``csrc/field_color.cu``), each beside
its plain version.

K1 is the counterpart of the reference's ``_dens_kernel`` /
``field_density`` / ``density_eval_fn``: embed -> trunk -> density head
for a flat list of points, forward only.  K4 is the counterpart of
``_loss_kernel`` / ``bundle_loss_grads``: the NeRF train step's field
forward, EA composite, huber loss and backward.  K5/K6 are the
counterpart of ``_fwd_kernel`` / ``_bwd_kernel`` / ``field_color``: the
field's colour forward with stored residuals and its backward, as one
``torch.autograd.Function`` (``FieldColor``).  Numerics are the kernels',
not flax's: angles are exact f32 products, every product takes bf16
operands (the embedding, the weights, the activations) with f32
accumulation, the density head is f32 on the unrounded h2.  The field's
``act_dtype`` picks K4's, K5's and K6's variant: with "bfloat16" the
backward takes sigmoid' and the density head's weight grad from the
rounded h1, h2 and c1; with "float32" (``FieldConfig()``'s default; the
``*_act32`` kernels) from the unrounded ones, which the kernels keep in a
second, f32 record.  The forward is the same in both, so K1 has one.

The host helpers (frequency matrices, the ladder's row permutation, the
weight splits) are shared by both versions.  ``density_op``,
``bundle_loss_op`` and ``field_color_fwd_op`` / ``field_color_bwd_op``
run the plain version for a CPU tensor and the kernel for a CUDA tensor.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import (
    _bf16,
    ladder_len,
    softplus_beta,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build


# the activation dtypes the field kernels have a variant for
ACT_DTYPES = ("bfloat16", "float32")


def enabled(cfg, device) -> bool:
    """Use the field kernels (K1, K4-K6) for this field?  ``fused_kernel``
    True or False forces them on or off.  Auto (None): on for a CUDA device
    when the field's products take bf16 operands (``compute_dtype``), the
    kernels' numerics, and its activations are stored in one of
    ``ACT_DTYPES``: K4-K6 run the variant of the field's ``act_dtype``, K1
    (forward only) is the same for both.  Products in float32 stay on the
    field's own path: the tensor cores' products cannot compute them."""
    flag = getattr(cfg, "fused_kernel", None)
    if flag is None:
        return (torch.device(device).type == "cuda" and getattr(cfg, "compute_dtype", None) == "bfloat16"
                and getattr(cfg, "act_dtype", None) in ACT_DTYPES)
    return bool(flag)


def _act32(act_dtype: str) -> bool:
    """Does ``act_dtype`` select the float32-activation variant?"""
    if act_dtype not in ACT_DTYPES:
        raise ValueError(f"field kernels: activation dtype {act_dtype!r} is not one of {ACT_DTYPES}")
    return act_dtype == "float32"


def _variant(name: str, act32: bool) -> str:
    """A kernel's launch name, ``_act32`` for the float32-activation
    variant: its span ``kernel.<name>`` and its key in the wrapper's
    ``by_name`` launch counts."""
    return name + "_act32" if act32 else name


def ladder_of(cfg) -> int:
    """Rung count of the embedding: 0 for "direct"."""
    if getattr(cfg, "embed_method", "direct") != "grouped":
        return 0
    return ladder_len(int(cfg.n_harmonic_functions))


def freq_matrix(n_harmonic: int, omega0: float) -> np.ndarray:
    """(3, 3H) f32 with F[d, d*H + f] = omega0 * 2^f."""
    freqs = omega0 * (2.0 ** np.arange(n_harmonic, dtype=np.float32))
    F = np.zeros((3, 3 * n_harmonic), np.float32)
    for d in range(3):
        F[d, d * n_harmonic : (d + 1) * n_harmonic] = freqs
    return F


def freq_matrix_g(n_harmonic: int, omega0: float, ladder: int) -> np.ndarray:
    """(3, 3G) base frequencies of the ladder, F[d, d*G + g] = omega0 * 2^(g*L)."""
    G = n_harmonic // ladder
    freqs = omega0 * (2.0 ** (ladder * np.arange(G, dtype=np.float32)))
    F = np.zeros((3, 3 * G), np.float32)
    for d in range(3):
        F[d, d * G : (d + 1) * G] = freqs
    return F


def ladder_perm(n_harmonic: int, ladder: int) -> np.ndarray:
    """Row permutation from the kernel's rung-major embedding columns
    (l*3G + d*G + g) to the field's d-major rows (d*H + g*L + l)."""
    G = n_harmonic // ladder
    perm = np.empty(3 * n_harmonic, np.int64)
    for l in range(ladder):
        for d in range(3):
            for g in range(G):
                perm[l * 3 * G + d * G + g] = d * n_harmonic + g * ladder + l
    return perm


def fmat_of(cfg) -> np.ndarray:
    """The kernels' frequency matrix for a field config: the ladder's base
    frequencies for the grouped embedding, every frequency for "direct"."""
    H, ladder = cfg.n_harmonic_functions, ladder_of(cfg)
    return freq_matrix_g(H, cfg.omega0, ladder) if ladder else freq_matrix(H, cfg.omega0)


def fmat_on(cfg, device) -> torch.Tensor:
    """``fmat_of(cfg)`` on ``device``, read-only and shared."""
    return _fmat_on(torch.device(device), int(cfg.n_harmonic_functions), float(cfg.omega0), ladder_of(cfg))


def ladder_perm_on(n_harmonic: int, ladder: int, device, inverse: bool = False) -> torch.Tensor:
    """``ladder_perm`` (or its inverse) on ``device``, read-only and shared."""
    return _perm_on(torch.device(device), n_harmonic, ladder, inverse)


# The field ops' host constants are copied to a device once: a copy from
# the host waits for everything queued on the device, and the NeRF step
# would pay that wait at every field call.
@functools.lru_cache(maxsize=None)
def _fmat_on(device: torch.device, n_harmonic: int, omega0: float, ladder: int) -> torch.Tensor:
    F = freq_matrix_g(n_harmonic, omega0, ladder) if ladder else freq_matrix(n_harmonic, omega0)
    return torch.from_numpy(F).to(device)


@functools.lru_cache(maxsize=None)
def _perm_on(device: torch.device, n_harmonic: int, ladder: int, inverse: bool) -> torch.Tensor:
    perm = ladder_perm(n_harmonic, ladder)
    return torch.from_numpy(np.argsort(perm) if inverse else perm).to(device)


def density_weights(field):
    """The field's density path in the kernel's layout, f32 (in, out):
    (fmat, w1s, w1c, b1, w2, b2, wd (nh,), bd (1,)); W1's rows permuted to
    the ladder's rung-major order for the grouped embedding."""
    w = dict(zip(LOSS_BLOCKS, loss_weights(field)))
    fm = fmat_on(field.cfg, w["w1s"].device)
    return (fm,) + tuple(w[k] for k in ("w1s", "w1c", "b1", "w2", "b2", "wd", "bd"))


def _embed_plain(x, fm, ladder: int):
    """(sin, cos) blocks (N, 3H): exact-product angles, rung-major ladder."""
    ang = x[:, 0:1] * fm[0:1] + x[:, 1:2] * fm[1:2] + x[:, 2:3] * fm[2:3]
    s, c = torch.sin(ang), torch.cos(ang)
    if ladder <= 1:
        return s, c
    sins, coss = [s], [c]
    for _ in range(ladder - 1):
        s, c = 2.0 * s * c, 1.0 - 2.0 * (s * s)
        sins.append(s)
        coss.append(c)
    return torch.cat(sins, -1), torch.cat(coss, -1)


def density_plain(pts: torch.Tensor, weights, ladder: int, beta: float) -> torch.Tensor:
    """Plain PyTorch version of K1: (N, 3) -> (N, 1) densities."""
    fm, w1s, w1c, b1, w2, b2, wd, bd = weights
    s, c = _embed_plain(pts, fm, ladder)
    h1 = softplus_beta(_bf16(s) @ _bf16(w1s) + _bf16(c) @ _bf16(w1c) + b1, beta)
    h2 = softplus_beta(_bf16(h1) @ _bf16(w2) + b2, beta)
    raw = softplus_beta(h2 @ wd[:, None] + bd, beta)
    return 1.0 - torch.exp(-raw)


# The tensor-core kernels (K1, K4-K6) take their product weights as bf16,
# zero-padded: every product to 256 columns (the widest hidden layer a tile
# covers), each embedding half's rows to a multiple of 16 (the mma's k).
_TILE_N = 256


def _pad_rows(E: int) -> int:
    """The embedding width padded to the tensor cores' k of 16."""
    return -(-E // 16) * 16


def _padded(blocks, row_offsets, rows: int) -> torch.Tensor:
    """bf16 (..., rows, 256) of zeros with each f32 block (..., r, c) put,
    rounded to nearest-even, at its row offset and column 0."""
    lead = blocks[0].shape[:-2]
    out = torch.zeros(lead + (rows, _TILE_N), dtype=torch.bfloat16, device=blocks[0].device)
    for b, r0 in zip(blocks, row_offsets):
        out[..., r0:r0 + b.shape[-2], :b.shape[-1]] = b
    return out


def density_cuda(pts: torch.Tensor, weights, ladder: int, beta: float) -> torch.Tensor:
    """K1 on the card: (N, 3) f32 -> (N, 1) f32 densities."""
    fm, w1s, w1c, b1, w2, b2, wd, bd = weights
    dev = pts.device
    n = pts.shape[0]
    n_base = fm.shape[1]
    emb = n_base * max(ladder, 1)
    nh = b1.shape[0]
    f32 = torch.float32
    cuda_build.check(pts, "pts", f32, (None, 3), dev)
    cuda_build.check(fm, "fmat", f32, (3, n_base), dev)
    for name, t, shape in (("w1s", w1s, (emb, nh)), ("w1c", w1c, (emb, nh)), ("b1", b1, (nh,)),
                           ("w2", w2, (nh, nh)), ("b2", b2, (nh,)), ("wd", wd, (nh,)), ("bd", bd, (1,))):
        cuda_build.check(t, name, f32, shape, dev)
    if nh > _TILE_N:
        raise ValueError(f"density kernel covers at most {_TILE_N} hidden units, got {nh}")
    # W1 and W2 enter the products as bf16 values, as in the TPU kernel
    ep = _pad_rows(emb)
    w1 = _padded((w1s, w1c), (0, ep), 2 * ep)
    w2p = _padded((w2,), (0,), _TILE_N)
    out = torch.empty((n, 1), dtype=f32, device=dev)
    if n:
        with cuda_build.launch(density_cuda, "density", dev):
            cuda_build.kernels().density(
                pts.data_ptr(), n, fm.data_ptr(), n_base, ladder, ep, w1.data_ptr(), w2p.data_ptr(), b1.data_ptr(),
                b2.data_ptr(), wd.data_ptr(), bd.data_ptr(), nh, float(beta), out.data_ptr(),
                cuda_build.stream_ptr(dev),
            )
    return out


cuda_build.reset(density_cuda)


def density_op(pts: torch.Tensor, weights, ladder: int, beta: float) -> torch.Tensor:
    """K1 for a CUDA tensor, its plain version for a CPU tensor."""
    if pts.device.type == "cuda":
        return density_cuda(pts, weights, ladder, beta)
    if pts.device.type == "cpu":
        return density_plain(pts, weights, ladder, beta)
    raise ValueError(f"density op: unsupported device {pts.device}")


@torch.no_grad()
def field_density(field, pts: torch.Tensor) -> torch.Tensor:
    """Densities (..., 1) f32 of a NerfField at points of any leading shape,
    with the kernel's numerics.  Forward only."""
    lead = pts.shape[:-1]
    flat = pts.reshape(-1, 3).to(torch.float32).contiguous()
    out = density_op(flat, density_weights(field), ladder_of(field.cfg), float(field.cfg.softplus_beta))
    return out.reshape(*lead, 1)


def density_eval_fn(field):
    """``pts -> densities (..., 1)``: the kernel path when ``enabled`` for
    the field's config and device, the field's own density otherwise."""
    cfg = getattr(field, "cfg", None)
    device = next(field.parameters()).device if cfg is not None else None
    if cfg is None or not enabled(cfg, device):
        return field.density
    return lambda pts: field_density(field, pts)


# ------------------------------------------------- K4: the bundle loss
#
# Counterpart of the reference's _loss_kernel / _make_loss_op /
# bundle_loss_grads: field forward, closed-form EA composite, huber colour
# and silhouette loss and the hand-written backward into the 13 weight
# grads, for H independent fields (the two half-sequence NeRFs) in one
# launch.  Shapes: pts (H, R, P, 3), unit view dirs (H, R, 3), targets
# (H, R, 8) = [col(3), sil, valid, 0, 0, 0]; each weight block carries the
# leading H.  Returns (13 grads with leading H, loss (H, 2) = [ce_sum,
# se_sum], EA weights (H, R, P) or None).

LOSS_BLOCKS = ("w1s", "w1c", "b1", "w2", "b2", "wd", "bd", "wc1h", "wc1ds", "wc1dc", "bc1", "wc2", "bc2")
# the blocks that enter products as bf16 (the density head stays f32)
_BF16_BLOCKS = frozenset({"w1s", "w1c", "w2", "wc1h", "wc1ds", "wc1dc", "wc2"})
# blocks whose rows are embedding columns: permuted for the grouped ladder
_EMBED_ROW_BLOCKS = frozenset({"w1s", "w1c", "wc1ds", "wc1dc"})


def color_weights(field):
    """The field's 13 blocks in the kernels' layout, f32, (in, out):
    w1s, w1c (3H, nh); b1 (nh,); w2 (nh, nh); b2 (nh,); wd (nh,); bd (1,);
    wc1h (nh, nh); wc1ds, wc1dc (3H, nh); bc1 (nh,); wc2 (nh, 3); bc2 (3,).
    For the grouped embedding the rows of w1s, w1c, wc1ds and wc1dc are
    permuted to the ladder's rung-major order.  Built from the parameters
    with differentiable ops (transposes, slices, ``index_select``), so
    autograd carries grads of the blocks back to each parameter, unpermuted."""
    cfg = field.cfg
    H, nh = cfg.n_harmonic_functions, cfg.n_hidden
    E = 3 * H
    w1 = field.trunk1.weight.T
    wc1 = field.color1.weight.T
    blocks = dict(
        w1s=w1[:E], w1c=w1[E:], b1=field.trunk1.bias,
        w2=field.trunk2.weight.T, b2=field.trunk2.bias,
        wd=field.density_layer.weight[0], bd=field.density_layer.bias,
        wc1h=wc1[:nh], wc1ds=wc1[nh:nh + E], wc1dc=wc1[nh + E:], bc1=field.color1.bias,
        wc2=field.color2.weight.T, bc2=field.color2.bias,
    )
    ladder = ladder_of(cfg)
    if ladder:
        perm = ladder_perm_on(H, ladder, w1.device)
        for k in _EMBED_ROW_BLOCKS:
            blocks[k] = blocks[k].index_select(0, perm)
    return tuple(blocks[k] for k in LOSS_BLOCKS)


def loss_weights(field):
    """``color_weights`` detached and contiguous, for the kernels that
    take their grads as outputs (K4) or read only densities (K1)."""
    return tuple(b.detach().contiguous() for b in color_weights(field))


def _sig_from_act(h: torch.Tensor, beta: float) -> torch.Tensor:
    """sigmoid(beta x) recovered from h = softplus_beta(x)."""
    return 1.0 - torch.exp(-beta * h)


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _density_head(h1b, weights, beta: float):
    """(h2, raw) from the rounded h1 (nH, N, nh): h2 = softplus(h1b W2 +
    b2), raw = softplus(h2 . wd + bd) on the unrounded h2, in f32."""
    w2, b2, wd, bd = weights[3], weights[4], weights[5], weights[6]
    h2 = softplus_beta(h1b @ _bf16(w2) + b2[:, None], beta)
    return h2, softplus_beta(h2 @ wd[..., None] + bd[:, None], beta)


def _color_head(c1b, weights):
    """rgb = sigmoid(c1b Wc2 + bc2) from the rounded c1 (nH, N, nh)."""
    return torch.sigmoid(c1b @ _bf16(weights[11]) + weights[12][:, None])


def _field_forward(pts, dirs, fmat, weights, ladder: int, beta: float):
    """The plain field forward of K4 and K5, with the TPU kernels' rounding
    points: pts (nH, R, P, 3), unit dirs (nH, R, 3).  Returns its
    intermediates by name, flat over (R, P) points: the products' rounded
    activations (h1b, h2b, c1b) and the unrounded ones (h1, h2, c1), which
    the float32-activation variant stores.  The same at either activation
    dtype."""
    w1s, w1c, b1, wc1h, wc1ds, wc1dc, bc1 = (weights[i] for i in (0, 1, 2, 7, 8, 9, 10))
    nH, R, P, _ = pts.shape
    N = R * P
    bf = _bf16
    s, c = _embed_plain(pts.reshape(-1, 3), fmat, ladder)
    es, ec = bf(s).reshape(nH, N, -1), bf(c).reshape(nH, N, -1)
    h1 = softplus_beta(es @ bf(w1s) + ec @ bf(w1c) + b1[:, None], beta)
    h1b = bf(h1)
    h2, raw = _density_head(h1b, weights, beta)                                    # raw (nH, N, 1)
    h2b = bf(h2)
    ds, dc = _embed_plain(dirs.reshape(-1, 3), fmat, ladder)
    dsb, dcb = bf(ds).reshape(nH, R, -1), bf(dc).reshape(nH, R, -1)
    dpart = dsb @ bf(wc1ds) + dcb @ bf(wc1dc) + bc1[:, None]                       # (nH, R, C), once per ray
    c1 = softplus_beta((h2b @ bf(wc1h)).reshape(nH, R, P, -1) + dpart[:, :, None], beta)
    c1b = bf(c1).reshape(nH, N, -1)
    rgb = _color_head(c1b, weights)                                                # (nH, N, 3)
    return SimpleNamespace(es=es, ec=ec, h1b=h1b, h2b=h2b, raw=raw, dsb=dsb, dcb=dcb, c1b=c1b, rgb=rgb, h1=h1, h2=h2,
                           c1=c1.reshape(nH, N, -1))


def _field_backward(f, du, grgb, weights, R: int, P: int, beta: float, act_dtype: str):
    """The reference's _grad_math in plain PyTorch: the 13 weight grads
    (leading nH) from the activations ``f`` (as ``_field_forward`` names
    them), the density head's pre-activation cotangent du (nH, N, 1) and
    the rgb cotangent grgb (nH, N, 3).  Every product operand is bf16, and
    every cotangent is rounded to bf16 where it enters a product; sigmoid'
    and the density head's weight grad read the activations as stored in
    ``act_dtype``: rounded to bf16 ("bfloat16"), or unrounded ("float32");
    a ray's ddpart is summed in f32 and rounded once."""
    w2, wd, wc1h, wc2 = weights[3], weights[5], weights[7], weights[11]
    nH = du.shape[0]
    bf = _bf16
    h1, h2, c1 = (f.h1, f.h2, f.c1) if _act32(act_dtype) else (f.h1b, f.h2b, f.c1b)
    dc2p = grgb * f.rgb * (1.0 - f.rgb)
    dc2pb = bf(dc2p)
    dwc2 = _t(f.c1b) @ dc2pb
    dbc2 = dc2p.sum(1)
    dc1p = (dc2pb @ _t(bf(wc2))) * _sig_from_act(c1, beta)
    dc1pb = bf(dc1p)
    dwc1h = _t(f.h2b) @ dc1pb
    dbc1 = dc1p.sum(1)
    ddpart = bf(dc1p.reshape(nH, R, P, -1).sum(2))                                # (nH, R, C)
    dwc1ds = _t(f.dsb) @ ddpart
    dwc1dc = _t(f.dcb) @ ddpart
    dwd = (_t(h2) @ du)[..., 0]
    dbd = du.sum(1)
    dh2p = (dc1pb @ _t(bf(wc1h)) + du @ wd[:, None, :]) * _sig_from_act(h2, beta)
    dh2pb = bf(dh2p)
    dw2 = _t(f.h1b) @ dh2pb
    db2 = dh2p.sum(1)
    dh1p = (dh2pb @ _t(bf(w2))) * _sig_from_act(h1, beta)
    dh1pb = bf(dh1p)
    return (_t(f.es) @ dh1pb, _t(f.ec) @ dh1pb, dh1p.sum(1), dw2, db2, dwd, dbd, dwc1h, dwc1ds, dwc1dc, dbc1,
            dwc2, dbc2)


def _bundle_forward(pts, dirs, tgt, fmat, weights, ladder: int, beta: float, hs: float):
    """The plain K4 forward: field, closed-form composite and loss, with
    the kernel's rounding points.  Returns its intermediates by name."""
    nH, R, P, _ = pts.shape
    f = _field_forward(pts, dirs, fmat, weights, ladder, beta)

    # ---- closed-form composite and loss
    rawr = f.raw.reshape(nH, R, P)
    Q = torch.cumsum(rawr, -1)
    A = torch.exp(rawr - Q)                      # exp(-exclusive prefix)
    w = (1.0 - torch.exp(-rawr)) * A
    rgbr = f.rgb.reshape(nH, R, P, 3)
    feat = (w[..., None] * rgbr).sum(2)                                           # (nH, R, 3)
    eS = torch.exp(-rawr.sum(-1, keepdim=True))
    opac = 1.0 - eS
    col, sil, v = tgt[..., 0:3], tgt[..., 3:4], tgt[..., 4:5]
    dcol = feat - col
    rc = torch.sqrt(1.0 + dcol * dcol / (hs * hs))
    dsil = opac - sil
    rs = torch.sqrt(1.0 + dsil * dsil / (hs * hs))
    loss = torch.stack([((rc - 1.0) * hs * v).sum((1, 2)) / 3.0, ((rs - 1.0) * hs * v).sum((1, 2))], -1)
    return SimpleNamespace(field=f, A=A, w=w, eS=eS, v=v, dcol=dcol, rc=rc, dsil=dsil, rs=rs, loss=loss)


def bundle_loss_plain(pts, dirs, tgt, fmat, weights, ladder: int, beta: float, hs: float, scale: float,
                      want_weights: bool, act_dtype: str):
    """Plain PyTorch version of K4: one expression per line of the
    reference kernel's forward, composite, loss and hand backward, with
    its rounding points (bf16 operands of every product but the density
    head's, f32 accumulation; the backward reads the activations as stored
    in ``act_dtype``, rounded to bf16 or unrounded)."""
    nH, R, P, _ = pts.shape
    N = R * P
    b = _bundle_forward(pts, dirs, tgt, fmat, weights, ladder, beta, hs)
    f, A, w, v = b.field, b.A, b.w, b.v
    rgbr = f.rgb.reshape(nH, R, P, 3)

    # ---- backward: loss -> (du, grgb), then through the field
    gf = (scale / 3.0) * v * b.dcol / (hs * b.rc)                                 # (nH, R, 3)
    gO = scale * v * b.dsil / (hs * b.rs)                                         # (nH, R, 1)
    gw = (gf[:, :, None, :] * rgbr).sum(-1)                                       # (nH, R, P)
    grgb = (w[..., None] * gf[:, :, None, :]).reshape(nH, N, 3)
    T = gw * w
    rev_excl = T.sum(-1, keepdim=True) - torch.cumsum(T, -1)
    g_raw = gw * (A - w) - rev_excl + gO * b.eS
    du = g_raw.reshape(nH, N, 1) * _sig_from_act(f.raw, beta)
    grads = _field_backward(f, du, grgb, weights, R, P, beta, act_dtype)
    return grads, b.loss, (w if want_weights else None)


def _block_shapes(E: int, nh: int) -> dict:
    """Each of the 13 blocks' shape (without the leading half axis), in
    LOSS_BLOCKS order."""
    return dict(w1s=(E, nh), w1c=(E, nh), b1=(nh,), w2=(nh, nh), b2=(nh,), wd=(nh,), bd=(1,), wc1h=(nh, nh),
                wc1ds=(E, nh), wc1dc=(E, nh), bc1=(nh,), wc2=(nh, 3), bc2=(3,))


def _kernel_weights(weights, shapes: dict, nH: int, dev) -> dict:
    """Check the 13 blocks (leading nH) for a kernel and return them by
    name, the product operands rounded to bf16 values (stored as f32), as
    the TPU kernels read them."""
    if shapes["b1"][0] > 256:
        raise ValueError(f"the field kernels cover at most 256 hidden units, got {shapes['b1'][0]}")
    wts = {}
    for name, t in zip(LOSS_BLOCKS, weights):
        cuda_build.check(t, name, torch.float32, (nH,) + shapes[name], dev)
        wts[name] = _bf16(t) if name in _BF16_BLOCKS else t
    return wts


def _resident_blocks(dev, R: int, nH: int) -> int:
    """One resident wave of a persistent tile kernel: a block per SM (its
    shared memory allows no more at full width), split over the halves."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(R, n_sm // nH))


def _dw_splits(dev, nH: int, n_tiles: int, n_rows: int) -> int:
    """Slices of the points per weight-grad tile in the contraction kernel
    of K4 and K6: one resident wave of its two blocks per SM, at least 64
    rows a slice."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(2 * n_sm // (nH * n_tiles), -(-n_rows // 64)))


def _named_views(flat, names, shapes: dict) -> dict:
    """Views (leading nH) of the blocks ``names``, in that order, of a
    kernel's flat (nH, >= G) output."""
    out, off = {}, 0
    for name in names:
        n = math.prod(shapes[name])
        out[name] = flat[:, off:off + n].reshape(flat.shape[:1] + shapes[name])
        off += n
    return out


def _mma_operands(wts: dict, ep: int, names) -> list:
    """The tensor-core products' bf16 weights by name, zero-padded to 256
    columns: w1 = [W1s; W1c] (2 ep rows), w2, wc1h, and the backward's
    transposes wc1ht, w2t (256 rows)."""
    sq = lambda t: _padded((t,), (0,), _TILE_N)  # noqa: E731
    make = dict(w1=lambda: _padded((wts["w1s"], wts["w1c"]), (0, ep), 2 * ep), w2=lambda: sq(wts["w2"]),
                wc1h=lambda: sq(wts["wc1h"]), wc1ht=lambda: sq(_t(wts["wc1h"])), w2t=lambda: sq(_t(wts["w2"])))
    return [make[k]() for k in names]


def _act_record(lead: tuple, dev) -> torch.Tensor:
    """The float32-activation variant's per-point record of f32
    activations, h1 | h2 | c1 (256 each, as csrc/field_tc.cuh's ACT_W), for
    points of shape ``lead``."""
    return torch.empty(lead + (3 * _TILE_N,), dtype=torch.float32, device=dev)


def _ptr(t) -> int:
    """A tensor's device pointer, 0 for None (a kernel's null)."""
    return 0 if t is None else t.data_ptr()


# The weight grads of K4 and K6: the matrix grads (from the contraction
# kernel) and the vector grads, then K4's (ce_sum, se_sum) (from per-block
# slices), each flat
_MAT_GRADS = ("w1s", "w1c", "w2", "wc1h", "wc1ds", "wc1dc")
_VEC_GRADS = ("b1", "b2", "wd", "bd", "bc1", "wc2", "bc2")


def _grad_buffers(ext, dev, nH: int, R: int, P: int, E: int, nh: int) -> SimpleNamespace:
    """Scratch and outputs of a grad kernel (K4, K6): the per-block vector
    slices and the per-ray records of a persistent grid over the rays, the
    contraction kernel's slices, and the flat vector and matrix grads."""
    f32, ep = torch.float32, _pad_rows(E)
    n_blocks = _resident_blocks(dev, R, nH)
    n_splits = _dw_splits(dev, nH, ext.field_dw_tiles(E, nh), R * P)
    V, G = ext.field_vec_width(nh), 4 * E * nh + 2 * nh * nh
    return SimpleNamespace(
        n_blocks=n_blocks, n_splits=n_splits,
        vwork=torch.empty((nH, n_blocks, V), dtype=f32, device=dev),
        rrec=torch.empty((nH, R, ext.field_ray_rec_width(ep)), dtype=torch.bfloat16, device=dev),
        part=torch.empty((nH, n_splits, G), dtype=f32, device=dev),
        vec=torch.empty((nH, V), dtype=f32, device=dev), mats=torch.empty((nH, G), dtype=f32, device=dev))


def _grads_of(buf, shapes: dict) -> tuple:
    """The 13 grads (LOSS_BLOCKS order) as views of a grad kernel's outputs."""
    g = {**_named_views(buf.mats, _MAT_GRADS, shapes), **_named_views(buf.vec, _VEC_GRADS, shapes)}
    return tuple(g[k] for k in LOSS_BLOCKS)


def bundle_loss_cuda(pts, dirs, tgt, fmat, weights, ladder: int, beta: float, hs: float, scale: float,
                     want_weights: bool, act_dtype: str):
    """K4 on the card (``csrc/bundle_loss.cu``): the same contract as
    ``bundle_loss_plain``.  A persistent grid walks the rays and writes
    each point's activations and cotangents to a bf16 workspace (with
    ``act_dtype`` "float32", ``bundle_loss_act32_kernel``: its f32
    activations to a second one); a second kernel contracts them into the
    weight grads over fixed slices of the points, and small kernels sum the
    slices in a fixed order, so two launches give bit-identical grads.
    Launches count on ``bundle_loss_cuda``, each variant's under its launch
    name (``by_name``: "bundle_loss", "bundle_loss_act32")."""
    act32 = _act32(act_dtype)
    dev = pts.device
    f32 = torch.float32
    nH, R, P, _ = pts.shape
    n_base = fmat.shape[1]
    E = n_base * max(ladder, 1)
    nh = weights[2].shape[-1]
    cuda_build.check(pts, "pts", f32, (nH, R, P, 3), dev)
    cuda_build.check(dirs, "dirs", f32, (nH, R, 3), dev)
    cuda_build.check(tgt, "tgt", f32, (nH, R, 8), dev)
    cuda_build.check(fmat, "fmat", f32, (3, n_base), dev)
    shapes = _block_shapes(E, nh)
    wts = _kernel_weights(weights, shapes, nH, dev)
    w_out = torch.empty((nH, R, P), dtype=f32, device=dev) if want_weights else None
    if not (R and P):
        zero = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)  # noqa: E731
        buf = SimpleNamespace(mats=zero(nH, 4 * E * nh + 2 * nh * nh), vec=zero(nH, 7 * nh + 6))
    else:
        ep = _pad_rows(E)
        ext = cuda_build.kernels()
        buf = _grad_buffers(ext, dev, nH, R, P, E, nh)
        rec = torch.empty((nH, R * P, ext.field_rec_width(ep)), dtype=torch.bfloat16, device=dev)
        act = _act_record((nH, R * P), dev) if act32 else None
        mats = _mma_operands(wts, ep, ("w1", "w2", "wc1h", "wc1ht", "w2t"))
        with cuda_build.launch(bundle_loss_cuda, _variant("bundle_loss", act32), dev):
            ext.bundle_loss(
                pts.data_ptr(), dirs.data_ptr(), tgt.data_ptr(), nH, R, P, fmat.data_ptr(), n_base, ladder, ep,
                *(m.data_ptr() for m in mats),
                *(wts[k].data_ptr() for k in ("b1", "b2", "wd", "bd", "wc1ds", "wc1dc", "bc1", "wc2", "bc2")),
                nh, float(beta), float(hs), float(hs * hs), float(scale), float(scale / 3.0), buf.vwork.data_ptr(),
                buf.n_blocks, rec.data_ptr(), buf.rrec.data_ptr(), _ptr(act), buf.part.data_ptr(), buf.n_splits,
                buf.vec.data_ptr(), buf.mats.data_ptr(), 0 if w_out is None else w_out.data_ptr(),
                cuda_build.stream_ptr(dev),
            )
    return _grads_of(buf, shapes), buf.vec[:, -2:], w_out


cuda_build.reset(bundle_loss_cuda)


def bundle_loss_op(pts, dirs, tgt, fmat, weights, ladder: int, beta: float, hs: float, scale: float,
                   want_weights: bool, act_dtype: str):
    """K4 (the variant of ``act_dtype``) for a CUDA tensor, its plain
    version for a CPU tensor."""
    if pts.device.type == "cuda":
        return bundle_loss_cuda(pts, dirs, tgt, fmat, weights, ladder, beta, hs, scale, want_weights, act_dtype)
    if pts.device.type == "cpu":
        return bundle_loss_plain(pts, dirs, tgt, fmat, weights, ladder, beta, hs, scale, want_weights, act_dtype)
    raise ValueError(f"bundle loss op: unsupported device {pts.device}")


def _set_grads(field, grads, inv):
    """Write the 13 kernel-layout grads of one field into its parameters'
    ``.grad``: transpose to (out, in), concatenate the split blocks, undo
    the ladder's row permutation.  The frozen feature head gets none."""
    g = dict(zip(LOSS_BLOCKS, grads))
    if inv is not None:
        for k in _EMBED_ROW_BLOCKS:
            g[k] = g[k][inv]
    new = {
        field.trunk1.weight: torch.cat([g["w1s"], g["w1c"]]).T, field.trunk1.bias: g["b1"],
        field.trunk2.weight: g["w2"].T, field.trunk2.bias: g["b2"],
        field.density_layer.weight: g["wd"][None], field.density_layer.bias: g["bd"],
        field.color1.weight: torch.cat([g["wc1h"], g["wc1ds"], g["wc1dc"]]).T, field.color1.bias: g["bc1"],
        field.color2.weight: g["wc2"].T, field.color2.bias: g["bc2"],
    }
    for p, gp in new.items():
        p.grad = gp.contiguous()


def bundle_loss_grads(fields, pts, dirs, col, sil, valid, cfg, huber_scaling: float, scale: float,
                      want_weights: bool = False):
    """Field forward + EA composite + huber loss + backward for H fields in
    one K4 call (the kernel on a CUDA device, its plain version on the CPU;
    the variant of ``cfg.act_dtype``).

    ``fields``: one NerfField per half, all of config ``cfg``.  pts (H, R,
    P, 3); dirs (H, R, 3) un-normalized; col (H, R, 3); sil, valid (H, R,
    1).  ``scale`` is the cotangent of each ray's (ce + se).  Sets each
    trained parameter's ``.grad`` and returns (ce_sum (H,), se_sum (H,),
    EA weights (H, R, P) or None)."""
    ladder = ladder_of(cfg)
    dev = pts.device
    # the field's own normalization expression (NerfField.color)
    dn = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    tgt = torch.cat([col, sil, valid, torch.zeros_like(col)], -1).to(torch.float32).contiguous()
    weights = tuple(torch.stack(blocks) for blocks in zip(*(loss_weights(f) for f in fields)))
    grads, loss, w = bundle_loss_op(pts.detach().contiguous(), dn.detach().contiguous(), tgt,
                                    fmat_on(cfg, dev), weights, ladder,
                                    float(cfg.softplus_beta), float(huber_scaling), float(scale), want_weights,
                                    cfg.act_dtype)
    inv = None
    if ladder:
        inv = ladder_perm_on(cfg.n_harmonic_functions, ladder, dev, inverse=True)
    for h, f in enumerate(fields):
        _set_grads(f, [g[h] for g in grads], inv)
    return loss[:, 0], loss[:, 1], w


# ---------------------------------------- K5 / K6: the split colour pair
#
# Counterpart of the reference's _fwd_kernel / _bwd_kernel / _make_op /
# field_color: the field's colour forward with its residuals stored (K5),
# and the backward from them into the 13 weight grads (K6), bound as one
# autograd.Function.  Shapes as K4's: pts (H, R, P, 3), unit view dirs
# (H, R, 3), each weight block with a leading H.  The residuals are the
# activations h1, h2, c1 (H, R, P, nh) in the field's ``act_dtype`` (bf16
# or f32) and the bf16 embedding es, ec (H, R, P, E), E in the kernels'
# (rung-major) column order.  On the card they are views of K4's per-point
# record (``record_views``), which K6 fills with the cotangents and
# contracts; with f32 activations h1, h2, c1 are views of the f32 record
# ("acts") instead.

RESIDUALS = ("h1", "h2", "c1", "es", "ec")


def _rec_width(ep: int) -> int:
    """bf16 values of a point's record: es | ec (ep each) | h1 | h2 | c1 |
    dh1 | dh2 | dc1 (256 each), as csrc/field_tc.cuh lays it out."""
    return 2 * ep + 6 * _TILE_N


def _record_kernels(ep: int):
    """The built kernels, after checking that they lay the record out as
    ``_rec_width`` does."""
    ext = cuda_build.kernels()
    if ext.field_rec_width(ep) != _rec_width(ep):
        raise ValueError(f"field record: the kernels' width {ext.field_rec_width(ep)}, not {_rec_width(ep)}")
    return ext


def record_views(rec: torch.Tensor, E: int, nh: int) -> dict:
    """The named residuals (``RESIDUALS``) of records rec (..., rec width)
    as views: es, ec (..., E), h1, h2, c1 (..., nh)."""
    ep = _pad_rows(E)
    start = dict(h1=2 * ep, h2=2 * ep + _TILE_N, c1=2 * ep + 2 * _TILE_N, es=0, ec=ep)
    return {k: rec[..., start[k]:start[k] + (E if k in ("es", "ec") else nh)] for k in RESIDUALS}


def field_color_fwd_plain(pts, dirs, fmat, weights, ladder: int, beta: float, act_dtype: str):
    """Plain PyTorch version of K5: (dens (H, R, P, 1), rgb (H, R, P, 3),
    residuals {name: (H, R, P, .)}), with the TPU kernel's rounding points.
    The residuals are bf16 but h1, h2 and c1, which are stored in
    ``act_dtype`` (with "float32" unrounded)."""
    nH, R, P, _ = pts.shape
    f = _field_forward(pts, dirs, fmat, weights, ladder, beta)
    act = torch.float32 if _act32(act_dtype) else torch.bfloat16
    acts = dict(h1=f.h1, h2=f.h2, c1=f.c1) if act == torch.float32 else dict(h1=f.h1b, h2=f.h2b, c1=f.c1b)
    res = {**acts, "es": f.es, "ec": f.ec}
    res = {k: v.reshape(nH, R, P, -1).to(act if k in acts else torch.bfloat16) for k, v in res.items()}
    dens = (1.0 - torch.exp(-f.raw)).reshape(nH, R, P, 1)
    return dens, f.rgb.reshape(nH, R, P, 3), res


def field_color_heads(res, weights, beta: float):
    """dens (H, R, P, 1) and rgb (H, R, P, 3) of the plain K5's heads from
    given residuals: the density head reads only h1, the colour head only
    c1, both rounded (bf16 or f32 residuals).  Holds a kernel's heads to
    its own residuals."""
    h1, c1 = res["h1"], res["c1"]
    nH, lead = h1.shape[0], h1.shape[:-1]
    _, raw = _density_head(_bf16(h1.float()).reshape(nH, -1, h1.shape[-1]), weights, beta)
    rgb = _color_head(_bf16(c1.float()).reshape(nH, -1, c1.shape[-1]), weights)
    return (1.0 - torch.exp(-raw)).reshape(lead + (1,)), rgb.reshape(lead + (3,))


def field_color_bwd_plain(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder: int, beta: float,
                          act_dtype: str):
    """Plain PyTorch version of K6: the 13 weight grads (leading H) from
    K5's residuals and outputs and the cotangents gdens (H, R, P, 1), grgb
    (H, R, P, 3).  The density head's sigmoid' comes from the stored dens,
    the direction embedding is recomputed per ray; the products take the
    activations rounded to bf16, sigmoid' and dwd the stored ones (in
    ``act_dtype``)."""
    nH, R, P, _ = dens.shape
    N = R * P
    ds, dc = _embed_plain(dirs.reshape(-1, 3), fmat, ladder)
    acts = {k: res[k].to(torch.float32).reshape(nH, N, -1) for k in RESIDUALS}
    f = SimpleNamespace(h1b=_bf16(acts["h1"]), h2b=_bf16(acts["h2"]), c1b=_bf16(acts["c1"]), h1=acts["h1"],
                        h2=acts["h2"], c1=acts["c1"], es=acts["es"], ec=acts["ec"],
                        dsb=_bf16(ds).reshape(nH, R, -1), dcb=_bf16(dc).reshape(nH, R, -1),
                        rgb=rgb.reshape(nH, N, 3))
    d = dens.reshape(nH, N, 1)
    du = gdens.reshape(nH, N, 1) * (1.0 - d) * (1.0 - torch.exp(beta * torch.log1p(-d)))
    return _field_backward(f, du, grgb.reshape(nH, N, 3), weights, R, P, beta, act_dtype)


def field_color_fwd_cuda(pts, dirs, fmat, weights, ladder: int, beta: float, act_dtype: str):
    """K5 on the card (``csrc/field_color.cu``): the contract of
    ``field_color_fwd_plain``, the residuals as views of the points'
    records, which the dict also holds under "record" (and with
    ``act_dtype`` "float32", ``field_color_fwd_act32_kernel``, the f32 one
    under "acts") for K6.  A persistent grid whose blocks walk whole rays.
    Launches count on ``field_color_fwd_cuda``, by variant in ``by_name``."""
    act32 = _act32(act_dtype)
    dev = pts.device
    f32 = torch.float32
    nH, R, P, _ = pts.shape
    n_base = fmat.shape[1]
    E = n_base * max(ladder, 1)
    nh = weights[2].shape[-1]
    cuda_build.check(pts, "pts", f32, (nH, R, P, 3), dev)
    cuda_build.check(dirs, "dirs", f32, (nH, R, 3), dev)
    cuda_build.check(fmat, "fmat", f32, (3, n_base), dev)
    wts = _kernel_weights(weights, _block_shapes(E, nh), nH, dev)
    ep = _pad_rows(E)
    dens = torch.empty((nH, R, P, 1), dtype=f32, device=dev)
    rgb = torch.empty((nH, R, P, 3), dtype=f32, device=dev)
    rec = torch.empty((nH, R, P, _rec_width(ep)), dtype=torch.bfloat16, device=dev)
    act = _act_record((nH, R, P), dev) if act32 else None
    if R and P:
        ext = _record_kernels(ep)
        mats = _mma_operands(wts, ep, ("w1", "w2", "wc1h"))
        with cuda_build.launch(field_color_fwd_cuda, _variant("field_color_fwd", act32), dev):
            ext.field_color_fwd(
                pts.data_ptr(), dirs.data_ptr(), nH, R, P, fmat.data_ptr(), n_base, ladder, ep,
                *(m.data_ptr() for m in mats),
                *(wts[k].data_ptr() for k in ("b1", "b2", "wd", "bd", "wc1ds", "wc1dc", "bc1", "wc2", "bc2")),
                nh, float(beta), rec.data_ptr(), _ptr(act), dens.data_ptr(), rgb.data_ptr(),
                _resident_blocks(dev, R, nH), cuda_build.stream_ptr(dev),
            )
    res = {**record_views(rec, E, nh), "record": rec}
    if act32:
        res.update({k: act[..., i * _TILE_N:i * _TILE_N + nh] for i, k in enumerate(("h1", "h2", "c1"))}, acts=act)
    return dens, rgb, res


cuda_build.reset(field_color_fwd_cuda)


def field_color_bwd_cuda(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder: int, beta: float,
                         act_dtype: str):
    """K6 on the card (``csrc/field_color.cu``): the contract of
    ``field_color_bwd_plain``.  It reads the residuals from K5's records
    (``res["record"]``, and with ``act_dtype`` "float32" ``res["acts"]``,
    which it requires) and writes each point's cotangents into them.  A
    persistent grid walks whole rays, each block adding the vector grads
    into its own f32 slice; a contraction kernel computes the matrix grads
    over fixed slices of the points, and small kernels sum the slices in a
    fixed order: two launches give bit-identical grads.  Launches count on
    ``field_color_bwd_cuda``, by variant in ``by_name``."""
    act32 = _act32(act_dtype)
    for key in ("record", "acts") if act32 else ("record",):
        if key not in res:
            raise ValueError(f"field colour backward: K6 reads K5's records, res[{key!r}] is missing")
    dev = dens.device
    f32 = torch.float32
    nH, R, P, _ = dens.shape
    n_base = fmat.shape[1]
    E = n_base * max(ladder, 1)
    nh = weights[2].shape[-1]
    ep = _pad_rows(E)
    cuda_build.check(dirs, "dirs", f32, (nH, R, 3), dev)
    cuda_build.check(fmat, "fmat", f32, (3, n_base), dev)
    for name, t, shape in (("dens", dens, 1), ("rgb", rgb, 3), ("gdens", gdens, 1), ("grgb", grgb, 3)):
        cuda_build.check(t, name, f32, (nH, R, P, shape), dev)
    rec = res["record"]
    cuda_build.check(rec, "record", torch.bfloat16, (nH, R, P, _rec_width(ep)), dev)
    act = res["acts"] if act32 else None
    if act32:
        cuda_build.check(act, "acts", f32, (nH, R, P, 3 * _TILE_N), dev)
    shapes = _block_shapes(E, nh)
    wts = _kernel_weights(weights, shapes, nH, dev)
    if not (R and P):
        zero = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)  # noqa: E731
        return _grads_of(SimpleNamespace(mats=zero(nH, 4 * E * nh + 2 * nh * nh), vec=zero(nH, 7 * nh + 6)), shapes)
    ext = _record_kernels(ep)
    buf = _grad_buffers(ext, dev, nH, R, P, E, nh)
    mats = _mma_operands(wts, ep, ("wc1ht", "w2t"))
    with cuda_build.launch(field_color_bwd_cuda, _variant("field_color_bwd", act32), dev):
        ext.field_color_bwd(
            dirs.data_ptr(), nH, R, P, fmat.data_ptr(), n_base, ladder, ep,
            *(m.data_ptr() for m in mats), wts["wd"].data_ptr(),
            wts["wc2"].data_ptr(), nh, float(beta), rec.data_ptr(), _ptr(act), dens.data_ptr(), rgb.data_ptr(),
            gdens.data_ptr(), grgb.data_ptr(), buf.vwork.data_ptr(), buf.n_blocks, buf.rrec.data_ptr(),
            buf.part.data_ptr(), buf.n_splits, buf.vec.data_ptr(), buf.mats.data_ptr(), cuda_build.stream_ptr(dev),
        )
    return _grads_of(buf, shapes)


cuda_build.reset(field_color_bwd_cuda)


def field_color_fwd_op(pts, dirs, fmat, weights, ladder: int, beta: float, act_dtype: str):
    """K5 (the variant of ``act_dtype``) for a CUDA tensor, its plain
    version for a CPU tensor."""
    if pts.device.type == "cuda":
        return field_color_fwd_cuda(pts, dirs, fmat, weights, ladder, beta, act_dtype)
    if pts.device.type == "cpu":
        return field_color_fwd_plain(pts, dirs, fmat, weights, ladder, beta, act_dtype)
    raise ValueError(f"field colour op: unsupported device {pts.device}")


def field_color_bwd_op(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder: int, beta: float,
                       act_dtype: str):
    """K6 (the variant of ``act_dtype``) for a CUDA tensor, its plain
    version for a CPU tensor."""
    if dens.device.type == "cuda":
        return field_color_bwd_cuda(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder, beta, act_dtype)
    if dens.device.type == "cpu":
        return field_color_bwd_plain(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder, beta, act_dtype)
    raise ValueError(f"field colour op: unsupported device {dens.device}")


class FieldColor(torch.autograd.Function):
    """(pts, unit dirs, fmat, ladder, beta, act_dtype, *13 blocks) ->
    (dens, rgb): K5 forward, residuals saved, K6 backward into the 13
    blocks.  No gradient flows to the points or directions (the reference's
    custom VJP returns zeros for them)."""

    @staticmethod
    def forward(ctx, pts, dirs, fmat, ladder, beta, act_dtype, *weights):
        dens, rgb, res = field_color_fwd_op(pts, dirs, fmat, weights, ladder, beta, act_dtype)
        # on the card K6 reads only the records (the named residuals are
        # views of them); the plain version's named residuals otherwise
        if "record" in res:
            res = {k: res[k] for k in ("record", "acts") if k in res}
        ctx.save_for_backward(dirs, fmat, dens, rgb, *res.values(), *weights)
        ctx.res_names, ctx.ladder, ctx.beta, ctx.act_dtype = tuple(res), ladder, beta, act_dtype
        return dens, rgb

    @staticmethod
    def backward(ctx, gdens, grgb):
        dirs, fmat, dens, rgb, *rest = ctx.saved_tensors
        n = len(ctx.res_names)
        res = dict(zip(ctx.res_names, rest[:n]))
        grads = field_color_bwd_op(dirs, fmat, tuple(rest[n:]), res, dens, rgb, gdens.contiguous(),
                                   grgb.contiguous(), ctx.ladder, ctx.beta, ctx.act_dtype)
        return (None, None, None, None, None, None) + tuple(grads)


def field_color(fields, pts, dirs, cfg):
    """Densities (H, R, P, 1) and rgb (H, R, P, 3) of H NerfFields of config
    ``cfg`` at pts (H, R, P, 3) with per-ray view dirs (H, R, 3), through
    K5 (the kernel for CUDA tensors, its plain version for CPU ones; the
    variant of ``cfg.act_dtype``); the backward runs K6 into each
    field's parameters.  Points and directions carry no gradient."""
    # the field's own normalization expression (NerfField.color)
    dn = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    weights = tuple(torch.stack(blocks) for blocks in zip(*(color_weights(f) for f in fields)))
    fm = fmat_on(cfg, pts.device)
    return FieldColor.apply(pts.detach().contiguous(), dn.detach().contiguous(), fm, ladder_of(cfg),
                            float(cfg.softplus_beta), cfg.act_dtype, *weights)
