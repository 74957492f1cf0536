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
not flax's: angles are exact f32 products, the embedding, the bf16
weights and the stored activations are rounded to bf16 with f32
accumulation, the density head is f32 on the unrounded h2.

The host helpers (frequency matrices, the ladder's row permutation, the
weight splits) are shared by both versions.  ``density_op``,
``bundle_loss_op`` and ``field_color_fwd_op`` / ``field_color_bwd_op``
run the plain version for a CPU tensor and the kernel for a CUDA tensor.
"""

from __future__ import annotations

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


def enabled(cfg, device) -> bool:
    """Use the density kernel for this field?  Auto (``fused_kernel=None``):
    only on a CUDA device and only for a field configured for the kernel's
    numerics (bf16 matmuls and bf16 activations)."""
    flag = getattr(cfg, "fused_kernel", None)
    if flag is None:
        return (
            torch.device(device).type == "cuda"
            and getattr(cfg, "compute_dtype", None) == "bfloat16"
            and getattr(cfg, "act_dtype", None) == "bfloat16"
        )
    return bool(flag)


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


def density_weights(field):
    """The field's density path in the kernel's layout, f32 (in, out):
    (fmat, w1s, w1c, b1, w2, b2, wd (nh,), bd (1,)); W1's rows permuted to
    the ladder's rung-major order for the grouped embedding."""
    w = dict(zip(LOSS_BLOCKS, loss_weights(field)))
    fm = torch.from_numpy(fmat_of(field.cfg)).to(w["w1s"].device)
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


# The tensor-core kernels (K1, K4) take their product weights as bf16,
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


def _density_launch(pts, weights, ladder: int, beta: float, embed_only: bool) -> torch.Tensor:
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
        cuda_build.kernels().density(
            pts.data_ptr(), n, fm.data_ptr(), n_base, ladder, ep, w1.data_ptr(), w2p.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), wd.data_ptr(), bd.data_ptr(), nh, float(beta), int(embed_only), out.data_ptr(),
            cuda_build.stream_ptr(dev),
        )
    return out


def density_cuda(pts: torch.Tensor, weights, ladder: int, beta: float) -> torch.Tensor:
    """K1 on the card: (N, 3) f32 -> (N, 1) f32 densities."""
    out = _density_launch(pts, weights, ladder, beta, embed_only=False)
    if pts.shape[0]:
        density_cuda.launches += 1
    return out


def density_embed_cuda(pts: torch.Tensor, weights, ladder: int, beta: float) -> torch.Tensor:
    """K1's sin / cos embedding stage alone on the card (the kernel with its
    products skipped), to time what the full-range ``sincosf`` costs; its
    output is one embedding value a point, not a density."""
    return _density_launch(pts, weights, ladder, beta, embed_only=True)


density_cuda.launches = 0


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
        perm = torch.from_numpy(ladder_perm(H, ladder)).to(w1.device)
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


def _field_forward(pts, dirs, fmat, weights, ladder: int, beta: float):
    """The plain field forward of K4 and K5, with the TPU kernels' rounding
    points: pts (nH, R, P, 3), unit dirs (nH, R, 3).  Returns its
    intermediates by name, flat over (R, P) points."""
    w1s, w1c, b1, w2, b2, wd, bd, wc1h, wc1ds, wc1dc, bc1, wc2, bc2 = weights
    nH, R, P, _ = pts.shape
    N = R * P
    bf = _bf16
    s, c = _embed_plain(pts.reshape(-1, 3), fmat, ladder)
    es, ec = bf(s).reshape(nH, N, -1), bf(c).reshape(nH, N, -1)
    h1 = softplus_beta(es @ bf(w1s) + ec @ bf(w1c) + b1[:, None], beta)
    h1b = bf(h1)
    h2 = softplus_beta(h1b @ bf(w2) + b2[:, None], beta)
    h2b = bf(h2)
    raw = softplus_beta(h2 @ wd[..., None] + bd[:, None], beta)                  # (nH, N, 1), unrounded h2
    ds, dc = _embed_plain(dirs.reshape(-1, 3), fmat, ladder)
    dsb, dcb = bf(ds).reshape(nH, R, -1), bf(dc).reshape(nH, R, -1)
    dpart = dsb @ bf(wc1ds) + dcb @ bf(wc1dc) + bc1[:, None]                       # (nH, R, C), once per ray
    c1 = softplus_beta((h2b @ bf(wc1h)).reshape(nH, R, P, -1) + dpart[:, :, None], beta)
    c1b = bf(c1).reshape(nH, N, -1)
    rgb = torch.sigmoid(c1b @ bf(wc2) + bc2[:, None])                              # (nH, N, 3)
    return SimpleNamespace(es=es, ec=ec, h1b=h1b, h2b=h2b, raw=raw, dsb=dsb, dcb=dcb, c1b=c1b, rgb=rgb)


def _field_backward(f, du, grgb, weights, R: int, P: int, beta: float):
    """The reference's _grad_math in plain PyTorch: the 13 weight grads
    (leading nH) from the stored activations ``f`` (as ``_field_forward``
    names them), the density head's pre-activation cotangent du (nH, N, 1)
    and the rgb cotangent grgb (nH, N, 3).  Every product operand is bf16;
    sigmoid' comes from the rounded activations; a ray's ddpart is summed
    in f32 and rounded once."""
    w2, wd, wc1h, wc2 = weights[3], weights[5], weights[7], weights[11]
    nH = du.shape[0]
    bf = _bf16
    dc2p = grgb * f.rgb * (1.0 - f.rgb)
    dc2pb = bf(dc2p)
    dwc2 = _t(f.c1b) @ dc2pb
    dbc2 = dc2p.sum(1)
    dc1p = (dc2pb @ _t(bf(wc2))) * _sig_from_act(f.c1b, beta)
    dc1pb = bf(dc1p)
    dwc1h = _t(f.h2b) @ dc1pb
    dbc1 = dc1p.sum(1)
    ddpart = bf(dc1p.reshape(nH, R, P, -1).sum(2))                                # (nH, R, C)
    dwc1ds = _t(f.dsb) @ ddpart
    dwc1dc = _t(f.dcb) @ ddpart
    dwd = (_t(f.h2b) @ du)[..., 0]
    dbd = du.sum(1)
    dh2p = (dc1pb @ _t(bf(wc1h)) + du @ wd[:, None, :]) * _sig_from_act(f.h2b, beta)
    dh2pb = bf(dh2p)
    dw2 = _t(f.h1b) @ dh2pb
    db2 = dh2p.sum(1)
    dh1p = (dh2pb @ _t(bf(w2))) * _sig_from_act(f.h1b, beta)
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
                      want_weights: bool):
    """Plain PyTorch version of K4: one expression per line of the
    reference kernel's forward, composite, loss and hand backward, with
    its rounding points (bf16 operands of every product but the density
    head's, f32 accumulation; the backward reads the rounded activations)."""
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
    grads = _field_backward(f, du, grgb, weights, R, P, beta)
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
    """One resident wave of a grad-accumulating kernel: a block per SM (its
    shared memory allows no more at full width), split over the halves."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(R, n_sm // nH))


def _dw_splits(dev, nH: int, n_tiles: int, n_rows: int) -> int:
    """Slices of the points per weight-grad tile in K4's contraction
    kernel: one resident wave of its two blocks per SM, at least 64 rows a
    slice."""
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


# K4's outputs: the matrix grads (from its contraction kernel) and the
# vector grads then (ce_sum, se_sum) (from per-block slices), each flat
_K4_MATS = ("w1s", "w1c", "w2", "wc1h", "wc1ds", "wc1dc")
_K4_VECS = ("b1", "b2", "wd", "bd", "bc1", "wc2", "bc2")


def bundle_loss_cuda(pts, dirs, tgt, fmat, weights, ladder: int, beta: float, hs: float, scale: float,
                     want_weights: bool):
    """K4 on the card (``csrc/bundle_loss.cu``): the same contract as
    ``bundle_loss_plain``.  A persistent grid walks the rays and writes
    each point's activations and cotangents to a bf16 workspace; a second
    kernel contracts them into the weight grads over fixed slices of the
    points, and small kernels sum the slices in a fixed order, so two
    launches give bit-identical grads."""
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
    G = 4 * E * nh + 2 * nh * nh
    if not (R and P):
        mats = torch.zeros((nH, G), dtype=f32, device=dev)
        vec = torch.zeros((nH, 7 * nh + 6), dtype=f32, device=dev)
    else:
        # the products' operands as bf16, zero-padded; the backward's products
        # read W2 and Wc1h transposed
        ep = _pad_rows(E)
        sq = lambda t: _padded((t,), (0,), _TILE_N)  # noqa: E731
        w1 = _padded((wts["w1s"], wts["w1c"]), (0, ep), 2 * ep)
        mats_in = (w1, sq(wts["w2"]), sq(wts["wc1h"]), sq(_t(wts["wc1h"])), sq(_t(wts["w2"])))
        ext = cuda_build.kernels()
        n_blocks = _resident_blocks(dev, R, nH)
        n_splits = _dw_splits(dev, nH, ext.bundle_loss_dw_tiles(E, nh), R * P)
        V = ext.bundle_loss_vec_width(nh)
        vwork = torch.empty((nH, n_blocks, V), dtype=f32, device=dev)
        rec = torch.empty((nH, R * P, ext.bundle_loss_rec_width(ep)), dtype=torch.bfloat16, device=dev)
        rrec = torch.empty((nH, R, ext.bundle_loss_ray_rec_width(ep)), dtype=torch.bfloat16, device=dev)
        part = torch.empty((nH, n_splits, G), dtype=f32, device=dev)
        vec = torch.empty((nH, V), dtype=f32, device=dev)
        mats = torch.empty((nH, G), dtype=f32, device=dev)
        ext.bundle_loss(
            pts.data_ptr(), dirs.data_ptr(), tgt.data_ptr(), nH, R, P, fmat.data_ptr(), n_base, ladder, ep,
            *(m.data_ptr() for m in mats_in), *(wts[k].data_ptr() for k in ("b1", "b2", "wd", "bd", "wc1ds", "wc1dc",
                                                                             "bc1", "wc2", "bc2")),
            nh, float(beta), float(hs), float(hs * hs), float(scale), float(scale / 3.0), vwork.data_ptr(), n_blocks,
            rec.data_ptr(), rrec.data_ptr(), part.data_ptr(), n_splits, vec.data_ptr(), mats.data_ptr(),
            0 if w_out is None else w_out.data_ptr(), cuda_build.stream_ptr(dev),
        )
        bundle_loss_cuda.launches += 1
    g = {**_named_views(mats, _K4_MATS, shapes), **_named_views(vec, _K4_VECS, shapes)}
    return tuple(g[k] for k in LOSS_BLOCKS), vec[:, -2:], w_out


bundle_loss_cuda.launches = 0


def bundle_loss_op(pts, dirs, tgt, fmat, weights, ladder: int, beta: float, hs: float, scale: float,
                   want_weights: bool):
    """K4 for a CUDA tensor, its plain version for a CPU tensor."""
    if pts.device.type == "cuda":
        return bundle_loss_cuda(pts, dirs, tgt, fmat, weights, ladder, beta, hs, scale, want_weights)
    if pts.device.type == "cpu":
        return bundle_loss_plain(pts, dirs, tgt, fmat, weights, ladder, beta, hs, scale, want_weights)
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
    one K4 call (the kernel on a CUDA device, its plain version on the CPU).

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
                                    torch.from_numpy(fmat_of(cfg)).to(dev), weights, ladder,
                                    float(cfg.softplus_beta), float(huber_scaling), float(scale), want_weights)
    inv = None
    if ladder:
        inv = torch.from_numpy(np.argsort(ladder_perm(cfg.n_harmonic_functions, ladder))).to(dev)
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
# bf16 activations h1, h2, c1 (H, R, P, nh) and the embedding es, ec
# (H, R, P, E), E in the kernels' (rung-major) column order.

RESIDUALS = ("h1", "h2", "c1", "es", "ec")


def field_color_fwd_plain(pts, dirs, fmat, weights, ladder: int, beta: float):
    """Plain PyTorch version of K5: (dens (H, R, P, 1), rgb (H, R, P, 3),
    residuals {name: bf16 (H, R, P, .)}), with the TPU kernel's rounding
    points."""
    nH, R, P, _ = pts.shape
    f = _field_forward(pts, dirs, fmat, weights, ladder, beta)
    res = dict(h1=f.h1b, h2=f.h2b, c1=f.c1b, es=f.es, ec=f.ec)
    res = {k: v.reshape(nH, R, P, -1).to(torch.bfloat16) for k, v in res.items()}
    dens = (1.0 - torch.exp(-f.raw)).reshape(nH, R, P, 1)
    return dens, f.rgb.reshape(nH, R, P, 3), res


def field_color_bwd_plain(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder: int, beta: float):
    """Plain PyTorch version of K6: the 13 weight grads (leading H) from
    K5's residuals and outputs and the cotangents gdens (H, R, P, 1), grgb
    (H, R, P, 3).  The density head's sigmoid' comes from the stored dens,
    the direction embedding is recomputed per ray."""
    nH, R, P, _ = dens.shape
    N = R * P
    ds, dc = _embed_plain(dirs.reshape(-1, 3), fmat, ladder)
    acts = {k: res[k].to(torch.float32).reshape(nH, N, -1) for k in RESIDUALS}
    f = SimpleNamespace(h1b=acts["h1"], h2b=acts["h2"], c1b=acts["c1"], es=acts["es"], ec=acts["ec"],
                        dsb=_bf16(ds).reshape(nH, R, -1), dcb=_bf16(dc).reshape(nH, R, -1),
                        rgb=rgb.reshape(nH, N, 3))
    d = dens.reshape(nH, N, 1)
    du = gdens.reshape(nH, N, 1) * (1.0 - d) * (1.0 - torch.exp(beta * torch.log1p(-d)))
    return _field_backward(f, du, grgb.reshape(nH, N, 3), weights, R, P, beta)


def field_color_fwd_cuda(pts, dirs, fmat, weights, ladder: int, beta: float):
    """K5 on the card (``csrc/field_color.cu``): the contract of
    ``field_color_fwd_plain``.  One block per 64-point tile of a ray."""
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
    dens = torch.empty((nH, R, P, 1), dtype=f32, device=dev)
    rgb = torch.empty((nH, R, P, 3), dtype=f32, device=dev)
    res = {k: torch.empty((nH, R, P, E if k in ("es", "ec") else nh), dtype=torch.bfloat16, device=dev)
           for k in RESIDUALS}
    if R and P:
        cuda_build.kernels().field_color_fwd(
            pts.data_ptr(), dirs.data_ptr(), nH, R, P, fmat.data_ptr(), n_base, ladder,
            *(wts[k].data_ptr() for k in LOSS_BLOCKS), nh, float(beta), dens.data_ptr(), rgb.data_ptr(),
            *(res[k].data_ptr() for k in RESIDUALS), cuda_build.stream_ptr(dev),
        )
        field_color_fwd_cuda.launches += 1
    return dens, rgb, res


field_color_fwd_cuda.launches = 0


def field_color_bwd_cuda(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder: int, beta: float):
    """K6 on the card (``csrc/field_color.cu``): the contract of
    ``field_color_bwd_plain``.  A persistent grid walks whole rays, each
    block adding into its own f32 slice of a workspace, and a second small
    kernel sums the slices in a fixed order: two launches give bit-identical
    grads."""
    dev = dens.device
    f32 = torch.float32
    nH, R, P, _ = dens.shape
    n_base = fmat.shape[1]
    E = n_base * max(ladder, 1)
    nh = weights[2].shape[-1]
    cuda_build.check(dirs, "dirs", f32, (nH, R, 3), dev)
    cuda_build.check(fmat, "fmat", f32, (3, n_base), dev)
    for name, t, shape in (("dens", dens, 1), ("rgb", rgb, 3), ("gdens", gdens, 1), ("grgb", grgb, 3)):
        cuda_build.check(t, name, f32, (nH, R, P, shape), dev)
    for k in RESIDUALS:
        cuda_build.check(res[k], k, torch.bfloat16, (nH, R, P, E if k in ("es", "ec") else nh), dev)
    shapes = _block_shapes(E, nh)
    wts = _kernel_weights(weights, shapes, nH, dev)
    w2t = _t(wts["w2"]).contiguous()
    wc1ht = _t(wts["wc1h"]).contiguous()
    n_grad = sum(math.prod(s) for s in shapes.values())
    n_blocks = _resident_blocks(dev, R, nH)
    work = torch.empty((nH, n_blocks, n_grad), dtype=f32, device=dev)
    flat = torch.zeros((nH, n_grad), dtype=f32, device=dev)
    if R and P:
        cuda_build.kernels().field_color_bwd(
            dirs.data_ptr(), nH, R, P, fmat.data_ptr(), n_base, ladder, wts["wd"].data_ptr(), wts["wc2"].data_ptr(),
            w2t.data_ptr(), wc1ht.data_ptr(), nh, float(beta), *(res[k].data_ptr() for k in RESIDUALS),
            dens.data_ptr(), rgb.data_ptr(), gdens.data_ptr(), grgb.data_ptr(), work.data_ptr(), n_blocks,
            flat.data_ptr(), cuda_build.stream_ptr(dev),
        )
        field_color_bwd_cuda.launches += 1
    return tuple(_named_views(flat, LOSS_BLOCKS, shapes).values())


field_color_bwd_cuda.launches = 0


def field_color_fwd_op(pts, dirs, fmat, weights, ladder: int, beta: float):
    """K5 for a CUDA tensor, its plain version for a CPU tensor."""
    if pts.device.type == "cuda":
        return field_color_fwd_cuda(pts, dirs, fmat, weights, ladder, beta)
    if pts.device.type == "cpu":
        return field_color_fwd_plain(pts, dirs, fmat, weights, ladder, beta)
    raise ValueError(f"field colour op: unsupported device {pts.device}")


def field_color_bwd_op(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder: int, beta: float):
    """K6 for a CUDA tensor, its plain version for a CPU tensor."""
    if dens.device.type == "cuda":
        return field_color_bwd_cuda(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder, beta)
    if dens.device.type == "cpu":
        return field_color_bwd_plain(dirs, fmat, weights, res, dens, rgb, gdens, grgb, ladder, beta)
    raise ValueError(f"field colour op: unsupported device {dens.device}")


class FieldColor(torch.autograd.Function):
    """(pts, unit dirs, fmat, ladder, beta, *13 blocks) -> (dens, rgb):
    K5 forward, residuals saved, K6 backward into the 13 blocks.  No
    gradient flows to the points or directions (the reference's custom VJP
    returns zeros for them)."""

    @staticmethod
    def forward(ctx, pts, dirs, fmat, ladder, beta, *weights):
        dens, rgb, res = field_color_fwd_op(pts, dirs, fmat, weights, ladder, beta)
        ctx.save_for_backward(dirs, fmat, dens, rgb, *(res[k] for k in RESIDUALS), *weights)
        ctx.ladder, ctx.beta = ladder, beta
        return dens, rgb

    @staticmethod
    def backward(ctx, gdens, grgb):
        dirs, fmat, dens, rgb, *rest = ctx.saved_tensors
        res = dict(zip(RESIDUALS, rest[:len(RESIDUALS)]))
        grads = field_color_bwd_op(dirs, fmat, tuple(rest[len(RESIDUALS):]), res, dens, rgb, gdens.contiguous(),
                                   grgb.contiguous(), ctx.ladder, ctx.beta)
        return (None, None, None, None, None) + tuple(grads)


def field_color(fields, pts, dirs, cfg):
    """Densities (H, R, P, 1) and rgb (H, R, P, 3) of H NerfFields of config
    ``cfg`` at pts (H, R, P, 3) with per-ray view dirs (H, R, 3), through
    K5 (the kernel for CUDA tensors, its plain version for CPU ones); the
    backward runs K6 into each field's parameters.  Points and directions
    carry no gradient."""
    # the field's own normalization expression (NerfField.color)
    dn = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    weights = tuple(torch.stack(blocks) for blocks in zip(*(color_weights(f) for f in fields)))
    fm = torch.from_numpy(fmat_of(cfg)).to(pts.device)
    return FieldColor.apply(pts.detach().contiguous(), dn.detach().contiguous(), fm, ladder_of(cfg),
                            float(cfg.softplus_beta), *weights)
