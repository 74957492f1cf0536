"""Plain PyTorch SurfEmb descriptor training step (trainPose.py 60-77,
208-236, 430; nutil.py 366, 385; augment.py 248-418), the reference that
the benchmark holds the program's ``pose_train_step`` to.

A step on a batch of views: the views augmented (rotation / scale /
translation by the SurfEmb crop rule, a rectangle cut and a half-plane
erosion of the mask, a smooth-noise background, colour jitter, a 3x3
Gaussian blur, ISO noise, border blackout, ImageNet normalization), the
rays' NDC xys moved with them, ``sample_size`` rays drawn a view over those
still inside, the ResNet-UNet's query map read at them (nearest pixel), the
key head at their surface points and at jittered negative points, loss =
InfoNCE(q, k, negatives) * 1e-3 + BCE(mask logit, warped mask) * 1e-3, and
Adam on the CNN and on the key head, each rate ramped over the warmup; the
rest of the field is frozen.

The views, masks, ray bank, negatives and every random draw come from the
benchmark; the sampled rays are drawn from the benchmark's generator in
the state it had before the program's step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import unet as ref_unet
from portbench.reference.adam import Adam, ramp_rate
from portbench.reference.field import Field, is_head


def pv(x, ndim: int):
    return x.reshape(x.shape[:1] + (1,) * (ndim - 1))


def mask_bbox(mask):
    S = mask.shape[-1]
    cols, rows = mask.amax(1) > 0.5, mask.amax(2) > 0.5
    idx = torch.arange(S, device=mask.device)
    x0 = torch.where(cols, idx, S).amin(1)
    x1 = torch.where(cols, idx, -1).amax(1)
    y0 = torch.where(rows, idx, S).amin(1)
    y1 = torch.where(rows, idx, -1).amax(1)
    return x0, y0, (x1 - x0 + 1).clamp_min(1), (y1 - y0 + 1).clamp_min(1)


def warp_geometry(mask, d, ac: dict):
    """(A (B, 2, 2), t (B, 2)): NDC u -> A u + t of each view's warp."""
    S = mask.shape[1]
    _, _, w, h = mask_bbox(mask)
    theta = d["rot"] * 2 * math.pi
    base = ac["crop_res"] / torch.maximum(w, h).to(torch.float32) / ac["pad"]
    scale = base * (S / ac["crop_res"]) * d["scale"]
    c, s = torch.cos(theta), torch.sin(theta)
    return scale[:, None, None] * torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2), d["trans"]


def transform_xys(xys, A, t):
    x, y = xys[..., 0], xys[..., 1]
    a = A[:, None]
    return torch.stack([x * a[..., 0, 0] + y * a[..., 0, 1], x * a[..., 1, 0] + y * a[..., 1, 1]], -1) + t[:, None]


def source_pixels(A, t, S: int):
    ii = torch.arange(S, dtype=torch.float32, device=A.device) + 0.5
    py, px = torch.meshgrid(ii, ii, indexing="ij")
    ux = (1.0 - 2.0 * px / S) - pv(t[:, 0], 3)
    uy = (1.0 - 2.0 * py / S) - pv(t[:, 1], 3)
    a, b, c, d = (pv(A[:, i, j], 3) for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    det = a * d - b * c
    return (1.0 - (ux * d - uy * b) / det) * S / 2.0, (1.0 - (uy * a - ux * c) / det) * S / 2.0


def warp(img, A, t, nearest: bool):
    """Each image (B, S, S, C) warped so the content at NDC u lands at
    A u + t: bilinear, or nearest; taps outside read zero."""
    B, S, _, C = img.shape
    px, py = source_pixels(A, t, S)
    flat = img.reshape(B, S * S, C)

    def tap(ix, iy):
        ok = (ix >= 0) & (ix < S) & (iy >= 0) & (iy < S)
        idx = (iy.clamp(0, S - 1) * S + ix.clamp(0, S - 1)).reshape(B, -1)
        got = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C)).reshape(ix.shape + (C,))
        return got * ok[..., None]

    if nearest:
        return tap(torch.floor(px).long(), torch.floor(py).long())
    x, y = px - 0.5, py - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    top = tap(x0i, y0i) * (1 - tx) + tap(x0i + 1, y0i) * tx
    bot = tap(x0i, y0i + 1) * (1 - tx) + tap(x0i + 1, y0i + 1) * tx
    return top * (1 - ty) + bot * ty


def occlude(u, mask, x0, y0, w, h):
    S = mask.shape[-1]
    nx, ny = x0 + (u[:, 0] * w).long(), y0 + (u[:, 1] * h).long()
    nw = (u[:, 2] * torch.minimum(w, 30 + (u[:, 2] * 40).long())).long()
    nh = (u[:, 3] * torch.minimum(h, 30 + (u[:, 3] * 40).long())).long()
    ii = torch.arange(S, device=mask.device)
    in_x = (ii >= nx[:, None]) & (ii < (nx + nw)[:, None])
    in_y = (ii >= ny[:, None]) & (ii < (ny + nh)[:, None])
    return torch.where(in_y[:, :, None] & in_x[:, None, :], 0.0, mask)


def line_erode(u, mask, x0, y0, w, h):
    S = mask.shape[-1]
    cx, cy = pv(x0.float() + u[:, 0] * w, 3), pv(y0.float() + u[:, 1] * h, 3)
    phi = u[:, 2] * 2 * math.pi
    ii = torch.arange(S, dtype=torch.float32, device=mask.device)
    py, px = torch.meshgrid(ii, ii, indexing="ij")
    return torch.where((px - cx) * pv(torch.cos(phi), 3) + (py - cy) * pv(torch.sin(phi), 3) > 0, 0.0, mask)


def blur3(img, sigma):
    w1 = pv(torch.exp(-0.5 / torch.clamp_min(sigma, 1e-3) ** 2), img.ndim)

    def shifted(x, k, dim):
        n = x.shape[dim]
        return x.index_select(dim, (torch.arange(n, device=x.device) + k).clamp(0, n - 1))

    def pass1(x, dim):
        return (x + w1 * (shifted(x, -1, dim) + shifted(x, 1, dim))) / (1.0 + 2.0 * w1)

    return pass1(pass1(img, 1), 2)


def augment(rgb, mask, d: dict, ac: dict):
    """(normalized rgb, warped full mask, A, t) of a batch of views."""
    S = rgb.shape[1]
    x0, y0, w, h = mask_bbox(mask)
    A, t = warp_geometry(mask, d, ac)
    m1 = occlude(d["occlude"], mask, x0, y0, w, h)
    take = (d["occlude_on"] < ac["p_occlude"]) & (m1.sum((1, 2)) > ac["min_mask_sum"])
    cut = torch.where(pv(take, 3), m1, mask)
    m2 = line_erode(d["line"], cut, x0, y0, w, h)
    take = (d["line_on"] < ac["p_line_erode"]) & (m2.sum((1, 2)) > ac["min_mask_sum"])
    cut = torch.where(pv(take, 3), m2, cut)
    rgb_w = warp(rgb, A, t, False)
    full_w = warp(mask[..., None], A, t, True)[..., 0]
    cut_w = warp(cut[..., None], A, t, True)[..., 0]
    bg = F.interpolate(d["background"].permute(0, 3, 1, 2), size=(S, S), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    bg = torch.where(pv(d["background_on"] < ac["p_background"], 4), bg, torch.zeros_like(bg))
    out = torch.where(cut_w[..., None] > 0.5, rgb_w, bg)
    jit = torch.clamp(torch.clamp(out, 0, 1) ** pv(d["gamma"], 4) * d["gain"][:, None, None] + d["bias"][:, None, None],
                      0.0, 1.0)
    out = torch.where(pv(d["jitter_on"] < ac["p_color_jitter"], 4), jit, out)
    out = torch.where(pv(d["blur_on"] < ac["p_blur"], 4), blur3(out, d["sigma"]), out)
    shot = torch.sqrt(torch.clamp(out, 0.0, 1.0) + 1e-3)
    lum = d["iso_luma"] * pv(d["iso_intensity"], 4) * 0.1 * shot.mean(-1, keepdim=True)
    noisy = torch.clamp(out + lum + d["iso_chroma"] * pv(d["iso_shift"], 4), 0.0, 1.0)
    out = torch.where(pv(d["iso_on"] < ac["p_iso_noise"], 4), noisy, out)
    dil = F.max_pool2d(cut_w[:, None], 9, 1, 4)[:, 0]
    out = torch.where(pv(d["border_on"] < ac["p_border"], 4), out * (dil > 0.5)[..., None], out)
    return ref_unet.normalize(out), full_w, A, t


def select_rays(xys, valid, n: int, generator):
    """n ray indices a view, with replacement, uniform over its valid rays
    inside the image; ray 0 where there are none."""
    w = ((xys[..., 0].abs() < 1.0) & (xys[..., 1].abs() < 1.0) & valid).to(torch.float32)
    first = torch.zeros_like(w)
    first[:, 0] = 1.0
    w = torch.where(w.sum(-1, keepdim=True) > 0, w, first)
    return torch.multinomial(w, n, replacement=True, generator=generator)


def nearest_read(maps, xys):
    """maps (B, S, S, C) at NDC xys (B, N, 2): the pixel round((1 - x) / 2 *
    (S - 1)) of each axis, zero outside."""
    B, S, _, C = maps.shape
    px = torch.round((-xys[..., 0] + 1.0) * 0.5 * (S - 1)).long()
    py = torch.round((-xys[..., 1] + 1.0) * 0.5 * (S - 1)).long()
    ok = (px >= 0) & (px <= S - 1) & (py >= 0) & (py <= S - 1)
    idx = py.clamp(0, S - 1) * S + px.clamp(0, S - 1)
    return torch.gather(maps.reshape(B, S * S, C), 1, idx[..., None].expand(-1, -1, C)) * ok[..., None]


def step_loss(field: Field, cnn: dict, uc: dict, batch: dict, d: dict, tr: dict, ac: dict, compute, gen_state):
    """(loss, nce, bce) of one step on its batch."""
    rgb, full, A, t = augment(batch["images"], batch["sils"], d["aug"], ac)
    new_xys = transform_xys(batch["xys"], A, t)
    g = torch.Generator(device=new_xys.device)
    g.set_state(gen_state)
    sel = select_rays(new_xys, batch["valid"], tr["sample_size"], g)
    sel_xys = new_xys.gather(1, sel[..., None].expand(-1, -1, 2))
    sel_pos = batch["pos_vec"].gather(1, sel[..., None].expand(-1, -1, 3))
    neg = batch["neg_pts"][d["neg_idx"]] + d["neg_jitter"] * tr["key_noise"]
    maps = ref_unet.forward(cnn, uc, rgb, compute)
    q = nearest_read(maps[..., :12], sel_xys)
    k, kn = field.keys(sel_pos), field.keys(neg)
    lg = torch.cat([(q * k).sum(-1, keepdim=True), torch.einsum("bpe,bne->bpn", q, kn)], -1)
    nce = (torch.logsumexp(lg, -1) - lg[..., 0]).mean() * tr["infonce_scale"]
    logit = maps[..., -1]
    bce = -(full * F.logsigmoid(logit) + (1.0 - full) * F.logsigmoid(-logit)).mean() * tr["mask_loss_scale"]
    return nce + bce


def train(cfg: dict, tr: dict, ac: dict, field_p: dict, cnn_p: dict, batches, draws, gen_states, prec) -> dict:
    """The reference's first steps; returns the losses, the first step's
    grads and the parameters after the last step, each leaf keyed
    ("head" | "cnn", name)."""
    compute, store = prec
    head = {k: v.detach().clone().requires_grad_(True) for k, v in field_p.items() if is_head(k)}
    frozen = {k: v for k, v in field_p.items() if not is_head(k)}
    cnn = {k: v.detach().clone().requires_grad_(True) for k, v in cnn_p.items()}
    head_opt, cnn_opt = Adam(list(head.values()), tr["head_weight_decay"]), Adam(list(cnn.values()))
    losses, first = [], None
    for step, (batch, d, gs) in enumerate(zip(batches, draws, gen_states)):
        for p in list(head.values()) + list(cnn.values()):
            p.grad = None
        field = Field(cfg["field"], {**frozen, **head}, compute, store)
        loss = step_loss(field, cnn, cfg["unet"], batch, d, tr, ac, compute, gs)
        loss.backward()
        if first is None:
            first = {**{("head", k): v.grad.detach().clone() for k, v in head.items()},
                     **{("cnn", k): v.grad.detach().clone() for k, v in cnn.items()}}
        head_opt.update([p.grad for p in head.values()], ramp_rate(tr["lr_mlp"], tr["warmup_steps"], step))
        cnn_opt.update([p.grad for p in cnn.values()], ramp_rate(tr["lr_cnn"], tr["warmup_steps"], step))
        losses.append(loss.detach())
    params = {**{("head", k): v.detach() for k, v in head.items()}, **{("cnn", k): v.detach() for k, v in cnn.items()}}
    return {"losses": torch.stack(losses), "grads": first, "params": params}
