"""Plain PyTorch NeRF training step of both half-sequence fields
(trainNerfFine.py 55-62, 130-137, 299, 334-335; nutil.py 157-164;
pren.py 164-165), the reference that the benchmark holds the program's
``train_step`` to.

A step of one half: Monte-Carlo rays through ``cams_per_step`` cameras
(uniform NDC xys, stratified jittered depths), the ground truth read at
the ray xys (nearest pixel), the coarse field on the stratified depths,
the emission-absorption composite ``w = density * cumprod((1 + eps) -
density)`` shifted by one, fine depths resampled from the detached coarse
weights by inverse-CDF sampling and joined with the coarse ones, the fine
field on them, and loss = loss_scale * (huber colour + huber silhouette of
both passes) / rays.  Autograd gives the grads; Adam (optax's, under a
linear warmup from 2 % of the rate) updates every parameter but the frozen
key head of both halves at once.

The random draws (xys, depth jitter, resampling uniforms) and the view
batches come from the benchmark and are handed to both sides.

A half's rays are taken in blocks (the traffic's ``ray_chunk`` rays;
``BLOCK``, the published reference's ray chunk, where it names none), each
block's share of the loss backpropagated before the next block's passes
run, as the published chunked loss does: one block's activations are alive
at a time, and each block's weight grads are rounded as a cast's cotangent
is before the blocks' are summed.
"""

from __future__ import annotations

import torch

from portbench.reference.adam import Adam, warmup_rate
from portbench.reference.field import Field, is_head

_ROT180_Z = ((-1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, 1.0))
# rays of a half whose passes run (and backpropagate) at once, where the
# traffic names no ``ray_chunk``: the published reference's ray chunk
BLOCK = 4096


def render_camera(R_bop, t_bop, K):
    """BOP (x_cam = R x + t) to the render convention x_cam = x R' + T:
    R' = R^T rot180_z, T = t * (-1, -1, 1); focal and principal point."""
    rot = torch.tensor(_ROT180_Z, dtype=torch.float32, device=R_bop.device)
    R = R_bop.transpose(-1, -2) @ rot
    T = t_bop * torch.tensor([-1.0, -1.0, 1.0], device=t_bop.device)
    return R, T, torch.stack([K[..., 0, 0], K[..., 1, 1]], -1), K[..., 0:2, 2]


def ray_directions(R, focal, principal, S: int, xys):
    """World directions (camera z = 1) through NDC xys (..., N, 2) for a
    square screen of S pixels (NDC 1 - 2 x_pix / S)."""
    f_ndc = 2.0 * focal / S
    p_ndc = 1.0 - 2.0 * principal / S
    dxy = (xys - p_ndc[..., None, :]) / f_ndc[..., None, :]
    return torch.cat([dxy, torch.ones_like(dxy[..., :1])], -1) @ R.transpose(-1, -2)


def camera_centers(R, T):
    return -(R @ T[..., None])[..., 0]


def depth_edges(lo: float, hi: float, n: int, device):
    step = torch.arange(n, dtype=torch.float32, device=device) / n
    start = torch.tensor(lo, dtype=torch.float32, device=device)
    stop = torch.tensor(hi, dtype=torch.float32, device=device)
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


def nearest_pixels(images, xys):
    """images (B, S, S, C) read at NDC xys (B, N, 2): the grid coordinate
    is -xys, pixel (g + 1) / 2 * (S - 1), rounded half to even; outside
    reads zero."""
    B, S, _, C = images.shape
    px = torch.round((-xys[..., 0] + 1.0) * 0.5 * (S - 1)).long()
    py = torch.round((-xys[..., 1] + 1.0) * 0.5 * (S - 1)).long()
    inside = (px >= 0) & (px <= S - 1) & (py >= 0) & (py <= S - 1)
    idx = py.clamp(0, S - 1) * S + px.clamp(0, S - 1)
    got = torch.gather(images.reshape(B, S * S, C), 1, idx[..., None].expand(-1, -1, C))
    return got * inside[..., None]


def composite(dens, rgb, eps: float = 1e-10):
    """(colour (..., 3), opacity (..., 1), weights (..., P))."""
    trans = torch.cumprod((1.0 + eps) - dens, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = dens * trans
    return (w[..., None] * rgb).sum(-2), 1.0 - torch.prod(1.0 - dens, -1, keepdim=True), w


def resample(lengths, w, n: int, u, add_input: bool = True):
    """Fine depths: inverse-CDF samples of the coarse weights at the bin
    midpoints (weights + 1e-5), from uniforms ``u``; joined with the coarse
    depths and sorted."""
    bins = 0.5 * (lengths[..., 1:] + lengths[..., :-1])
    wt = w[..., 1:-1] + 1e-5
    cdf = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1).contiguous()
    idx = torch.searchsorted(cdf, u.contiguous(), right=True).clamp(1, cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, idx - 1), torch.gather(cdf, -1, idx)
    b0, b1 = torch.gather(bins, -1, idx - 1), torch.gather(bins, -1, idx)
    den = torch.where(c1 - c0 < 1e-10, torch.ones_like(c1), c1 - c0)
    z = b0 + (u - c0) / den * (b1 - b0)
    if add_input:
        z = torch.cat([lengths, z], -1)
    return torch.sort(z, -1).values


def huber(x, y, s: float):
    return (torch.sqrt(torch.clamp(1.0 + (x - y) ** 2 / s**2, min=1e-4)) - 1.0) * s


def half_loss(field: Field, batch: dict, draws, tr: dict, z_fine=None):
    """(One half's loss = scale * (colour + silhouette error) / rays, the
    fine depths resampled from this pass's coarse weights), its grads
    accumulated into the parameters' ``.grad`` a block of rays (the
    traffic's ``ray_chunk``, else ``BLOCK``) at a time.  ``z_fine`` given
    (rays, points), the fine pass runs on those depths instead."""
    xys, u, u_pdf = draws
    images, sils = batch["images"], batch["sils"]
    B, S = images.shape[0], images.shape[1]
    R, T, focal, principal = render_camera(batch["R"], batch["t"], batch["K"])
    d = ray_directions(R, focal, principal, S, xys)                             # (B, n, 3)
    o = camera_centers(R, T)[:, None].expand(d.shape)
    e = depth_edges(batch["min_depth"], batch["max_depth"], tr["n_pts_coarse"], d.device)
    lengths = e[:-1] + (e[1:] - e[:-1]) * u                                     # (B, n, Pc)
    col = nearest_pixels(images, xys)
    sil = nearest_pixels(sils[..., None], xys)
    n = B * xys.shape[1]
    o, d, lengths, col, sil = (x.reshape(n, -1) for x in (o, d, lengths, col, sil))
    hs = tr["huber_scaling"]
    block = tr.get("ray_chunk", BLOCK)
    losses, owns = [], []
    for a in range(0, n, block):
        c = slice(a, a + block)
        total = 0.0
        z = lengths[c]
        for p in ("coarse", "fine"):
            dens, rgb = field[p].forward(o[c, None] + d[c, None] * z[..., None], d[c])
            img, opac, w = composite(dens, rgb)
            total = total + huber(img, col[c], hs).mean(-1).sum() + huber(opac, sil[c], hs).sum()
            if p == "coarse":
                own = resample(lengths[c], w.detach(), tr["n_pts_fine"], u_pdf[c], tr["add_input_samples"])
                z = own if z_fine is None else z_fine[c]
        loss = tr["loss_scale"] * total / n
        loss.backward()
        losses.append(loss.detach())
        owns.append(own)
    return torch.stack(losses).sum(), torch.cat(owns)


def train(cfg: dict, tr: dict, params, batches, draws, prec, fine_depths=None) -> dict:
    """The reference's first steps from ``params`` (per half, {"coarse":
    dict, "fine": dict}); ``batches[k][h]`` the step's views of half h,
    ``draws[k]`` (xys, u, u_pdf) with a leading half axis.  ``prec``:
    (compute, store) Precisions.  ``fine_depths[k][h]``, where given, are
    the depths the fine pass of step k runs on.  Returns the losses (steps,
    halves), the first step's grads and the parameters after the last
    step, each as {(half, pass, name): tensor}, and the fine depths each
    step resampled from its own coarse weights."""
    compute, store = prec
    cur = {(h, p, k): v.detach().clone().requires_grad_(True)
           for h, half in enumerate(params) for p in ("coarse", "fine") for k, v in half[p].items()}
    keys = [key for key in cur if not is_head(key[2])]
    opt = Adam([cur[k] for k in keys])
    losses, first_grads, depths = [], None, []
    for step, (views, dr) in enumerate(zip(batches, draws)):
        step_losses, step_depths = [], []
        for p in cur.values():
            p.grad = None
        for h in range(len(params)):
            field = {p: Field(cfg, {k: cur[(h, p, k)] for (hh, pp, k) in cur if hh == h and pp == p}, compute, store)
                     for p in ("coarse", "fine")}
            given = None if fine_depths is None else fine_depths[step][h]
            loss, own = half_loss(field, views[h], tuple(x[h] for x in dr), tr, given)
            step_losses.append(loss)
            step_depths.append(own)
        grads = [cur[k].grad for k in keys]
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(keys, grads)}
        opt.update(grads, warmup_rate(tr["lr"], tr["warmup_steps"], step))
        losses.append(torch.stack(step_losses))
        depths.append(step_depths)
    return {"losses": torch.stack(losses), "grads": first_grads,
            "params": {k: cur[k].detach() for k in keys}, "depths": depths}
