"""NeRF training (counterpart of train/nerf_trainer.py): both half-sequence
fields at once (``train_nerf_fused``) or one field with exact resume
(``train_nerf``), and ``extract_point_cloud``.

One step per half: Monte-Carlo rays from a batch of cameras, ground truth
sampled at the ray xys, the coarse field on stratified depths, the fine
field on depths resampled from the coarse weights, loss = loss_scale *
(huber colour + huber silhouette) of both passes, then Adam with a linear
warmup over everything but the frozen feature head.  The halves share
every launch on a leading half axis (the reference gets that axis from
``vmap``).

A step with at most ``ray_chunk`` rays per half runs through K4, one
launch per pass.  A larger step, or any step where ``field_kernel.enabled``
is false (the CPU, or a field with f32 activations), is the reference's
chunked ``loss_fn``: rays in ``ray_chunk`` groups, each chunk's field
evaluated through K5/K6 (``field_kernel.field_color``) where enabled and
the field's own colour path otherwise, composited with the eps-cumprod
form, and its share of the loss backpropagated at once.

Random draws come from generators, or are passed in (``draws``), so tests
can replay the reference's ``jax.random`` streams.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import mcubes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
    FieldConfig,
    NerfTrainConfig,
    RenderConfig,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.grid_sample import sample_images_at_mc_locs
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import raymarch, renderer

# rays per half that one field evaluation covers (the reference's ray chunk)
RAY_CHUNK = 4096


class AdamState(NamedTuple):
    """Adam moments over ``train_params(state)``, in that order, and the
    number of updates taken so far."""

    count: int
    mu: list
    nu: list


class NerfTrainState(NamedTuple):
    coarse: fields.NerfField
    fine: fields.NerfField
    opt: AdamState
    step: int


def trainable(field: fields.NerfField) -> list:
    """(name, parameter) pairs that NeRF training updates: all but the
    frozen feature head (``freeze_spec``)."""
    labels = fields.freeze_spec(train_feature_head=False)(field)
    return [(n, p) for n, p in field.named_parameters() if labels[n] == "train"]


def train_params(state: NerfTrainState) -> list:
    """The trained parameters of one half: coarse field's, then fine's."""
    return [p for f in (state.coarse, state.fine) for _, p in trainable(f)]


class Adam:
    """``optax.adam`` under ``optax.linear_schedule(0.02 lr, lr, warmup)``
    (the reference's make_optimizer), applied in place.  Update k (from 0)
    uses the rate at count k and the bias corrections at count k + 1; the
    scalars are f32, as optax computes them."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: NerfTrainConfig):
        self.lr = cfg.lr
        self.warmup = cfg.warmup_steps

    def learning_rate(self, count: int) -> float:
        if self.warmup <= 0:
            return float(np.float32(self.lr))
        c = np.float32(min(max(count, 0), self.warmup))
        frac = np.float32(1) - c / np.float32(self.warmup)
        init, end = self.lr * 0.02, self.lr
        return float(np.float32(init - end) * frac + np.float32(end))

    def init(self, params) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params, grads, mu, nu, count: int) -> int:
        """One update of ``params`` from ``grads``; ``mu``/``nu`` change in
        place.  Returns the new count."""
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        c = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_mul_(upd, -self.learning_rate(count))
        torch._foreach_add_(params, upd)
        return count + 1


def make_optimizer(cfg: NerfTrainConfig) -> Adam:
    return Adam(cfg)


def init_state(field_cfg: FieldConfig, train_cfg: NerfTrainConfig, generator: torch.Generator | None = None,
               init_params=None, device=None) -> NerfTrainState:
    """Fresh coarse and fine fields from ``generator`` (coarse drawn
    first), or from ``init_params`` = (coarse, fine) state dicts, on
    ``device`` (the card unless named)."""
    device = resolve_device(device)
    pair = []
    for i in range(2):
        f = fields.NerfField(field_cfg)
        if init_params is not None:
            f.load_state_dict(init_params[i])
        else:
            f.reset_parameters(generator)
        pair.append(f.to(device))
    st = NerfTrainState(pair[0], pair[1], AdamState(0, [], []), 0)
    return st._replace(opt=make_optimizer(train_cfg).init(train_params(st)))


def depth_bounds(t_bop: np.ndarray, margin: float = 2.0):
    """min/max ray depths from the camera distances."""
    z = np.abs(np.asarray(t_bop)[:, 2])
    return float(z.min() - margin), float(z.max() + margin)


def draw(generators, n_cams: int, render_cfg: RenderConfig, device):
    """One step's draws for each half from its generator, stacked on the
    half axis: xys (H, B, n, 2) in [-1, 1), depth jitter u (H, B, n, Pc),
    resampling uniforms u_pdf (H, B*n, Pf) in [0, 1 - 1e-6)."""
    n, Pc, Pf = render_cfg.n_rays_per_image, render_cfg.n_pts_coarse, render_cfg.n_pts_fine
    out = []
    for g in generators:
        xys = torch.rand((n_cams, n, 2), generator=g, device=device) * 2.0 - 1.0
        u = torch.rand((n_cams, n, Pc), generator=g, device=device)
        u_pdf = torch.rand((n_cams * n, Pf), generator=g, device=device) * (1.0 - 1e-6)
        out.append((xys, u, u_pdf))
    return tuple(torch.stack(x) for x in zip(*out))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator seeded from (seed, step) alone, so a resumed run draws
    what the uninterrupted run drew at that step."""
    return torch.Generator(device=device).manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))


def _chunked_losses(states, o, d, lengths, col, sil, u_pdf, render_cfg, train_cfg, ray_chunk: int,
                    use_kernel: bool):
    """The reference's chunked ``loss_fn`` for every half: the rays in
    groups of ``ray_chunk`` (the last one ragged, where the reference pads
    with rows of weight 0), each group's coarse pass, resampling from its
    detached weights, fine pass and huber losses, and its share s * sum / n
    backpropagated into ``.grad`` at once, so one chunk's activations are
    alive at a time (the reference recomputes them in the backward
    instead).  The field runs through K5/K6 where ``use_kernel``, else its
    own colour path.  Returns (colour error, silhouette error), (H,) each."""
    s, hs, Pf = train_cfg.loss_scale, train_cfg.huber_scaling, render_cfg.n_pts_fine
    H, n = o.shape[:2]
    cfg = states[0].coarse.cfg
    for st in states:
        for p in train_params(st):
            p.grad = None

    def color(fields, pts, dirs):
        if use_kernel:
            return field_kernel.field_color(fields, pts, dirs, cfg)
        outs = [f(pts[h], dirs[h], "color") for h, f in enumerate(fields)]
        return torch.stack([x[0] for x in outs]), torch.stack([x[1] for x in outs])

    coarse, fine = [st.coarse for st in states], [st.fine for st in states]
    ce_tot = torch.zeros(H, device=o.device)
    se_tot = torch.zeros(H, device=o.device)
    for i0 in range(0, n, ray_chunk):
        c = slice(i0, i0 + ray_chunk)
        oc, dc, lc = o[:, c], d[:, c], lengths[:, c]
        with torch.enable_grad():
            dens_c, rgb_c = color(coarse, oc[:, :, None] + dc[:, :, None] * lc[..., None], dc)
            img_c, w_c = raymarch.composite(dens_c[..., 0], rgb_c)
            z_f = raymarch.importance_resample(lc, w_c.detach(), Pf, u=u_pdf[:, c],
                                               add_input_samples=render_cfg.add_input_samples)
            dens_f, rgb_f = color(fine, oc[:, :, None] + dc[:, :, None] * z_f[..., None], dc)
            img_f, _ = raymarch.composite(dens_f[..., 0], rgb_f)
            ce = sum(raymarch.huber(img[..., :-1], col[:, c], hs).mean(-1) for img in (img_c, img_f)).sum(-1)
            se = sum(raymarch.huber(img[..., -1:], sil[:, c], hs).mean(-1) for img in (img_c, img_f)).sum(-1)
            (s * (ce + se).sum() / n).backward()
        ce_tot += ce.detach()
        se_tot += se.detach()
    return s * ce_tot / n, s * se_tot / n


@torch.no_grad()
def train_step(states, cam: cam_lib.Camera, images, sils, opt: Adam, render_cfg: RenderConfig,
               train_cfg: NerfTrainConfig, min_depth: float, max_depth: float, draws=None, generators=None,
               ray_chunk: int = RAY_CHUNK):
    """One optimization step of every half.

    states: one NerfTrainState per half; cam: cameras with leading (H, B);
    images (H, B, S, S, 3); sils (H, B, S, S); ``draws`` (see ``draw``) or
    one generator per half.  At most ``ray_chunk`` rays per half take K4;
    more take the chunked step, whose chunk i resamples with rows
    [i * ray_chunk, (i + 1) * ray_chunk) of the draws' u_pdf.  Returns
    (new states, loss (H,), {"color", "sil"} (H,) each), all on the
    device."""
    H, B, S = images.shape[0], images.shape[1], images.shape[2]
    n_rays, Pc, Pf = render_cfg.n_rays_per_image, render_cfg.n_pts_coarse, render_cfg.n_pts_fine
    n = B * n_rays
    cfg = states[0].coarse.cfg
    dev = images.device
    use_kernel = field_kernel.enabled(cfg, dev)
    xys, u, u_pdf = draws if draws is not None else draw(generators, B, render_cfg, dev)
    bundle = cam_lib.monte_carlo_rays(cam, n_rays, Pc, min_depth, max_depth, xys=xys, u=u)
    flat_xy = xys.reshape(H * B, n_rays, 2)
    sil = sample_images_at_mc_locs(sils.reshape(H * B, S, S, 1), flat_xy).reshape(H, n, 1)
    col = sample_images_at_mc_locs(images.reshape(H * B, S, S, 3), flat_xy).reshape(H, n, 3)
    o = bundle.origins.reshape(H, n, 3)
    d = bundle.directions.reshape(H, n, 3)
    lengths = bundle.lengths.reshape(H, n, Pc)
    s, hs = train_cfg.loss_scale, train_cfg.huber_scaling

    if use_kernel and n <= ray_chunk:
        valid = torch.ones_like(sil)
        kw = dict(cfg=cfg, huber_scaling=hs, scale=s / n)
        pts_c = o[:, :, None] + d[:, :, None] * lengths[..., None]
        ce_c, se_c, w_c = field_kernel.bundle_loss_grads([st.coarse for st in states], pts_c, d, col, sil, valid,
                                                         want_weights=True, **kw)
        z_f = raymarch.importance_resample(lengths, w_c, Pf, u=u_pdf, add_input_samples=render_cfg.add_input_samples)
        pts_f = o[:, :, None] + d[:, :, None] * z_f[..., None]
        ce_f, se_f, _ = field_kernel.bundle_loss_grads([st.fine for st in states], pts_f, d, col, sil, valid, **kw)
        col_err = s * (ce_c + ce_f) / n
        sil_err = s * (se_c + se_f) / n
    else:
        col_err, sil_err = _chunked_losses(states, o, d, lengths, col, sil, u_pdf, render_cfg, train_cfg, ray_chunk,
                                           use_kernel)

    # one Adam update over every half's trained parameters (the counts agree)
    count = states[0].opt.count
    if any(st.opt.count != count for st in states):
        raise ValueError("halves at different optimizer counts cannot share one update")
    params = [p for st in states for p in train_params(st)]
    new_count = opt.update(params, [p.grad for p in params], [m for st in states for m in st.opt.mu],
                           [v for st in states for v in st.opt.nu], count)
    new = [st._replace(opt=st.opt._replace(count=new_count), step=st.step + 1) for st in states]
    return new, col_err + sil_err, {"color": col_err, "sil": sil_err}


def half_schedule(n_views: int, batch: int, total: int, seed: int) -> np.ndarray:
    """(total, batch) view indices: shuffled epochs from
    ``np.random.default_rng(seed)``, the last short batch filled from the
    epoch's start."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < total:
        perm = rng.permutation(n_views)
        for i in range(max(n_views // batch, 1)):
            idx = perm[i * batch: i * batch + batch]
            if len(idx) < batch:
                idx = np.concatenate([idx, perm[: batch - len(idx)]])
            out.append(idx)
    return np.stack(out[:total])


def train_nerf_fused(images, sils, R_bop, t_bop, K, field_cfg: FieldConfig,
                     render_cfg: RenderConfig = RenderConfig(), train_cfg: NerfTrainConfig = NerfTrainConfig(),
                     n_steps: Optional[int] = None, seed: int = 1, depth_margin: float = 2.0, device=None,
                     init_states=None, draws: Callable | None = None, ray_chunk: int = RAY_CHUNK):
    """Train H independent NeRFs (one per half-sequence) step by step, all
    halves in each launch.

    images (H, N, S, S, 3); sils (H, N, S, S); R_bop (H, N, 3, 3); t_bop
    (H, N, 3); K (H, N, 3, 3), as numpy arrays or tensors.  Half h starts
    from ``init_states[h]`` or a fresh init from seed + h, draws its batches from
    ``np.random.default_rng(seed + h)`` (the reference's schedule) and its
    rays from a generator seeded seed + h, unless ``draws(step)`` supplies
    them.  Losses stay on the device until the end.  Returns (list of
    per-half NerfTrainState, (H, n_steps) numpy losses).  Runs on ``device``,
    the card unless named."""
    dev = resolve_device(device)
    f32 = torch.float32
    H, n, S = images.shape[0], images.shape[1], images.shape[2]
    t_np = t_bop.detach().cpu().numpy() if torch.is_tensor(t_bop) else np.asarray(t_bop)
    min_d, max_d = depth_bounds(t_np.reshape(-1, 3), depth_margin)
    opt = make_optimizer(train_cfg)
    states = list(init_states) if init_states is not None else [
        init_state(field_cfg, train_cfg, torch.Generator().manual_seed(seed + h), device=dev) for h in range(H)]
    gens = None if draws is not None else [torch.Generator(device=dev).manual_seed(seed + h) for h in range(H)]
    as_t = lambda x: torch.as_tensor(x, dtype=f32, device=dev)  # noqa: E731
    cams = cam_lib.camera_from_bop(as_t(R_bop), as_t(t_bop), as_t(K), S)
    images, sils = as_t(images), as_t(sils)
    bs = min(train_cfg.batch_size, n)
    total = n_steps if n_steps is not None else train_cfg.n_epochs * max(n // bs, 1)
    idx_all = torch.as_tensor(np.stack([half_schedule(n, bs, total, seed + h) for h in range(H)]), device=dev)
    hh = torch.arange(H, device=dev)[:, None]
    losses = []
    for i in range(total):
        idx = idx_all[:, i]                                                   # (H, bs)
        cam = cam_lib.Camera(cams.R[hh, idx], cams.T[hh, idx], cams.focal[hh, idx], cams.principal[hh, idx], S)
        states, loss, _ = train_step(states, cam, images[hh, idx], sils[hh, idx], opt, render_cfg, train_cfg,
                                     min_d, max_d, draws=None if draws is None else draws(i), generators=gens,
                                     ray_chunk=ray_chunk)
        losses.append(loss)
    loss_mat = torch.stack(losses, 1).cpu().numpy() if losses else np.zeros((H, 0), np.float32)
    return states, loss_mat


def train_nerf(images, sils, R_bop, t_bop, K, field_cfg: FieldConfig, render_cfg: RenderConfig = RenderConfig(),
               train_cfg: NerfTrainConfig = NerfTrainConfig(), n_steps: Optional[int] = None, seed: int = 1,
               depth_margin: float = 2.0, log_every: int = 0, on_checkpoint: Callable | None = None,
               init_params=None, resume_state: NerfTrainState | None = None, device=None,
               draws: Callable | None = None, ray_chunk: int = RAY_CHUNK):
    """Train one NeRF (coarse + fine) on one sequence: images (N, S, S, 3),
    sils (N, S, S), R_bop (N, 3, 3), t_bop (N, 3) already divided by
    diameter / 1.8, K (N, 3, 3), as numpy arrays or tensors.

    The state starts from ``resume_state``, else from ``init_params`` =
    (coarse, fine) state dicts, else fresh from ``seed``.  ``n_steps`` is
    the TOTAL step target: a resumed run continues from its state's step
    with the schedule and draws the uninterrupted run would have used,
    exactly (params, Adam moments, count and step all resume).  Batches
    follow ``np.random.default_rng(seed)`` (``half_schedule``); a step's
    rays come from a generator seeded with (seed, step), unless
    ``draws(step)`` supplies them with a leading axis of 1.
    ``on_checkpoint(state, step)`` runs after every ``ckpt_every``-th step
    and after the last (the reference runs ``steps_per_call`` steps per
    program and snaps the hook to those boundaries; here every step is its
    own call).  Runs on ``device``, the card unless named.  Returns (state,
    per-step losses of this run as floats)."""
    dev = resolve_device(device)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    images, sils = as_t(images), as_t(sils)
    n, S = images.shape[0], images.shape[1]
    min_d, max_d = depth_bounds(as_t(t_bop).cpu().numpy(), depth_margin)
    cams = cam_lib.camera_from_bop(as_t(R_bop), as_t(t_bop), as_t(K), S)
    opt = make_optimizer(train_cfg)
    state = resume_state if resume_state is not None else init_state(
        field_cfg, train_cfg, torch.Generator().manual_seed(seed), init_params=init_params, device=dev)
    bs = min(train_cfg.batch_size, n)
    total = n_steps if n_steps is not None else train_cfg.n_epochs * max(n // bs, 1)
    schedule = half_schedule(n, bs, total, seed)
    losses = []
    for i in range(state.step, total):
        idx = torch.as_tensor(schedule[i], device=dev)
        cam = cam_lib.Camera(cams.R[idx][None], cams.T[idx][None], cams.focal[idx][None],
                             cams.principal[idx][None], S)
        step_draws = draws(i) if draws is not None else draw([step_generator(seed, i, dev)], bs, render_cfg, dev)
        (state,), loss, _ = train_step([state], cam, images[idx][None], sils[idx][None], opt, render_cfg, train_cfg,
                                       min_d, max_d, draws=step_draws, ray_chunk=ray_chunk)
        losses.append(loss[0])
        done = i + 1
        if log_every and done % log_every == 0:
            print(f"step {done}: loss={float(loss[0]):.4f}")
        if on_checkpoint is not None and (done % train_cfg.ckpt_every == 0 or done == total):
            on_checkpoint(state, done)
    return state, torch.stack(losses).tolist() if losses else []


def extract_point_cloud(field: fields.NerfField, threshold: float = 0.03, grid_res: int = 128):
    """World-space vertices and triangles of the density level set
    ``threshold``: the density on a grid_res^3 grid over [-1, 1]^3 (K1 where
    enabled), then marching tetrahedra (ops.mcubes) on the host."""
    grid = renderer.density_grid_cached(field, grid_res=grid_res)
    verts_idx, tris = mcubes.marching_tetrahedra(grid.cpu().numpy(), threshold)
    return mcubes.index_to_world(verts_idx, grid_res, exact=True), tris
