"""SurfEmb descriptor training (counterpart of train/pose_trainer.py).

1. **Negative keys** (``build_negatives``): surface hits over ``n_loops``
   passes of every view (K1), FPS, keep |x| < ``neg_bound``, keep points
   within ``neg_mesh_dist`` of the surface cloud (K2).
2. **Contrastive training** (``train_pose``), one eager step a batch of
   views:
   * augment the views (train/augment.py) and move their ray xys with them,
   * CNN queries: ResNet-UNet -> 12-d map + mask logit, read at the
     augmented xys of ``sample_size`` sampled front hits,
   * keys: the NeRF feature head at those hits; negatives: the feature head
     at jittered negative keys,
   * loss = InfoNCE(q, k, neg) * infonce_scale + BCE(mask) * mask_loss_scale,
   * Adam per group (``PoseOptimizer``): the CNN at ``lr_cnn``, the feature
     head at ``lr_mlp`` (AdamW with ``head_weight_decay``), each rate with
     a linear warmup; the rest of the NeRF stays frozen.

On one CUDA device (no mesh) the step's loss and gradient run as a CUDA
graph (``utils/graphs.py``): a signature's first call runs eagerly, its
second captures the graph (the sampled rays drawn eagerly between two
graphs, from the caller's generator), and later calls replay it, so the
step launches a few graphs and Adam's ops instead of ~1,300 kernels.
Adam stays eager, reading the grads the graph writes.

f32 matmuls and convolutions run without TF32.  A step is bit-reproducible
on the card: cuDNN runs its deterministic algorithms in the step
(``device.deterministic_cudnn``) and the query read's backward sums in a
fixed order (``grid_sample.gather_rows``); the rest of the backward has no
atomics on one stream.  Random draws come from a
generator seeded with (seed, step), or are passed in (``draws``), so tests
can replay the reference's ``jax.random`` streams and a resumed run draws
what the uninterrupted one drew.

With a device ``mesh`` (``parallel.mesh``; ``mesh="auto"``, the default,
is every card when there are several; a batch that does not divide it
takes the widest sub-mesh that it does, as the reference's) a step's
views split over the entries.  The draws and the cross-view terms (the
distractors) are made on home for the whole batch; each entry augments
its views, and once the sampled rays are drawn on home from the whole
batch's augmented xys, runs the CNN, the keys and its loss, weighted by
its share of the views, forward and backward on its own copy of the
networks.  The grads are summed on home in entry order, both optimizers
step there, and the new weights are copied into every copy in place.
"""

from __future__ import annotations

import copy
import itertools
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import PoseTrainConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import deterministic_cudnn, no_tf32, of_module
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as pc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.grid_sample import grid_sample
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts, surface_sampling
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as aug_lib
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train.nerf_trainer import adam_update_, step_seed
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import graphs
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils.profiling import span


def info_nce_with_neg(q: torch.Tensor, k: torch.Tensor, k_neg: torch.Tensor, scale: float = 1e-3,
                      temp: float = 1.0) -> torch.Tensor:
    """Per positive pair, the cross entropy of [q.k, q @ k_neg^T] / temp
    against class 0, averaged and times ``scale``.  q, k (B, P, E); k_neg
    (B, N, E)."""
    sim_pos = (q * k).sum(-1, keepdim=True)
    with no_tf32():
        sim_neg = torch.einsum("bpe,bne->bpn", q, k_neg)
    lgts = torch.cat([sim_pos, sim_neg], -1)
    if temp != 1.0:
        lgts = lgts / temp
    return (torch.logsumexp(lgts, -1) - lgts[..., 0]).mean() * scale


def info_nce_in_batch(q: torch.Tensor, k: torch.Tensor, perm: torch.Tensor, neg_frac: float = 1.0,
                      scale: float = 1e-3) -> torch.Tensor:
    """In-batch negatives: the positives' own keys at the first
    ``neg_frac`` of the permutation ``perm`` (P,) serve as the negatives."""
    n_neg = int(k.shape[1] * neg_frac)
    return info_nce_with_neg(q, k, k[:, perm[:n_neg]], scale)


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, elementwise."""
    return -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))


def build_negatives(field, R_bop, t_bop, K, sils, mverts, cfg: PoseTrainConfig, image_size: int = 224,
                    rays_per_image: int = 50, n_loops: int = 20, threshold: float = 0.2,
                    generator: torch.Generator | None = None, draws=None, device=None) -> torch.Tensor:
    """The negative keys (M, 3) on the field's device (``device``, the card
    unless named): surface hits of ``n_loops`` passes (draws from
    ``generator`` or ``draws``, as ``surface_sampling.sample_surface_hits``
    takes them), FPS to ``cfg.n_neg``, the bound and mesh filters."""
    dev = of_module(field, device)
    hits = surface_sampling.sample_surface_hits(
        field, R_bop, t_bop, K, sils, n_loops=n_loops, rays_per_image=rays_per_image, image_size=image_size,
        threshold=threshold, generator=generator, draws=draws,
    )
    if hits.shape[0] < 10:
        raise RuntimeError(
            f"negative-key build collected only {hits.shape[0]} surface hits — the NeRF density is too weak "
            "at this threshold (train longer or lower the threshold)"
        )
    neg = hits[pc.farthest_point_sampling(hits, min(cfg.n_neg, hits.shape[0]))]
    neg = neg[neg.abs().amax(-1) < cfg.neg_bound]
    d, _ = pc.nn_query(neg, torch.as_tensor(np.asarray(mverts), dtype=torch.float32, device=dev))
    neg = neg[d < cfg.neg_mesh_dist]
    if neg.shape[0] < 10:
        raise RuntimeError(
            f"negative-key build kept only {neg.shape[0]} points after the bound/mesh filters (bound "
            f"{cfg.neg_bound}, mesh dist {cfg.neg_mesh_dist}) — surface cloud and hits disagree"
        )
    return neg


class RayBank(NamedTuple):
    """Per-view front and back hits, padded to a common count per view."""

    pos_vec: torch.Tensor   # (V, M, 3)
    xys: torch.Tensor       # (V, M, 2)
    back_vec: torch.Tensor  # (V, Mb, 3)
    back_xys: torch.Tensor  # (V, Mb, 2)
    valid: torch.Tensor     # (V, M) bool
    back_valid: torch.Tensor


def load_ray_bank(cors_dir: str, render_size: int, n_views: int, max_rays: Optional[int] = None,
                  bucket: int = 2048, device=None) -> RayBank:
    """The correspondence files of ``n_views`` views as a ``RayBank`` on
    ``device`` (the card unless named), each view padded to ``max_rays``
    or to the largest view's count rounded up to a multiple of ``bucket``
    (the reference's stable shapes; the padding is never sampled)."""
    dev = resolve_device(device)
    pos, xys, bxys, bvec = [], [], [], []
    for i in range(n_views):
        x, p, bx, bv = artifacts.load_view_rays(cors_dir, render_size, i)
        xys.append(x)
        pos.append(p)
        bxys.append(bx)
        bvec.append(bv)

    def rounded(m):
        return int(np.ceil(max(m, 1) / bucket) * bucket) if bucket > 1 else max(m, 1)

    M = max_rays or rounded(max(p.shape[0] for p in pos))
    Mb = max_rays or rounded(max(b.shape[0] for b in bvec))

    def padto(arrs, m, dim):
        out = np.zeros((n_views, m, dim), np.float32)
        val = np.zeros((n_views, m), bool)
        for i, a in enumerate(arrs):
            k = min(a.shape[0], m)
            out[i, :k] = a[:k]
            val[i, :k] = True
        return torch.as_tensor(out, device=dev), torch.as_tensor(val, device=dev)

    pos_p, valid = padto(pos, M, 3)
    xys_p, _ = padto(xys, M, 2)
    bvec_p, bvalid = padto(bvec, Mb, 3)
    bxys_p, _ = padto(bxys, Mb, 2)
    return RayBank(pos_p, xys_p, bvec_p, bxys_p, valid, bvalid)


class PoseAdamState(NamedTuple):
    """Adam moments of the feature head's and the CNN's parameters (in
    ``head_params`` / ``cnn.parameters()`` order) and the update count."""

    count: int
    head_mu: list
    head_nu: list
    cnn_mu: list
    cnn_nu: list


class PoseTrainState(NamedTuple):
    field: fields.NerfField      # its feature head trains, the rest is frozen
    cnn: ResNetUNet
    opt: PoseAdamState
    step: int


def head_params(field: fields.NerfField) -> list:
    """The field's parameters that descriptor training updates: the feature
    head (``freeze_spec(train_feature_head=True)``)."""
    labels = fields.freeze_spec(train_feature_head=True)(field)
    return [p for n, p in field.named_parameters() if labels[n] == "train"]


class PoseOptimizer:
    """The reference's ``make_pose_optimizer``: Adam on the CNN at
    ``lr_cnn`` and on the feature head at ``lr_mlp`` (AdamW when
    ``head_weight_decay`` > 0), each rate ``base * min((count + 1) /
    warmup_steps, 1)`` in f32; the frozen parameters never move."""

    def __init__(self, cfg: PoseTrainConfig):
        self.cfg = cfg

    def learning_rate(self, base: float, count: int) -> float:
        f = np.float32
        return float(f(base) * np.minimum(f(count + 1) / f(self.cfg.warmup_steps), f(1)))

    def init(self, field: fields.NerfField, cnn: ResNetUNet) -> PoseAdamState:
        zeros = lambda ps: [torch.zeros_like(p) for p in ps]  # noqa: E731
        head, net = head_params(field), list(cnn.parameters())
        return PoseAdamState(0, zeros(head), zeros(head), zeros(net), zeros(net))

    def update(self, field: fields.NerfField, cnn: ResNetUNet, opt: PoseAdamState) -> PoseAdamState:
        """One update of both groups from their ``.grad``s; the moments change
        in place."""
        c, n = self.cfg, opt.count
        head, net = head_params(field), list(cnn.parameters())
        adam_update_(head, [p.grad for p in head], opt.head_mu, opt.head_nu, n, self.learning_rate(c.lr_mlp, n),
                     c.head_weight_decay)
        adam_update_(net, [p.grad for p in net], opt.cnn_mu, opt.cnn_nu, n, self.learning_rate(c.lr_cnn, n))
        return opt._replace(count=n + 1)


def make_pose_optimizer(cfg: PoseTrainConfig) -> PoseOptimizer:
    return PoseOptimizer(cfg)


def init_pose_state(field: fields.NerfField, cfg: PoseTrainConfig, cnn: Optional[ResNetUNet] = None,
                    generator: torch.Generator | None = None, device=None) -> PoseTrainState:
    """A fresh state on ``device`` (the card unless named) with copies of
    ``field`` and of ``cnn`` (default: a full-width ResNetUNet drawn from
    ``generator``); the callers' modules are not changed."""
    dev = resolve_device(device)
    net = copy.deepcopy(cnn) if cnn is not None else ResNetUNet().reset_parameters(generator)
    f, net = copy.deepcopy(field).to(dev), net.to(dev)
    return PoseTrainState(f, net, make_pose_optimizer(cfg).init(f, net), 0)


class PoseDraws(NamedTuple):
    """One step's draws for a batch of B views, ``n = sample_size``.  In
    brackets the reference's key path from the step key:
    ``(k_aug, k_sel, k_noise) = split(key, 3)``."""

    aug: aug_lib.AugmentDraws        # split(k_aug, B)[b] per view (k_aug after the pick's split)
    pick: Optional[torch.Tensor]     # (B,) distractor bank rows [split(k_aug) -> k_pick], or None
    sel: Optional[torch.Tensor]      # (B, n) sampled rays [split(k_sel, B)]; None: drawn in the step
    pos_noise: Optional[torch.Tensor]  # (B, n, 3) normal [split(k_noise) -> k_pos]; None if unused
    neg_idx: torch.Tensor            # (B, n) negative rows [k_noise' -> split -> k_pick]
    neg_jitter: torch.Tensor         # (B, n, 3) normal [... -> k_jitter]


def draw_pose_step(generator: torch.Generator, B: int, S: int, n_neg: int, cfg: PoseTrainConfig,
                   aug_cfg: aug_lib.AugmentConfig, n_bg: int = 0, n_distractors: int = 0) -> PoseDraws:
    """One step's ``PoseDraws`` from ``generator`` on its device, ``sel``
    left to the step (it depends on the augmented xys)."""
    dev = generator.device
    n = cfg.sample_size
    pick = torch.randint(0, n_distractors, (B,), generator=generator, device=dev) if n_distractors else None
    aug = aug_lib.draw_augment(generator, B, S, aug_cfg, n_bank=n_bg)
    pos = torch.randn((B, n, 3), generator=generator, device=dev) if cfg.pos_noise > 0 else None
    neg_idx = torch.randint(0, n_neg, (B, n), generator=generator, device=dev)
    return PoseDraws(aug, pick, None, pos, neg_idx, torch.randn((B, n, 3), generator=generator, device=dev))


def replicate_pose_state(state: PoseTrainState, mesh: mesh_lib.Mesh) -> list:
    """Per mesh entry, its own copy of the state's field and CNN on its
    device: [(field, cnn), ...]."""
    return list(zip(mesh_lib.replicate(state.field, mesh), mesh_lib.replicate(state.cnn, mesh)))


def _trained(field, cnn) -> list:
    return head_params(field) + list(cnn.parameters())


def _view_losses(field, cnn, aug, new_xys, sel, pos_vec, pos_noise, neg_pts, neg_idx, neg_jitter,
                 cfg: PoseTrainConfig):
    """(InfoNCE, mask BCE) of a set of augmented views at their sampled
    rays ``sel``, each a mean over those views."""
    sel_xys = new_xys.gather(1, sel[..., None].expand(-1, -1, 2))
    sel_pos = pos_vec.gather(1, sel[..., None].expand(-1, -1, 3))
    if cfg.pos_noise > 0:
        sel_pos = sel_pos + pos_noise * cfg.pos_noise
    neg = neg_pts[neg_idx] + neg_jitter * cfg.key_noise
    with span("pose.unet"):
        feat_full = cnn(aug.rgb)                                            # (B, S, S, 13)
        queries = grid_sample(feat_full[..., :12], -sel_xys, mode="nearest")
    with span("pose.head"):
        keys, neg_keys = field.features(sel_pos), field.features(neg)
    with span("pose.loss"):
        nce = info_nce_with_neg(queries, keys, neg_keys, cfg.infonce_scale, temp=cfg.infonce_temp)
        bce = _sigmoid_bce(feat_full[..., -1], aug.mask_full).mean() * cfg.mask_loss_scale
    return nce, bce


def _sharded_losses(mesh, replicas, images, sils, pos_vec, xys, valid, neg_pts, cfg, aug_cfg, d: PoseDraws,
                    generator, bg_bank, distractor):
    """The step's loss terms with its views split over ``mesh``: each
    entry's (nce, bce) weighted by its share of the views and
    backpropagated into its copy (``replicas``), the weighted terms summed
    on home; the home networks' ``.grad`` is set to the entries' sum."""
    B = images.shape[0]
    shards = mesh_lib.shards(B, mesh)
    consts = mesh_lib.broadcast((neg_pts, bg_bank), mesh)
    augs = []
    with span("pose.augment"):
        for i, dv, s in shards:
            take = lambda x: mesh_lib.part(x, s, dv)  # noqa: E731
            augs.append(aug_lib.augment_view(take(images), take(sils), aug_cfg, take(d.aug), take(distractor),
                                             consts[i][1]))
        sel = d.sel
        if sel is None:
            A, t = mesh_lib.gather([(a.A, a.t) for a in augs], mesh)
            sel = aug_lib.select_ray_samples(aug_lib.transform_xys(xys, A, t), valid, cfg.sample_size, generator)
    terms = []
    for (i, dv, s), aug in zip(shards, augs):
        take = lambda x: mesh_lib.part(x, s, dv)  # noqa: E731
        field, cnn = replicas[i]
        for p in _trained(field, cnn):
            p.grad = None
        w = (s.stop - s.start) / B
        with torch.enable_grad(), no_tf32(), deterministic_cudnn():
            with span("pose.augment"):
                new_xys = aug_lib.transform_xys(take(xys), aug.A, aug.t)
            with span("pose.forward"):
                nce, bce = _view_losses(field, cnn, aug, new_xys, take(sel), take(pos_vec), take(d.pos_noise),
                                        consts[i][0], take(d.neg_idx), take(d.neg_jitter), cfg)
            with span("pose.backward"):
                (w * (nce + bce)).backward()
        terms.append((w * nce.detach(), w * bce.detach()))
    return [mesh_lib.reduce_sum(list(x), mesh) for x in zip(*terms)], [replicas[i] for i, _, _ in shards]


# the descriptor step's CUDA graphs (utils/graphs.py), one per input
# signature, the most recently used kept: each pins the step's activations
# in its memory pool
MAX_GRAPHS = 2
# CUDA calls of pose_train_step: graphs captured, calls replayed through a
# graph captured earlier, and calls run eagerly (a signature's first call,
# a mesh of several entries, or a stream that is capturing already)
POSE_GRAPH_COUNT = {"captures": 0, "replays": 0, "eager": 0}
_GRAPHS: OrderedDict = OrderedDict()    # signature -> _StepGraph
_SEEN: OrderedDict = OrderedDict()      # signature called once -> its modules (so their ids stay theirs)


class _StepGraph(NamedTuple):
    graph: graphs.Graph
    grads: list      # the trained parameters' grads, as every replay writes them


def _one_entry_args(images, sils, pos_vec, xys, valid, neg_pts, d: PoseDraws, generator, bg_bank,
                    distractor) -> tuple:
    """The one-entry step's inputs as ``_one_entry_losses`` takes them."""
    dis = distractor if distractor is not None else (None, None)
    return (images, sils, pos_vec, xys, valid, neg_pts, bg_bank, *dis, d.sel, d.pos_noise, d.neg_idx, d.neg_jitter,
            generator if d.sel is None else None, *d.aug)


def _one_entry_losses(field, cnn, cfg, aug_cfg, images, sils, pos_vec, xys, valid, neg_pts, bg_bank, dis_rgb,
                      dis_mask, sel, pos_noise, neg_idx, neg_jitter, generator, *aug) -> tuple:
    """(nce, bce) of the step on one device, its grads in the modules'
    ``.grad``: the body of the step's graph."""
    d = PoseDraws(aug_lib.AugmentDraws(*aug), None, sel, pos_noise, neg_idx, neg_jitter)
    distractor = None if dis_rgb is None else (dis_rgb, dis_mask)
    terms, _ = _sharded_losses(mesh_lib.Mesh([images.device]), [(field, cnn)], images, sils, pos_vec, xys, valid,
                               neg_pts, cfg, aug_cfg, d, generator, bg_bank, distractor)
    return tuple(terms)


def _signature(a):
    if isinstance(a, torch.Generator):
        return "generator", a.device
    return None if a is None else (tuple(a.shape), a.dtype)


def _one_entry_step(field, cnn, trained, cfg, aug_cfg, args) -> tuple:
    """``_one_entry_losses`` on ``args``; on a CUDA device through the
    signature's graph, the trained parameters' ``.grad`` set to the grads
    it wrote.  The signature: the device, the inputs' shapes and dtypes,
    the modules and their tensors' addresses (which the graph reads), the
    configs."""
    dev = args[0].device
    body = lambda *a: _one_entry_losses(field, cnn, cfg, aug_cfg, *a)  # noqa: E731
    if dev.type != "cuda":
        return body(*args)
    if torch.cuda.is_current_stream_capturing():
        POSE_GRAPH_COUNT["eager"] += 1
        return body(*args)
    tensors = itertools.chain(field.parameters(), field.buffers(), cnn.parameters(), cnn.buffers())
    key = (dev, tuple(_signature(a) for a in args), id(field), id(cnn), tuple(t.data_ptr() for t in tensors), cfg,
           aug_cfg)
    entry = _GRAPHS.pop(key, None)
    if entry is None and _SEEN.pop(key, None) is None:
        _SEEN[key] = (field, cnn)
        while len(_SEEN) > MAX_GRAPHS:
            _SEEN.popitem(last=False)
        POSE_GRAPH_COUNT["eager"] += 1
        return body(*args)
    if entry is None:
        while len(_GRAPHS) >= MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        POSE_GRAPH_COUNT["captures"] += 1
        graph = graphs.Graph(body, args, dev)
        out = graph.capture(args)
        entry = _StepGraph(graph, [p.grad for p in trained])
    else:
        POSE_GRAPH_COUNT["replays"] += 1
        with span("pose.replay"):
            out = entry.graph(args)
        for p, g in zip(trained, entry.grads):
            p.grad = g
    _GRAPHS[key] = entry
    return out


def pose_train_step(state: PoseTrainState, opt: PoseOptimizer, images, sils, pos_vec, xys, valid, neg_pts,
                    cfg: PoseTrainConfig, aug_cfg: aug_lib.AugmentConfig, draws: PoseDraws,
                    generator: torch.Generator | None = None, bg_bank=None, distractor_bank=None,
                    mesh: mesh_lib.Mesh | None = None, replicas=None):
    """One descriptor step on a batch: images (B, S, S, 3), sils (B, S, S),
    its ray bank rows pos_vec (B, M, 3), xys (B, M, 2), valid (B, M), the
    negative keys (Nn, 3).  ``draws.sel`` None draws the sampled rays from
    ``generator``.  ``mesh`` (home: the state's device; None is one entry
    there) splits the views over its entries, run on ``replicas``
    (``replicate_pose_state``; made here when None; without a mesh, the
    state's own modules), which leave the step equal to the new state.  The
    state's modules and moments change in place.  Returns (new state,
    loss, {"nce", "bce"}), all on the device.  Without a mesh, on a CUDA
    device, the step's loss and gradient run as a CUDA graph after its
    signature's first call (see the module's docstring)."""
    field, cnn = state.field, state.cnn
    d = draws
    distractor = None
    if aug_cfg.p_distractor > 0:
        if distractor_bank is not None:
            distractor = (distractor_bank[0][d.pick], distractor_bank[1][d.pick])
        else:
            distractor = (torch.roll(images, 1, 0), torch.roll(sils, 1, 0))
    trained = _trained(field, cnn)
    if mesh is None:
        if generator is None and d.sel is None and images.device.type == "cuda":
            # named, so that a graph can carry its state
            generator = torch.cuda.default_generators[images.device.index]
        args = _one_entry_args(images, sils, pos_vec, xys, valid, neg_pts, d, generator, bg_bank, distractor)
        nce, bce = _one_entry_step(field, cnn, trained, cfg, aug_cfg, args)
        used = replicas = [(field, cnn)]
    else:
        if images.device.type == "cuda":
            POSE_GRAPH_COUNT["eager"] += 1
        if replicas is None:
            replicas = replicate_pose_state(state, mesh)
        (nce, bce), used = _sharded_losses(mesh, replicas, images, sils, pos_vec, xys, valid, neg_pts, cfg, aug_cfg,
                                           d, generator, bg_bank, distractor)
    loss = nce + bce
    with span("pose.adam"):
        mesh_lib.reduce_grads_(trained, [_trained(f, c) for f, c in used])
        new_opt = opt.update(field, cnn, state.opt)
        mesh_lib.copy_params_(trained, [_trained(f, c) for f, c in replicas])
    return state._replace(opt=new_opt, step=state.step + 1), loss.detach(), {"nce": nce.detach(),
                                                                             "bce": bce.detach()}


def view_schedule(n_views: int, batch: int, n_steps: int, seed: int) -> np.ndarray:
    """(n_steps, batch) view indices: a fresh ``default_rng(seed)``
    permutation a step, cut to the batch (or cycled up to it)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_views)[:batch] if n_views >= batch else
                     np.resize(rng.permutation(n_views), batch) for _ in range(n_steps)])


def train_pose(field, images, sils, ray_bank: RayBank, neg_pts, cfg: PoseTrainConfig = PoseTrainConfig(),
               aug_cfg: Optional[aug_lib.AugmentConfig] = None, n_steps: int = 1000, seed: int = 1,
               cnn: Optional[ResNetUNet] = None, log_every: int = 0, on_checkpoint: Callable | None = None,
               resume_state: Optional[PoseTrainState] = None, bg_bank=None, distractor_bank=None, device=None,
               draws: Callable | None = None, mesh="auto"):
    """Descriptor training on one half: images (V, S, S, 3), sils (V, S, S)
    as numpy arrays or tensors, its ``RayBank`` and the negative keys.

    The state starts from ``resume_state``, else from copies of ``field``
    and ``cnn`` (default: a full-width ResNetUNet drawn from ``seed``).
    ``n_steps`` is the TOTAL step target: a resumed run continues from its
    state's step with the schedule and draws the uninterrupted run would
    have used, exactly.  Batches follow ``view_schedule(seed)``; a step's
    draws come from one generator of the run, seeded anew each step with
    ``step_seed(seed, step)``, unless ``draws(step)`` supplies a
    ``PoseDraws``.  ``on_checkpoint(state, step)`` runs after every
    ``cfg.ckpt_every``-th step and after the last.
    ``distractor_bank`` = ((D, S, S, 3), (D, S, S)) of other objects to
    paste (default: the batch's own views, rolled by one); ``bg_bank`` (N,
    S, S, 3) backgrounds.  Runs on ``device``, the card unless named (the
    mesh's home when only a mesh is given), each step's views split over
    ``mesh`` (cut to the widest sub-mesh whose size divides the batch).
    Returns (state, per-step losses of this run as floats)."""
    mesh, dev = mesh_lib.place(mesh, device)
    as_t = lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,  # noqa: E731
                                     dtype=torch.float32).to(dev)
    images, sils, neg_pts = as_t(images), as_t(sils), as_t(neg_pts)
    n, S = images.shape[0], images.shape[1]
    if aug_cfg is None:
        aug_cfg = aug_lib.AugmentConfig(crop_res=S, min_mask_sum=10.0,
                                        p_distractor=0.3 if distractor_bank is not None else 0.0)
    elif distractor_bank is not None and aug_cfg.p_distractor <= 0:
        raise ValueError(
            "distractor_bank was given but aug_cfg.p_distractor is 0 — the bank would never be used; set "
            "p_distractor > 0 or drop the bank"
        )
    if bg_bank is not None:
        bg_bank = as_t(bg_bank)
    if distractor_bank is not None:
        distractor_bank = tuple(as_t(a) for a in distractor_bank)
    state = resume_state if resume_state is not None else init_pose_state(
        field, cfg, cnn, torch.Generator().manual_seed(seed), device=dev)
    opt = make_pose_optimizer(cfg)
    bs = min(cfg.batch_size, n)
    if mesh is not None and bs % mesh.size:
        k = mesh_lib.largest_divisor_mesh_size(bs, mesh.size)
        print(f"train_pose: batch {bs} does not divide the mesh's {mesh.size} devices - using "
              f"{f'a {k}-device sub-mesh' if k > 1 else 'one device'}")
        mesh = mesh_lib.Mesh(mesh.devices[:k]) if k > 1 else None
    replicas = None if mesh is None else replicate_pose_state(state, mesh)
    schedule = view_schedule(n, bs, n_steps, seed)
    n_bg = 0 if bg_bank is None else bg_bank.shape[0]
    n_dis = 0 if distractor_bank is None else distractor_bank[0].shape[0]
    # one generator a run, reseeded each step: it draws what step_generator(seed, step) would
    gen = torch.Generator(device=dev) if draws is None else None
    losses = []
    for i in range(state.step, n_steps):
        idx = torch.as_tensor(schedule[i], device=dev)
        if draws is not None:
            step_draws = draws(i)
        else:
            step_draws = draw_pose_step(gen.manual_seed(step_seed(seed, i)), bs, S, neg_pts.shape[0], cfg, aug_cfg,
                                        n_bg, n_dis)
        state, loss, _ = pose_train_step(state, opt, images[idx], sils[idx], ray_bank.pos_vec[idx],
                                         ray_bank.xys[idx], ray_bank.valid[idx], neg_pts, cfg, aug_cfg,
                                         step_draws, gen, bg_bank, distractor_bank, mesh, replicas)
        losses.append(loss)
        done = i + 1
        if log_every and done % log_every == 0:
            print(f"pose step {done}: loss={float(loss):.5f}")
        if on_checkpoint is not None and (done % cfg.ckpt_every == 0 or done == n_steps):
            on_checkpoint(state, done)
    return state, torch.stack(losses).tolist() if losses else []
