"""Point-cloud and correspondence ops: kernels K2 (``csrc/nn_min.cu``) and
K3 (``csrc/corr_argmax.cu``), each beside its plain PyTorch version.

Counterpart of the reference's ops/pallas_kernels.py:

* ``nn_min``: per query, the distance to and lowest index of the nearest
  masked reference point, from exact per-coordinate differences;
* ``correspondence_argmax``: per query, argmax over keys of q . k and
  ``max_logit - logsumexp``, streamed over key chunks;
* ``chamfer_distance``: (mean d_ab + mean d_ba) / 2.

Each op runs its kernel for CUDA tensors and its plain version for CPU
tensors; any other device raises.  The plain versions chunk the reference
and key axes so no (N, M) matrix is ever whole.
"""

from __future__ import annotations

import functools

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build

_BIG = 1e30
_NEG = -1e30
_CHUNK_ELEMS = 1 << 24


def _ref_mask(ref: torch.Tensor, ref_mask) -> torch.Tensor:
    if ref_mask is None:
        return torch.ones(ref.shape[0], dtype=torch.float32, device=ref.device)
    return ref_mask.to(torch.float32).contiguous()


# ------------------------------------------------------- K2 / K3 launch plan

# no split shorter than MIN_SPLIT references or keys, none beyond MAX_WAVES
# waves of the card's blocks; the fewest splits whose waves are FILL full
MIN_SPLIT = 64
MAX_WAVES = 4
FILL = 0.95


@functools.lru_cache(maxsize=1024)
def split_plan(n: int, m: int, slots: int, qpb: int):
    """(splits, split length) of the M references or keys for a launch of
    ``ceil(n / qpb)`` query tiles x splits on a card that holds ``slots``
    of the kernel's blocks at once (``qpb`` queries a block).  One split when the
    query tiles alone fill the slots; else the fewest splits whose blocks
    fill their waves of slots to ``FILL`` (every block does the same work,
    so a part-empty last wave idles the card), or failing that the best
    fill, each split at least ``MIN_SPLIT`` long and at most ``MAX_WAVES``
    waves in all."""
    tiles = -(-n // qpb)
    most = 1 if tiles >= slots else max(1, min(m // MIN_SPLIT, MAX_WAVES * slots // tiles))
    fills = [tiles * s / (-(-tiles * s // slots) * slots) for s in range(1, most + 1)]
    full = [s for s, f in enumerate(fills, 1) if f >= FILL]
    splits = full[0] if full else 1 + fills.index(max(fills))
    length = -(-m // splits)
    return -(-m // length), length


@functools.lru_cache(maxsize=None)
def slots(index: int, kernel: str) -> int:
    """Blocks of ``kernel`` ("nn_min" or "corr_argmax") that CUDA device
    ``index`` holds at once: its SMs times the kernel's occupancy."""
    with torch.cuda.device(index):
        per_sm = getattr(cuda_build.kernels(), f"{kernel}_blocks_per_sm")()
    return torch.cuda.get_device_properties(index).multi_processor_count * per_sm


def launch_plan(n: int, m: int, dev: torch.device, kernel: str):
    """``split_plan`` for a launch of ``kernel`` on CUDA device ``dev``,
    with the block's query count the extension was built with."""
    return split_plan(n, m, slots(dev.index, kernel), cuda_build.kernels().point_queries_per_block())


def _workspace(splits: int, n: int, row_bytes: int, dev):
    """The partials' workspace of a split launch (none for one split)."""
    if splits == 1:
        return None, 0
    work = torch.empty((splits * n * row_bytes,), dtype=torch.uint8, device=dev)
    return work, work.data_ptr()


# ---------------------------------------------------------------- K2 nn_min


def nn_min_sq_plain(query: torch.Tensor, ref: torch.Tensor, ref_mask=None):
    """One reference slice's partial: query (N, 3), ref (M, 3) -> (squared
    distance (N,), lowest index (N,) int32) of the nearest point with mask
    > 0; (1e30, 0) where none is."""
    n, m = query.shape[0], ref.shape[0]
    valid = _ref_mask(ref, ref_mask) > 0
    best = torch.full((n,), _BIG, dtype=torch.float32, device=query.device)
    arg = torch.zeros((n,), dtype=torch.int32, device=query.device)
    chunk = max(1, min(m, _CHUNK_ELEMS // max(n, 1)))
    for s in range(0, m, chunk):
        r = ref[s : s + chunk]
        d = None
        for k in range(3):
            diff = query[:, k : k + 1] - r[None, :, k]
            d = diff * diff if d is None else d + diff * diff
        d = torch.where(valid[None, s : s + chunk], d, torch.full_like(d, _BIG))
        a = torch.argmin(d, dim=1)
        v = d.gather(1, a[:, None])[:, 0]
        better = v < best
        arg = torch.where(better, (a + s).to(torch.int32), arg)
        best = torch.where(better, v, best)
    return best, arg


def nn_min_merge_plain(part_d: torch.Tensor, part_i: torch.Tensor):
    """K2's merge pass: the partials (S, N) of S consecutive reference slices
    (global indices) -> (dist (N,), idx (N,)).  In increasing slice order a
    smaller squared distance, or an equal one at a lower index, wins."""
    best, arg = part_d[0], part_i[0]
    for d, i in zip(part_d[1:], part_i[1:]):
        better = (d < best) | ((d == best) & (i < arg))
        best = torch.where(better, d, best)
        arg = torch.where(better, i, arg)
    return torch.sqrt(best), arg


def nn_min_plain(query: torch.Tensor, ref: torch.Tensor, ref_mask=None):
    """query (N, 3), ref (M, 3) -> (dist (N,), idx (N,) int32)."""
    best, arg = nn_min_sq_plain(query, ref, ref_mask)
    return torch.sqrt(best), arg


def nn_min_cuda(query: torch.Tensor, ref: torch.Tensor, ref_mask=None):
    """K2 on the card: query (N, 3), ref (M, 3) f32 -> (dist (N,), idx (N,) int32)."""
    dev = query.device
    f32 = torch.float32
    cuda_build.check(query, "query", f32, (None, 3), dev)
    cuda_build.check(ref, "ref", f32, (None, 3), dev)
    n, m = query.shape[0], ref.shape[0]
    mask = None if ref_mask is None else ref_mask.to(f32).contiguous()
    if mask is not None:
        cuda_build.check(mask, "ref_mask", f32, (m,), dev)
    if m == 0:
        raise ValueError("nn_min: empty reference cloud")
    dist = torch.empty((n,), dtype=f32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        splits, length = launch_plan(n, m, dev, "nn_min")
        work, work_ptr = _workspace(splits, n, 8, dev)
        with cuda_build.launch(nn_min_cuda, "nn_min", dev):
            cuda_build.kernels().nn_min(query.data_ptr(), n, ref.data_ptr(), 0 if mask is None else mask.data_ptr(),
                                        m, splits, length, work_ptr, dist.data_ptr(), idx.data_ptr(),
                                        cuda_build.stream_ptr(dev))
    return dist, idx


cuda_build.reset(nn_min_cuda)


def nn_min(query: torch.Tensor, ref: torch.Tensor, ref_mask=None):
    """K2 for CUDA tensors, its plain version for CPU tensors."""
    if query.device.type == "cuda":
        return nn_min_cuda(query.contiguous(), ref.contiguous(), ref_mask)
    if query.device.type == "cpu":
        return nn_min_plain(query, ref, ref_mask)
    raise ValueError(f"nn_min: unsupported device {query.device}")


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d_ab, _ = nn_min(a, b)
    d_ba, _ = nn_min(b, a)
    return (d_ab.mean() + d_ba.mean()) / 2.0


# ----------------------------------------------------- K3 correspondence argmax


def correspondence_partial_plain(queries: torch.Tensor, keys: torch.Tensor, chunk: int = 2048):
    """One key slice's partial: queries (N, E), keys (M, E) -> (best logit,
    its first index int32, running max m, sum of exp(logit - m)), each (N,).
    The logits are an f32 matmul: keep TF32 off (PyTorch's default)."""
    n = queries.shape[0]
    dev = queries.device
    best = torch.full((n,), _NEG, dtype=torch.float32, device=dev)
    arg = torch.zeros((n,), dtype=torch.int32, device=dev)
    m_run = torch.full((n,), _NEG, dtype=torch.float32, device=dev)
    s_run = torch.zeros((n,), dtype=torch.float32, device=dev)
    for s in range(0, keys.shape[0], chunk):
        logits = queries @ keys[s : s + chunk].T
        a = torch.argmax(logits, dim=1)
        v = logits.gather(1, a[:, None])[:, 0]
        m_new = torch.maximum(m_run, v)
        s_run = s_run * torch.exp(m_run - m_new) + torch.exp(logits - m_new[:, None]).sum(1)
        m_run = m_new
        better = v > best
        arg = torch.where(better, (a + s).to(torch.int32), arg)
        best = torch.where(better, v, best)
    return best, arg, m_run, s_run


def _conf(best, m_run, s_run):
    return best - (m_run + torch.log(s_run.clamp_min(1e-30)))


def correspondence_merge_plain(best: torch.Tensor, arg: torch.Tensor, m_run: torch.Tensor, s_run: torch.Tensor):
    """K3's merge pass: the partials (S, N) of S consecutive key slices
    (global indices) -> (idx (N,), conf (N,)).  In increasing slice order a
    larger logit, or an equal one at a lower index, wins the argmax; the
    sums are rescaled to the overall max, s = sum_j s_j exp(m_j - m)."""
    b, a = best[0], arg[0]
    for bj, aj in zip(best[1:], arg[1:]):
        better = (bj > b) | ((bj == b) & (aj < a))
        b = torch.where(better, bj, b)
        a = torch.where(better, aj, a)
    m = m_run.max(0).values
    return a, _conf(b, m, (s_run * torch.exp(m_run - m)).sum(0))


def correspondence_argmax_plain(queries: torch.Tensor, keys: torch.Tensor, chunk: int = 2048):
    """queries (N, E), keys (M, E) -> (idx (N,) int32, conf (N,))."""
    best, arg, m_run, s_run = correspondence_partial_plain(queries, keys, chunk)
    return arg, _conf(best, m_run, s_run)


def correspondence_argmax_cuda(queries: torch.Tensor, keys: torch.Tensor):
    """K3 on the card: queries (N, E), keys (M, E) f32 -> (idx (N,) int32, conf (N,))."""
    dev = queries.device
    f32 = torch.float32
    n, e = queries.shape
    cuda_build.check(queries, "queries", f32, (None, e), dev)
    cuda_build.check(keys, "keys", f32, (None, e), dev)
    m = keys.shape[0]
    if m == 0:
        raise ValueError("correspondence_argmax: no keys")
    if e > 16:
        raise ValueError(f"correspondence kernel takes at most 16 feature dims, got {e}")
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    conf = torch.empty((n,), dtype=f32, device=dev)
    if n:
        splits, length = launch_plan(n, m, dev, "corr_argmax")
        work, work_ptr = _workspace(splits, n, 16, dev)
        with cuda_build.launch(correspondence_argmax_cuda, "corr_argmax", dev):
            cuda_build.kernels().corr_argmax(queries.data_ptr(), n, keys.data_ptr(), m, e, splits, length,
                                             work_ptr, idx.data_ptr(), conf.data_ptr(), cuda_build.stream_ptr(dev))
    return idx, conf


cuda_build.reset(correspondence_argmax_cuda)


def correspondence_argmax(queries: torch.Tensor, keys: torch.Tensor):
    """K3 for CUDA tensors, its plain version for CPU tensors."""
    if queries.device.type == "cuda":
        return correspondence_argmax_cuda(queries.contiguous(), keys.contiguous())
    if queries.device.type == "cpu":
        return correspondence_argmax_plain(queries, keys)
    raise ValueError(f"correspondence_argmax: unsupported device {queries.device}")
