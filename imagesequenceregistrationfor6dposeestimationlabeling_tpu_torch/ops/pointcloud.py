"""Point-cloud ops (counterpart of ops/pointcloud.py): nearest neighbour
through kernel K2, farthest-point sampling, Chamfer distance, and the
surface ops of the correspondence stage (k nearest neighbours, radius
outliers, PCA normals, the FPS subsample with normals).

The surface ops square distances as ``|a|^2 + |b|^2 - 2 a.b`` (a matmul),
as the reference does, in f32 with TF32 off; ``nn_query`` (K2 and its
plain version) uses exact per-coordinate differences instead.  Each op
walks the reference cloud in chunks, so no (N, M) matrix is ever whole.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib

_BIG = 1e30
# elements of one chunk's (queries x references) distance matrix
_CHUNK_ELEMS = 1 << 25
# selections captured in one CUDA graph by farthest_point_sampling on the
# card (0: a launch sequence per selection, as on the CPU)
FPS_GRAPH_BLOCK = 64


def _chunk(n: int, m: int) -> int:
    return max(1, min(m, _CHUNK_ELEMS // max(n, 1)))


def nn_query(query: torch.Tensor, ref: torch.Tensor, ref_mask: Optional[torch.Tensor] = None,
             mesh: Optional[mesh_lib.Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour of each query in ref: (dist (N,), idx (N,) int32).
    With ``mesh`` the queries split over its entries, each running K2 on
    its device against the whole reference cloud; the results come back
    to home in order, bit-identical to the unsharded call (K2 is exact and
    takes the lowest index)."""
    if ref.shape[0] == 0 or query.shape[0] == 0:
        raise ValueError(
            f"nn_query: empty cloud (query {query.shape[0]}, ref {ref.shape[0]}) "
            "— an upstream surface extraction or filter produced no points"
        )
    if mesh is None:
        return point_kernels.nn_min(query, ref, ref_mask)
    refs = mesh_lib.broadcast((ref, ref_mask), mesh)
    parts = [point_kernels.nn_min(query[s].to(d), *refs[i]) for i, d, s in mesh_lib.shards(query.shape[0], mesh)]
    return mesh_lib.gather(parts, mesh)


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, a_mask: Optional[torch.Tensor] = None,
                     b_mask: Optional[torch.Tensor] = None, mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """Bidirectional mean NN distance / 2 (Open3D-compatible Chamfer); with
    ``mesh`` both sweeps split their queries over it and the means are
    taken on home from the gathered distances."""
    d_ab, _ = nn_query(a, b, b_mask, mesh)
    d_ba, _ = nn_query(b, a, a_mask, mesh)
    ma = torch.ones_like(d_ab) if a_mask is None else a_mask.to(d_ab.dtype)
    mb = torch.ones_like(d_ba) if b_mask is None else b_mask.to(d_ba.dtype)
    mean_ab = (d_ab * ma).sum() / ma.sum().clamp_min(1.0)
    mean_ba = (d_ba * mb).sum() / mb.sum().clamp_min(1.0)
    return (mean_ab + mean_ba) / 2.0


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3) x (M, 3) -> (N, M) squared distances |a|^2 + |b|^2 - 2 a.b,
    clamped at 0."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    with no_tf32():
        cross = a @ b.T
    return torch.clamp_min(a2 + b2.T - 2.0 * cross, 0.0)


@torch.no_grad()
def knn(query: torch.Tensor, ref: torch.Tensor, k: int, ref_mask: Optional[torch.Tensor] = None):
    """The k nearest masked references of each query: (dist (N, k), idx (N,
    k) int64), nearest first.  Ties may come in any order."""
    n, m = query.shape[0], ref.shape[0]
    best_d = torch.full((n, k), _BIG, dtype=torch.float32, device=query.device)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=query.device)
    chunk = _chunk(n, m)
    for s in range(0, m, chunk):
        d = pairwise_sqdist(query, ref[s : s + chunk])
        if ref_mask is not None:
            d = torch.where(ref_mask[None, s : s + chunk], d, torch.full_like(d, _BIG))
        cd, ci = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        cand_d = torch.cat([best_d, cd], 1)
        cand_i = torch.cat([best_i, ci + s], 1)
        best_d, sel = torch.topk(cand_d, k, dim=1, largest=False)
        best_i = cand_i.gather(1, sel)
    return torch.sqrt(best_d), best_i


@torch.no_grad()
def radius_outlier_mask(pts: torch.Tensor, nb_points: int, radius: float,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Open3D's remove_radius_outlier: keep the points with at least
    ``nb_points`` other points within ``radius``; (N,) bool."""
    n = pts.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=pts.device) if mask is None else mask.bool()
    counts = torch.zeros(n, dtype=torch.int64, device=pts.device)
    chunk = _chunk(n, n)
    for s in range(0, n, chunk):
        within = (pairwise_sqdist(pts, pts[s : s + chunk]) <= radius * radius) & valid[None, s : s + chunk]
        counts += within.sum(-1)
    return (counts - 1 >= nb_points) & valid


@torch.no_grad()
def estimate_normals(pts: torch.Tensor, k: int = 64, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PCA normals (N, 3): the eigenvector of the smallest eigenvalue of each
    point's k-neighbourhood covariance, unoriented."""
    _, idx = knn(pts, pts, k, ref_mask=mask)
    nbrs = pts[idx]                                             # (N, k, 3)
    x = nbrs - nbrs.mean(1, keepdim=True)
    with no_tf32():
        cov = torch.einsum("nki,nkj->nij", x, x) / k
    return torch.linalg.eigh(cov).eigenvectors[..., 0]


@torch.no_grad()
def subsample_surface(pts: torch.Tensor, n_fps: int, normals_k: int, mask: Optional[torch.Tensor] = None):
    """``n_fps`` farthest points of the cloud and their PCA normals over
    ``normals_k`` neighbours, oriented away from the subsample's centroid:
    (sub (n_fps, 3), normals (n_fps, 3), idx (n_fps,))."""
    idx = farthest_point_sampling(pts, n_fps, mask)
    sub = pts[idx]
    normals = estimate_normals(sub, k=min(normals_k, n_fps))
    outward = (normals * (sub - sub.mean(0, keepdim=True))).sum(-1, keepdim=True)
    return sub, normals * torch.where(outward >= 0, 1.0, -1.0), idx


@torch.no_grad()
def farthest_point_sampling(pts: torch.Tensor, n_samples: int,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices (n_samples,) of farthest points, starting from the first
    valid point: iterative argmax over the running min distance.  The
    selected index never goes to the host.  On the card, after the first
    selection, blocks of ``FPS_GRAPH_BLOCK`` selections are captured once in
    a CUDA graph and replayed (the same launches, without the host's
    per-launch time)."""
    n = pts.shape[0]
    dev = pts.device
    valid = torch.ones(n, dtype=torch.bool, device=dev) if mask is None else mask.bool()
    last = torch.argmax(valid.to(torch.int32)).view(1)
    idxs = torch.empty(max(n_samples, 0), dtype=torch.int64, device=dev)
    if n_samples <= 0:
        return idxs
    idxs[0:1] = last
    min_d = torch.full((n,), _BIG, dtype=pts.dtype, device=dev)
    neg = torch.full_like(min_d, -1.0)

    def select(out: torch.Tensor):
        d = (pts - pts.index_select(0, last)).square().sum(-1)
        torch.minimum(min_d, d, out=min_d)
        last.copy_(torch.argmax(torch.where(valid, min_d, neg)).view(1))
        out.copy_(last)

    block = FPS_GRAPH_BLOCK if dev.type == "cuda" else 0
    if block <= 0 or n_samples <= 2:
        for i in range(1, n_samples):
            select(idxs[i : i + 1])
        return idxs
    select(idxs[1:2])                   # eager: also warms the launches up before capture
    blk = torch.empty(block, dtype=torch.int64, device=dev)
    graph = torch.cuda.CUDAGraph()
    # captured on a side stream directly (torch.cuda.graph would also
    # collect garbage and empty the allocator's cache, tens of ms)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph.capture_begin()
        for j in range(block):
            select(blk[j : j + 1])
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    for i0 in range(2, n_samples, block):
        graph.replay()
        take = min(block, n_samples - i0)
        idxs[i0 : i0 + take] = blk[:take]
    return idxs
