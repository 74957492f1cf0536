"""Kernels K1-K6 on the card against their plain PyTorch versions, at the
shapes the serving path and the NeRF train steps give them; descriptor
training's bit-reproducibility and the command-line program on the card.  Marked ``gpu``:
they skip where torch.cuda is unavailable, and build the kernels on first
use.

Run on a machine with the card:  python -m pytest tests/test_torch_gpu.py -q
"""

import os

import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel, point_kernels

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run the hand-written kernels")
    return torch.device("cuda")


def _force_splits(monkeypatch, n_splits):
    """K2 / K3 launch ``n_splits`` reference / key splits (None: as planned);
    splits past the end of M are empty."""
    if n_splits is not None:
        monkeypatch.setattr(point_kernels, "launch_plan", lambda n, m, dev, kernel: (n_splits, -(-m // n_splits)))


@pytest.mark.parametrize("cfg,n", [
    (FieldConfig(act_dtype="bfloat16"), 128 ** 3),
    (FieldConfig(act_dtype="bfloat16", embed_method="grouped"), 100_003),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16"), 4_097),
    # tiles the kernel must mask: a ragged last tile, E = 24 padded to 32 and
    # 48 of 256 units, both embeddings
    (FieldConfig(act_dtype="bfloat16"), 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", embed_method="grouped"), 77),
])
def test_density_kernel_matches_plain(cuda, cfg, n):
    # random weights: every trunk unit and both embedding halves reach the
    # output; density bias 0, since the init's -1.5 leaves every density in
    # softplus's far tail (~1e-5), where a wrong trunk barely shows
    f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(1))
    torch.nn.init.zeros_(f.density_layer.bias)
    f = f.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    pts = torch.rand((n, 3), generator=g, device=cuda) * 2.4 - 1.2
    w = field_kernel.density_weights(f)
    ladder = field_kernel.ladder_of(cfg)
    got = field_kernel.density_cuda(pts, w, ladder, cfg.softplus_beta)
    want = torch.cat([field_kernel.density_plain(p, w, ladder, cfg.softplus_beta)
                      for p in torch.split(pts, 262144)])
    torch.cuda.synchronize()
    err = (got - want).abs()
    # same rounding points; an f32 sum-order flip of one bf16 rounding of h1
    # moves a density by far less than the tolerance
    assert float(want.std()) > 1e-3
    assert float(err.max()) < 2e-2
    assert float((err > 1e-4).float().mean()) < 1e-3
    # every point's sums run in a fixed order: a second launch is bit-identical
    assert torch.equal(got, field_kernel.density_cuda(pts, w, ladder, cfg.softplus_beta))


@pytest.mark.parametrize("n,m,n_splits", [
    (50_000, 50_000, None), (20_000, 9_000, None), (1, 1, None),
    (1, 50_000, None),     # one query tile: the planner's largest split count
    (913, 20_000, None),   # the serve's shapes: a few hundred queries, tens of thousands of references
    (1_000, 5, 8),         # more splits than references: empty splits merge as (1e30, 0)
    (3_000, 50_001, 7),    # M not a multiple of the split count
])
def test_nn_kernel_matches_plain(cuda, monkeypatch, n, m, n_splits):
    _force_splits(monkeypatch, n_splits)
    g = torch.Generator(device=cuda).manual_seed(n + m)
    q = torch.randn((n, 3), generator=g, device=cuda)
    r = torch.randn((m, 3), generator=g, device=cuda)
    mask = torch.rand((m,), generator=g, device=cuda) > 0.2
    mask[0] = True
    d_k, i_k = point_kernels.nn_min_cuda(q, r, mask)
    d_p, i_p = point_kernels.nn_min_plain(q, r, mask)
    torch.cuda.synchronize()
    # the same unfused f32 operations in the same order, and a merge whose
    # minimum and lowest-index rule do not depend on the split: bit-identical
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k, d_p)
    d_2, i_2 = point_kernels.nn_min_cuda(q, r, mask)
    assert torch.equal(d_2, d_k) and torch.equal(i_2, i_k)


@pytest.mark.parametrize("n_splits", [None, 2, 5])
def test_nn_kernel_edge_cases(cuda, monkeypatch, n_splits):
    _force_splits(monkeypatch, n_splits)
    g = torch.Generator(device=cuda).manual_seed(7)
    n, m = 913, 20_000
    q = torch.randn((n, 3), generator=g, device=cuda)
    r = torch.randn((m, 3), generator=g, device=cuda)
    # every reference masked: dist sqrt(1e30), index 0, as the plain version
    none = torch.zeros((m,), dtype=torch.bool, device=cuda)
    d_k, i_k = point_kernels.nn_min_cuda(q, r, none)
    d_p, i_p = point_kernels.nn_min_plain(q, r, none)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p) and not bool(i_k.any())
    # exact duplicates on both sides of a split boundary (and at the ends of
    # a shared tile), the query on them: the lowest index wins
    splits, length = point_kernels.launch_plan(n, m, q.device, "nn_min")
    assert splits > 1
    # the last: a shared tile's end inside split 1 where a split is longer than a tile
    bounds = (length, length * (splits - 1), length + 256)
    for j, b in enumerate(bounds):
        r[b] = r[b - 1]
        q[j] = r[b]
    d_k, i_k = point_kernels.nn_min_cuda(q, r)
    d_p, i_p = point_kernels.nn_min_plain(q, r)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    assert i_k[:3].tolist() == [b - 1 for b in bounds]


def _corr_matches(q, k, i_k, c_k):
    i_p, c_p = point_kernels.correspondence_argmax_plain(q, k)
    torch.cuda.synchronize()
    # f32 dots in another order: an index may differ only between keys whose
    # logits tie to within 1e-5
    diff = i_k != i_p
    lk = (q[diff] * k[i_k[diff].long()]).sum(-1)
    lp = (q[diff] * k[i_p[diff].long()]).sum(-1)
    assert float((lk - lp).abs().max()) < 1e-5 if bool(diff.any()) else True
    assert float(diff.float().mean()) < 1e-3
    # the kernel's f64 running sum reads 1.907e-06 at every shape here; an
    # f32 one drifted to 1.335e-05 at 45,000 x 80,000
    assert float((c_k - c_p).abs().max()) < 5e-6


@pytest.mark.parametrize("n,m,n_splits", [
    (5_625, 80_000, None), (5_625 * 8, 20_480, None), (3, 5, None),
    (5_625 * 8, 80_000, None),  # 8 crops against a real object's 80,000 keys
    (5_625 * 8, 1_024, None),   # the serve's launch: 8 crops against the padded baked keys
    (100, 5, 8),                # more splits than keys
])
def test_corr_kernel_matches_plain(cuda, monkeypatch, n, m, n_splits):
    _force_splits(monkeypatch, n_splits)
    g = torch.Generator(device=cuda).manual_seed(n)
    q = torch.randn((n, 12), generator=g, device=cuda)
    k = torch.randn((m, 12), generator=g, device=cuda)
    i_k, c_k = point_kernels.correspondence_argmax_cuda(q, k)
    _corr_matches(q, k, i_k, c_k)
    # each logit's fmaf chain and the merge order are fixed: bit-identical
    i_2, c_2 = point_kernels.correspondence_argmax_cuda(q, k)
    assert torch.equal(i_2, i_k) and torch.equal(c_2, c_k)


@pytest.mark.parametrize("e", [12, 5])
def test_corr_kernel_first_occurrence_across_splits(cuda, e):
    g = torch.Generator(device=cuda).manual_seed(e)
    n, m = 2_000, 30_000
    q = torch.randn((n, e), generator=g, device=cuda)
    k = torch.randn((m, e), generator=g, device=cuda)
    splits, length = point_kernels.launch_plan(n, m, q.device, "corr_argmax")
    assert splits > 1
    # duplicated keys on both sides of split boundaries, each pair the
    # argmax of a query with an exact logit (3 e, > 6 sigma above the random
    # keys'; the other pair's logit is at most 3): the first occurrence wins
    bounds = (length, length * (splits - 1))
    for j, b in enumerate(bounds):
        pattern = torch.ones((e,), device=cuda)
        pattern[(e + 1) // 2:] = 1.0 - 2.0 * j
        k[b - 1] = k[b] = 3.0 * pattern
        q[j] = pattern
    i_k, c_k = point_kernels.correspondence_argmax_cuda(q, k)
    assert i_k[:2].tolist() == [b - 1 for b in bounds]
    _corr_matches(q, k, i_k, c_k)


def _bundle_inputs(cfg, n_halves, R, P, dev, seed):
    """Random full fields (density bias 0, so densities spread over (0, 1))
    and rays through the object's box from a sphere of radius 4."""
    fields = []
    for h in range(n_halves):
        f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(seed + h))
        torch.nn.init.zeros_(f.density_layer.bias)
        fields.append(f.to(dev))
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randn((n_halves, R, 3), generator=g, device=dev)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.1 * torch.randn((n_halves, R, 3), generator=g, device=dev)
    lengths = torch.sort(2.0 + 4.0 * torch.rand((n_halves, R, P), generator=g, device=dev), -1).values
    pts = (o[:, :, None] + d[:, :, None] * lengths[..., None]).contiguous()
    dn = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    col = torch.rand((n_halves, R, 3), generator=g, device=dev)
    sil = (torch.rand((n_halves, R, 1), generator=g, device=dev) > 0.5).float()
    valid = torch.ones_like(sil)
    valid[:, ::7] = 0.0  # rows that must contribute nothing
    tgt = torch.cat([col, sil, valid, torch.zeros_like(col)], -1).contiguous()
    weights = tuple(torch.stack(b) for b in zip(*(field_kernel.loss_weights(f) for f in fields)))
    fm = torch.from_numpy(field_kernel.fmat_of(cfg)).to(dev)
    return pts, dn, tgt, fm, weights, field_kernel.ladder_of(cfg)


@pytest.mark.parametrize("cfg,n_halves,R,P", [
    (FieldConfig(act_dtype="bfloat16"), 2, 1201, 64),
    (FieldConfig(act_dtype="bfloat16"), 2, 601, 320),
    (FieldConfig(act_dtype="bfloat16", embed_method="grouped"), 1, 1201, 64),
    (FieldConfig(act_dtype="bfloat16", embed_method="grouped"), 2, 257, 320),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16"), 2, 37, 12),
    # the train step's fine shape, and tiles the kernel must mask: P not a
    # multiple of 64, E = 24 padded to 32 with 48 of 256 units, both embeddings
    (FieldConfig(act_dtype="bfloat16"), 2, 1200, 320),
    (FieldConfig(act_dtype="bfloat16"), 2, 5, 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16"), 2, 5, 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", embed_method="grouped"), 1, 9, 77),
])
def test_bundle_loss_kernel_matches_plain(cuda, cfg, n_halves, R, P):
    pts, dn, tgt, fm, weights, ladder = _bundle_inputs(cfg, n_halves, R, P, cuda, R + P)
    args = (pts, dn, tgt, fm, weights, ladder, cfg.softplus_beta, 0.1, 500.0 / R, True)
    gk, lk, wk = field_kernel.bundle_loss_cuda(*args)
    gp, lp, wp = field_kernel.bundle_loss_plain(*args)
    torch.cuda.synchronize()
    # same rounding points, f32 sums in another order: a flipped bf16
    # rounding moves a point's activation by one bf16 ulp
    assert torch.allclose(lk, lp, rtol=1e-3, atol=0), (lk, lp)
    assert float((wk - wp).abs().max()) < 1e-3
    for name, a, b in zip(field_kernel.LOSS_BLOCKS, gk, gp):
        s = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) / s < 3e-2, name
    # fixed-order sums: a second launch is bit-identical
    gk2, lk2, wk2 = field_kernel.bundle_loss_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk2)) and torch.equal(lk, lk2) and torch.equal(wk, wk2)
    # rows with valid = 0 change nothing
    tgt2 = tgt.clone()
    tgt2[:, ::7, :4] = torch.rand_like(tgt2[:, ::7, :4])
    gk3, lk3, _ = field_kernel.bundle_loss_cuda(pts, dn, tgt2, *args[3:])
    assert all(torch.equal(a, b) for a, b in zip(gk, gk3)) and torch.equal(lk, lk3)


FIELD_COLOR_CASES = [  # cfg, halves, rays, points: a chunk's shapes, ragged R, both embeddings
    (FieldConfig(act_dtype="bfloat16"), 1, 4096, 64),
    (FieldConfig(act_dtype="bfloat16"), 2, 704, 320),
    (FieldConfig(act_dtype="bfloat16", embed_method="grouped"), 1, 1001, 320),
    (FieldConfig(act_dtype="bfloat16", embed_method="grouped"), 2, 257, 64),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16"), 2, 37, 12),
    # tiles the kernels must mask, as K4's cases: P not a multiple of 64,
    # E = 24 padded to 32 with 48 of 256 units, the grouped embedding, and
    # the ragged last chunk of a 4,800-ray step alone
    (FieldConfig(act_dtype="bfloat16"), 2, 5, 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16"), 2, 5, 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", embed_method="grouped"), 1, 9, 77),
    (FieldConfig(act_dtype="bfloat16"), 1, 704, 320),
]


@pytest.mark.parametrize("cfg,n_halves,R,P", FIELD_COLOR_CASES)
def test_field_color_kernels_match_plain(cuda, cfg, n_halves, R, P):
    pts, dn, _, fm, weights, ladder = _bundle_inputs(cfg, n_halves, R, P, cuda, R + P)
    beta = cfg.softplus_beta
    dk, rk, res_k = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta)
    dp, rp, res_p = field_kernel.field_color_fwd_plain(pts, dn, fm, weights, ladder, beta)
    torch.cuda.synchronize()
    # K5: the same rounding points, f32 sums in another order.  The tensor
    # cores' sum order flips some bf16 roundings of the residuals; a head
    # moves by more than 1e-4 only at a point whose rounded input differs
    # (dens reads h1, rgb reads c1), and from K5's own residual it agrees
    # to f32 sums
    assert float(dp.std()) > 1e-3
    for k in field_kernel.RESIDUALS:
        assert res_k[k].dtype == torch.bfloat16 and res_k[k].shape == res_p[k].shape, k
        assert float((res_k[k] != res_p[k]).float().mean()) < 1e-2, k
    heads = field_kernel.field_color_heads(res_k, weights, beta)
    for got, want, src, own in ((dk, dp, "h1", heads[0]), (rk, rp, "c1", heads[1])):
        err = (got - want).abs()
        assert float(err.max()) < 2e-2
        assert float((got - own).abs().max()) < 1e-5, src
        assert not ((err > 1e-4).any(-1) & ~(res_k[src] != res_p[src]).any(-1)).any(), src
    # K6 on the kernel's own residuals and random cotangents: each block
    # within 3e-2 of its max |g|, the reference's own bar for its kernels
    g = torch.Generator(device=cuda).manual_seed(R)
    gdens = torch.randn(dk.shape, generator=g, device=cuda)
    grgb = torch.randn(rk.shape, generator=g, device=cuda)
    args = (dn, fm, weights, res_k, dk, rk, gdens, grgb, ladder, beta)
    gk = field_kernel.field_color_bwd_cuda(*args)
    gp = field_kernel.field_color_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(field_kernel.LOSS_BLOCKS, gk, gp):
        assert a.shape == b.shape, name
        s = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) / s < 3e-2, name
    # no atomics, fixed-order sums: a second launch of each is bit-identical
    dk2, rk2, res_k2 = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta)
    gk2 = field_kernel.field_color_bwd_cuda(*args)
    assert torch.equal(dk, dk2) and torch.equal(rk, rk2)
    assert all(torch.equal(res_k[k], res_k2[k]) for k in field_kernel.RESIDUALS)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk2))
    # K6 reads K5's records: named residuals alone are refused
    loose = {k: res_k[k] for k in field_kernel.RESIDUALS}
    with pytest.raises(ValueError, match="record"):
        field_kernel.field_color_bwd_cuda(dn, fm, weights, loose, *args[4:])


@pytest.mark.parametrize("cfg,n_halves,R,P", [
    (FieldConfig(act_dtype="bfloat16"), 2, 1200, 64),
    (FieldConfig(act_dtype="bfloat16", embed_method="grouped"), 2, 301, 320),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16"), 2, 5, 77),
])
def test_bundle_loss_and_field_color_share_the_forward_tile(cuda, cfg, n_halves, R, P):
    """K4's pass A and K5 run the same tile code (field_tc.cuh): a ray's
    first EA weight, (1 - exp(-raw_0)) exp(raw_0 - raw_0), is its first
    density bit for bit; and K4 stays within its bars of its plain version
    with bit-identical relaunches."""
    pts, dn, tgt, fm, weights, ladder = _bundle_inputs(cfg, n_halves, R, P, cuda, R + P)
    beta = cfg.softplus_beta
    args = (pts, dn, tgt, fm, weights, ladder, beta, 0.1, 500.0 / R, True)
    gk, lk, wk = field_kernel.bundle_loss_cuda(*args)
    dens, _, _ = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta)
    torch.cuda.synchronize()
    assert torch.equal(wk[:, :, 0], dens[:, :, 0, 0])
    gp, lp, wp = field_kernel.bundle_loss_plain(*args)
    assert torch.allclose(lk, lp, rtol=1e-3, atol=0) and float((wk - wp).abs().max()) < 1e-3
    for name, a, b in zip(field_kernel.LOSS_BLOCKS, gk, gp):
        assert float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3) < 3e-2, name
    gk2, lk2, wk2 = field_kernel.bundle_loss_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk2)) and torch.equal(lk, lk2) and torch.equal(wk, wk2)


@pytest.mark.parametrize("embed", ["direct", "grouped"])
def test_field_color_autograd_on_card_matches_plain(cuda, embed, monkeypatch):
    """FieldColor through K5/K6 against the same Function through the plain
    versions on the card: the fields' parameter grads."""
    cfg = FieldConfig(act_dtype="bfloat16", embed_method=embed)
    R, P = 300, 64
    pts, dn, _, _, _, _ = _bundle_inputs(cfg, 2, R, P, cuda, 7)
    grads = []
    for plain in (False, True):
        fields = []
        for h in range(2):
            f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(7 + h))
            torch.nn.init.zeros_(f.density_layer.bias)
            fields.append(f.to(cuda))
        if plain:
            monkeypatch.setattr(field_kernel, "field_color_fwd_op", field_kernel.field_color_fwd_plain)
            monkeypatch.setattr(field_kernel, "field_color_bwd_op", field_kernel.field_color_bwd_plain)
        before = (field_kernel.field_color_fwd_cuda.launches, field_kernel.field_color_bwd_cuda.launches)
        dens, rgb = field_kernel.field_color(fields, pts, dn, cfg)
        ((dens * 0.7).sum() / R + (rgb * torch.cos(rgb)).sum() / R).backward()
        launched = (field_kernel.field_color_fwd_cuda.launches - before[0],
                    field_kernel.field_color_bwd_cuda.launches - before[1])
        assert launched == ((0, 0) if plain else (1, 1))
        grads.append({(h, n): p.grad for h, f in enumerate(fields) for n, p in f.named_parameters()})
    torch.cuda.synchronize()
    for key, a in grads[0].items():
        b = grads[1][key]
        if key[1].startswith("feature_layer"):
            assert a is None and b is None
            continue
        s = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) / s < 3e-2, key


# ------------------------------------------- the correspondence stage's shapes


def _silhouette_rays(cuda, S=224, P=256):
    """The front pass of one synthetic view: rays through its silhouette's
    pixels (~15,000 at 224 px) x 256 depths, as generate_cors builds them."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import generate_cors

    scene = synthetic.make_scene(2, S, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    cam = cam_lib.camera_from_bop(scene.R_bop, scene.t_bop, scene.K, S)[0]
    pix = torch.as_tensor(generate_cors.silhouette_pixels(scene.sils[0].cpu().numpy()), device=cuda)
    z = scene.t_bop[:, 2].abs()
    bundle = cam_lib.rays_at_pixels(cam, pix, S, P, float(z.min()) - 2.0, float(z.max()) + 2.0)
    return cam_lib.ray_points(bundle).reshape(-1, 3).contiguous()


def test_density_kernel_at_front_pass_batch(cuda):
    cfg = FieldConfig(act_dtype="bfloat16")
    f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(2))
    torch.nn.init.zeros_(f.density_layer.bias)
    f = f.to(cuda)
    pts = _silhouette_rays(cuda)
    assert pts.shape[0] > 1_000_000
    w = field_kernel.density_weights(f)
    got = field_kernel.density_cuda(pts, w, 0, cfg.softplus_beta)
    want = torch.cat([field_kernel.density_plain(p, w, 0, cfg.softplus_beta) for p in torch.split(pts, 262144)])
    err = (got - want).abs()
    assert float(want.std()) > 1e-3
    assert float(err.max()) < 2e-2 and float((err > 1e-4).float().mean()) < 2e-3
    assert torch.equal(got, field_kernel.density_cuda(pts, w, 0, cfg.softplus_beta))


def test_nn_kernel_at_mesh_filter_shape(cuda):
    """A view's front hits (~15,000 queries) against a denoised surface of
    ~40,000 vertices, masked: bit-identical to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((15_013, 3), generator=g, device=cuda) * 0.3
    v = torch.randn((40_021, 3), generator=g, device=cuda)
    ref = 0.5 * v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    mask = torch.rand((40_021,), generator=g, device=cuda) > 0.05
    for m in (None, mask):
        d_k, i_k = point_kernels.nn_min_cuda(q, ref, m)
        d_p, i_p = point_kernels.nn_min_plain(q, ref, m)
        assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)


def test_pose_train_step_on_card_matches_cpu(cuda):
    """One descriptor step on the card and on the CPU from copies of one
    state with the same draws (an f32 three-stage UNet at 64 px): loss to
    1e-5 rel, grads per tensor within 1e-3 of its max |g| plus 1e-5 of the
    max over all, params after the step as that grad bar allows."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import PoseTrainConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as aug_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer

    S, B, M = 64, 2, 200
    cfg = PoseTrainConfig(batch_size=B, sample_size=64, warmup_steps=2, infonce_scale=1.0, mask_loss_scale=1.0)
    aug_cfg = aug_lib.AugmentConfig(crop_res=S, min_mask_sum=10.0, p_distractor=0.5)
    scene = synthetic.make_scene(B, S, torch.Generator().manual_seed(1), device="cpu")
    gen = torch.Generator().manual_seed(2)
    xys = torch.rand((B, M, 2), generator=gen) * 2.2 - 1.1
    pos = torch.randn((B, M, 3), generator=gen) * 0.4
    valid = torch.rand((B, M), generator=gen) > 0.2
    neg = torch.randn((300, 3), generator=gen) * 0.4
    field = NerfField(FieldConfig(n_harmonic_functions=8, n_hidden=48))
    field.reset_parameters(torch.Generator().manual_seed(3))
    cnn = ResNetUNet(widths=(8, 16, 16), stage_sizes=(1, 1, 1), decoder_width=8, dtype=torch.float32)
    cpu_state = pose_trainer.init_pose_state(field, cfg, cnn.reset_parameters(torch.Generator().manual_seed(4)),
                                             device="cpu")
    card_state = pose_trainer.init_pose_state(cpu_state.field, cfg, cpu_state.cnn, device=cuda)
    draws = pose_trainer.draw_pose_step(torch.Generator().manual_seed(6), B, S, neg.shape[0], cfg, aug_cfg)
    images, sils = scene.images, scene.sils
    aug = aug_lib.augment_view(images, sils, aug_cfg, draws.aug, (torch.roll(images, 1, 0), torch.roll(sils, 1, 0)))
    sel = aug_lib.select_ray_samples(aug_lib.transform_xys(xys, aug.A, aug.t), valid, cfg.sample_size,
                                     torch.Generator().manual_seed(7))
    draws = draws._replace(sel=sel)

    def to(x):
        if isinstance(x, tuple):
            return type(x)(*(to(y) for y in x))
        return x.to(cuda) if torch.is_tensor(x) else x

    opt = pose_trainer.make_pose_optimizer(cfg)
    args = (images, sils, pos, xys, valid, neg)
    cpu_state, loss_c, _ = pose_trainer.pose_train_step(cpu_state, opt, *args, cfg, aug_cfg, draws)
    card_state, loss_g, _ = pose_trainer.pose_train_step(card_state, opt, *(to(a) for a in args), cfg, aug_cfg,
                                                         to(draws))
    torch.cuda.synchronize()
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    pairs = [(n, a, b) for mod in ("cnn", "field") for (n, a), (_, b) in
             zip(getattr(cpu_state, mod).named_parameters(), getattr(card_state, mod).named_parameters())
             if a.grad is not None]
    g_all = max(float(a.grad.abs().max()) for _, a, _ in pairs)
    for n, a, b in pairs:
        delta = 1e-3 * float(a.grad.abs().max()) + 1e-5 * g_all
        assert float((b.grad.cpu() - a.grad).abs().max()) <= delta, n
        # Adam's first step moves each param by rate * g / (|g| + eps): a grad
        # error delta moves that by at most delta * eps / (|g| - delta + eps)^2
        # of the rate (so up to the whole rate where |g| is near eps)
        rate = opt.learning_rate(cfg.lr_mlp if n.startswith("feature_layer") else cfg.lr_cnn, 0)
        eps = 1e-8
        near = (a.grad.abs() - delta).clamp_min(0.0) + eps
        bar = 1e-6 + rate * torch.clamp(delta * eps / near ** 2, max=2.0)
        assert bool(((b.detach().cpu() - a.detach()).abs() <= bar).all()), n
    assert card_state.step == cpu_state.step == 1


def test_train_pose_is_bit_reproducible_on_card(cuda):
    """Two 5-step descriptor runs from one seed on the card (a full-width
    bf16 field and ResNetUNet, 4 views at 112 px, the distractor
    augmentation): bit-identical parameters, Adam moments and losses."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import PoseTrainConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as aug_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer

    V, S, M = 4, 112, 1024
    scene = synthetic.make_scene(V, S, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    xys = torch.rand((V, M, 2), generator=g, device=cuda) * 2.0 - 1.0
    pos = torch.randn((V, M, 3), generator=g, device=cuda) * 0.4
    valid = torch.ones((V, M), dtype=torch.bool, device=cuda)
    bank = pose_trainer.RayBank(pos, xys, pos, xys, valid, valid)
    neg = torch.randn((2000, 3), generator=g, device=cuda) * 0.4
    field = NerfField(FieldConfig(act_dtype="bfloat16")).reset_parameters(torch.Generator().manual_seed(2)).to(cuda)
    cfg = PoseTrainConfig(warmup_steps=4, sample_size=256)
    aug_cfg = aug_lib.AugmentConfig(crop_res=S, min_mask_sum=10.0, p_distractor=0.5)

    def run():
        state, losses = pose_trainer.train_pose(field, scene.images, scene.sils, bank, neg, cfg=cfg, aug_cfg=aug_cfg,
                                                n_steps=5, seed=1, device=cuda)
        opt = state.opt
        return (list(state.field.parameters()) + list(state.cnn.parameters()) + opt.head_mu + opt.head_nu
                + opt.cnn_mu + opt.cnn_nu, losses)

    (a, la), (b, lb) = run(), run()
    assert la == lb and len(la) == 5
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _cli_argv(root, *extra, uh=1):
    return ["--objid", "1", "--dataset", "ruapc", "--UH", str(uh), "--root", str(root), "--synthetic",
            "--synthetic-views", "4", "--image-size", "64", "--act-dtype", "bfloat16", "--viz-every", "0",
            "--log-every", "0", *extra]


def test_cli_train_nerf_resumes_exactly_on_card(cuda, tmp_path, monkeypatch):
    """``train-nerf --act-dtype bfloat16 --steps 40`` on the card (K4 a
    pass), stopped after its step-20 checkpoint and resumed with ``--cont
    --steps 40``, equals the straight 40-step run bit for bit."""
    import functools

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import cli, config
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint

    monkeypatch.setattr(config, "NerfTrainConfig", functools.partial(config.NerfTrainConfig, ckpt_every=20))
    field_kernel.bundle_loss_cuda.launches = 0
    cli.main(["train-nerf", *_cli_argv(tmp_path / "straight", "--steps", "40")])
    assert field_kernel.bundle_loss_cuda.launches == 80          # 40 steps x (coarse + fine)

    class Stop(Exception):
        pass

    save_latest = checkpoint.save_latest

    def stop_at_20(directory, state):
        save_latest(directory, state)
        if state.step == 20:
            raise Stop

    monkeypatch.setattr(checkpoint, "save_latest", stop_at_20)
    with pytest.raises(Stop):
        cli.main(["train-nerf", *_cli_argv(tmp_path / "cut", "--steps", "40")])
    monkeypatch.setattr(checkpoint, "save_latest", save_latest)
    cli.main(["train-nerf", *_cli_argv(tmp_path / "cut", "--steps", "40", "--cont")])
    paths = [os.path.join(artifacts.nerf_dir(str(tmp_path / r / "1_ruapc_obj_1"), 1), checkpoint.STATE)
             for r in ("straight", "cut")]
    a, b = (torch.load(p, weights_only=True) for p in paths)
    assert a["step"] == b["step"] == 40 and a["count"] == b["count"] == 40
    for key in ("coarse", "fine"):
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key])
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a[key], b[key]))


def test_cli_poses_est_launches_the_correspondence_kernel(cuda, tmp_path):
    """``poses-est`` on the card (its default device) reads the baked keys
    and the CNN checkpoint and runs K3."""
    import numpy as np

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import cli
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint

    exp = str(tmp_path / "0_ruapc_obj_1")
    pose_d = artifacts.pose_dir(exp, 1)
    rng = np.random.default_rng(0)
    for name, width in (("vert1_scaled.npy", 3), ("feat1_scaled.npy", 12), ("normals_scaled.npy", 3)):
        artifacts.save_array(pose_d, name, rng.normal(size=(1024, width)).astype(np.float32))
    artifacts.save_array(pose_d, "n_keys.npy", np.asarray([1000]))
    cnn = ResNetUNet().reset_parameters(torch.Generator().manual_seed(0))
    checkpoint.save(os.path.join(pose_d, checkpoint.ENCODER), cnn.state_dict(), 3)
    point_kernels.correspondence_argmax_cuda.launches = 0
    cli.main(["poses-est", *_cli_argv(tmp_path, uh=0)])
    assert point_kernels.correspondence_argmax_cuda.launches >= 1
    pred_R = np.load(os.path.join(exp, "1pred_R.npy"))
    assert pred_R.shape == (4, 3, 3) and np.isfinite(pred_R).all()


# ------------------------------------------- SurfEmb inference and the mesh scene


def _surf_scene(S: int, subdivisions: int):
    """The blob's vertices as baked points (sharp keys, its normals), a
    planted pose, the crop camera of an S px crop and the ideal maps of
    that view (``chip_smoke.ideal_view``): CPU tensors."""
    import chip_smoke

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene

    verts, _, _, normals = (torch.as_tensor(x) for x in mesh_scene.blob_mesh(subdivisions))
    R, t, K, maps = chip_smoke.ideal_view(verts, S)
    return dict(verts=verts, normals=normals, feats=chip_smoke.sharp_features(verts), R=R, t=t, K=K, maps=maps)


def test_estimate_pose_surfemb_on_card_matches_cpu(cuda):
    """One 96 px view of the blob (2,562 keys), 2,000 hypotheses, 200
    scored, the same draws on the card and on the CPU: the distribution
    draws the same correspondences (99 % of the 8,000 draws or more; a
    draw that moves lies within 1e-6 of an edge of its CPU bin: the f32
    entries round differently on the card), the CPU's hypotheses score the
    same on the card (mask scores to 1e-5; coord scores to 1e-3 on 99 % of
    them: a z-buffer winner flips at a rounding edge), and
    ``estimate_pose_surfemb`` with 10 BFGS steps lands within 0.1 of the
    planted rotation and 5 % of its distance on both.  The hypotheses themselves are not compared slot
    for slot: on random draws many P3P triples are ill-posed, and f32
    Grunert under the card's rounding moves their roots by up to 0.2
    (ROADMAP C, P3P conditioning)."""
    import chip_smoke

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.cameras import downsample_K
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference, pose_est_surf

    sc = _surf_scene(96, 4)
    cfg = InferenceConfig(max_poses=2000, max_pose_evaluations=200)
    g = torch.Generator().manual_seed(0)
    draws = inference.SurfEmbDraws(torch.rand((2000, 4), generator=g), torch.rand((2000, 4), generator=g),
                                   torch.randperm(sc["verts"].shape[0], generator=g))
    hyp = pose_est_surf.estimate_pose(sc["maps"][..., 12], sc["maps"][..., :12], sc["verts"], sc["normals"],
                                      sc["feats"], 1.2, sc["K"], max_poses=2000, max_pose_evaluations=200,
                                      draws=pose_est_surf.HypothesisDraws(draws.u, draws.pick))
    res = {}
    for dev in ("cpu", cuda):
        on = {k: v.to(dev) for k, v in sc.items()}
        mlp, nmlp, mp = pose_est_surf.mask_terms(on["maps"][..., 12], 3)
        q = pose_est_surf._avg_pool(on["maps"][..., :12], 3).reshape(32 * 32, -1)
        corr_log, cdf = pose_est_surf.correspondence_distribution(q, on["feats"], mp, 1.5)
        idx = pose_est_surf.inverse_cdf(cdf, draws.u.to(dev))
        flat_cdf = cdf.view(-1).cpu()
        pose_est_surf._max_pool_3x3_keys(corr_log, 32)
        scores = pose_est_surf.score_poses(hyp.R.to(dev), hyp.t.to(dev), downsample_K(on["K"], 3), on["verts"],
                                           corr_log, mlp, nmlp, 32)
        est = inference.estimate_pose_surfemb(chip_smoke.ideal_cnn(on["maps"]), torch.zeros((96, 96, 3), device=dev),
                                              on["K"], on["verts"], on["normals"], on["feats"], 1.2, cfg=cfg,
                                              refine_steps=10, draws=inference.SurfEmbDraws(*(x.to(dev) for x in draws)))
        res[str(dev)] = idx.cpu(), [x.cpu() for x in scores], [torch.as_tensor(x).cpu() for x in est], flat_cdf
    (ic, sc_c, ec, cdf_c), (ig, sc_g, eg, _) = res["cpu"], res[str(cuda)]
    moved = ic != ig
    assert moved.float().mean() <= 0.01
    u = draws.u.double()[moved]
    lo = torch.where(ic[moved] > 0, cdf_c[(ic[moved] - 1).clamp_min(0)], torch.zeros_like(u))
    assert (torch.minimum((u - lo).abs(), (cdf_c[ic[moved]] - u).abs()) < 1e-6).all()
    valid = hyp.valid & torch.isfinite(sc_c[1])
    assert int(valid.sum()) >= 50
    torch.testing.assert_close(sc_g[0], sc_c[0], atol=1e-5, rtol=0)
    assert ((sc_g[1] - sc_c[1]).abs()[valid] < 1e-3).float().mean() >= 0.99
    for R, t, _ in (ec, eg):
        assert float((R - sc["R"]).abs().max()) < 0.1 and float((t - sc["t"]).abs().max()) < 0.05 * 4.0


def test_refine_pose_through_k2_matches_plain(cuda, monkeypatch):
    """The refiner's key lookup at its full shape (a 224 px query image:
    50,176 queries, 10,242 keys) through K2 and through K2's plain version
    on the card: the refined pose and objective bit for bit, K2 launched."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import rotvec_to_matrix
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine

    sc = {k: v.to(cuda) for k, v in _surf_scene(224, 5).items()}
    R0 = rotvec_to_matrix(torch.tensor([0.02, -0.015, 0.02], device=cuda)) @ sc["R"]
    t0 = sc["t"] + torch.tensor([0.01, -0.01, 0.05], device=cuda)
    sel = torch.randperm(sc["verts"].shape[0], generator=torch.Generator().manual_seed(1)).to(cuda)
    args = (R0, t0, sc["maps"][..., :12], sc["K"], sc["verts"], sc["feats"])
    point_kernels.nn_min_cuda.launches = 0
    got = pose_refine.refine_pose(*args, n_steps=10, sel=sel)
    assert point_kernels.nn_min_cuda.launches >= 1
    monkeypatch.setattr(point_kernels, "nn_min_cuda", point_kernels.nn_min_plain)
    want = pose_refine.refine_pose(*args, n_steps=10, sel=sel)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float((got[1] - t0).abs().max()) > 0


def test_surfemb_cdf_at_full_shape(cuda):
    """The SurfEmb cdf at a 224 px crop's 5,476 cells x 80,000 keys: no
    draw of 40,000 moves against an f64 running sum of the same entries
    (the port's two-level f64 cdf); a single f32 torch.cumsum is reported
    (chip_smoke.cdf_drift)."""
    import chip_smoke

    drift = chip_smoke.cdf_drift(cuda, 0, 5_476, 80_000)
    print(f"moved draws: port {drift['port']:.2e}, f32 cumsum {drift['f32']:.2e}")
    assert drift["port"] == 0.0


def test_render_mesh_on_card_matches_cpu(cuda):
    """Eight 64 px views of the blob (1,280 triangles), flat and textured:
    the silhouettes differ on at most 0.5 % of pixels (pixel centres on a
    triangle's edge), rgb and depth to 1e-4 on the rest."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene, synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import rasterize

    S = 64
    mesh = [torch.as_tensor(x) for x in mesh_scene.blob_mesh(3)]
    R, t = synthetic.random_bop_poses(8, torch.Generator().manual_seed(2), device="cpu")
    K = torch.tensor([[2.1 * S, 0.0, S / 2], [0.0, 2.1 * S, S / 2], [0.0, 0.0, 1.0]]).expand(8, 3, 3)
    for albedo_fn in (None, mesh_scene.procedural_albedo):
        out = {}
        for dev in ("cpu", cuda):
            cams = cameras.camera_from_bop(R.to(dev), t.to(dev), K.to(dev), S)
            out[str(dev)] = [x.cpu() for x in rasterize.render_mesh(*(x.to(dev) for x in mesh), cams, S,
                                                                     albedo_fn=albedo_fn)]
        (rc, sc, dc), (rg, sg, dg) = out["cpu"], out[str(cuda)]
        both = (sc > 0) & (sg > 0)
        bad = ((sc != sg) | ((rc - rg).abs().amax(-1) > 1e-4)
               | (torch.where(both, (dc - dg).abs(), torch.zeros_like(dc)) > 1e-4 * 4))
        assert float(sc.mean()) > 0.05 and float(bad.float().mean()) <= 5e-3
