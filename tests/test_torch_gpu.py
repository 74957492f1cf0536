"""Kernels K1-K6 on the card against their plain PyTorch versions, at the
shapes the serving path and the NeRF train steps give them.  Marked ``gpu``:
they skip where torch.cuda is unavailable, and build the kernels on first
use.

Run on a machine with the card:  python -m pytest tests/test_torch_gpu.py -q
"""

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


@pytest.mark.parametrize("n,m", [(50_000, 50_000), (20_000, 9_000), (1, 1)])
def test_nn_kernel_matches_plain(cuda, n, m):
    g = torch.Generator(device=cuda).manual_seed(n + m)
    q = torch.randn((n, 3), generator=g, device=cuda)
    r = torch.randn((m, 3), generator=g, device=cuda)
    mask = torch.rand((m,), generator=g, device=cuda) > 0.2
    mask[0] = True
    d_k, i_k = point_kernels.nn_min_cuda(q, r, mask)
    d_p, i_p = point_kernels.nn_min_plain(q, r, mask)
    torch.cuda.synchronize()
    # the same unfused f32 operations in the same order: bit-identical
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k, d_p)


@pytest.mark.parametrize("n,m", [(5_625, 80_000), (5_625 * 8, 20_480), (3, 5)])
def test_corr_kernel_matches_plain(cuda, n, m):
    g = torch.Generator(device=cuda).manual_seed(n)
    q = torch.randn((n, 12), generator=g, device=cuda)
    k = torch.randn((m, 12), generator=g, device=cuda)
    i_k, c_k = point_kernels.correspondence_argmax_cuda(q, k)
    i_p, c_p = point_kernels.correspondence_argmax_plain(q, k)
    torch.cuda.synchronize()
    # f32 dots in another order: an index may differ only between keys whose
    # logits tie to within 1e-5
    diff = i_k != i_p
    lk = (q[diff] * k[i_k[diff].long()]).sum(-1)
    lp = (q[diff] * k[i_p[diff].long()]).sum(-1)
    assert float((lk - lp).abs().max()) < 1e-5 if bool(diff.any()) else True
    assert float(diff.float().mean()) < 1e-3
    assert float((c_k - c_p).abs().max()) < 1e-4


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
]


@pytest.mark.parametrize("cfg,n_halves,R,P", FIELD_COLOR_CASES)
def test_field_color_kernels_match_plain(cuda, cfg, n_halves, R, P):
    pts, dn, _, fm, weights, ladder = _bundle_inputs(cfg, n_halves, R, P, cuda, R + P)
    beta = cfg.softplus_beta
    dk, rk, res_k = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta)
    dp, rp, res_p = field_kernel.field_color_fwd_plain(pts, dn, fm, weights, ladder, beta)
    torch.cuda.synchronize()
    # K5: the same rounding points, f32 sums in another order; a flipped
    # bf16 rounding of a hidden value moves its point's outputs slightly
    assert float(dp.std()) > 1e-3
    for got, want in ((dk, dp), (rk, rp)):
        err = (got - want).abs()
        assert float(err.max()) < 2e-2 and float((err > 1e-4).float().mean()) < 1e-3
    for k in field_kernel.RESIDUALS:
        assert res_k[k].dtype == torch.bfloat16 and res_k[k].shape == res_p[k].shape, k
        assert float((res_k[k] != res_p[k]).float().mean()) < 1e-2, k
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
