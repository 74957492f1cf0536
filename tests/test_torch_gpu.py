"""Kernels K1-K6 on the card against their plain PyTorch versions, at the
shapes the serving path and the NeRF train steps give them, and their
products on the tensor cores; descriptor training's bit-reproducibility,
the command-line program and the synthetic chain end to end on the card.
Marked ``gpu``: they skip where torch.cuda is unavailable, and build the
kernels on first use.

Run on a machine with the card:  python -m pytest tests/test_torch_gpu.py -q
"""

import contextlib
import copy
import hashlib
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField, softplus_beta
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import eval_features as eval_keys
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build, field_kernel, point_kernels

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


def _by_name(wrapper, *names) -> tuple:
    """``wrapper``'s launches under each launch name (a kernel's variants)."""
    return tuple(wrapper.by_name.get(n, 0) for n in names)


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
    # the float32-activation variant (FieldConfig()'s default) at the same
    # shapes: the train step's coarse and fine passes, the grouped ladder,
    # masked tiles
    (FieldConfig(), 2, 1201, 64),
    (FieldConfig(), 2, 1200, 320),
    (FieldConfig(embed_method="grouped"), 2, 257, 320),
    (FieldConfig(), 2, 5, 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48), 2, 5, 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, embed_method="grouped"), 1, 9, 77),
])
def test_bundle_loss_kernel_matches_plain(cuda, cfg, n_halves, R, P):
    """K4 (the variant of the field's ``act_dtype``) against its plain
    version; the float32 variant's loss and EA weights are the bf16
    variant's bit for bit (one forward), and its launches count apart."""
    pts, dn, tgt, fm, weights, ladder = _bundle_inputs(cfg, n_halves, R, P, cuda, R + P)
    args = (pts, dn, tgt, fm, weights, ladder, cfg.softplus_beta, 0.1, 500.0 / R, True, cfg.act_dtype)
    counted = _by_name(field_kernel.bundle_loss_cuda, "bundle_loss", "bundle_loss_act32")
    gk, lk, wk = field_kernel.bundle_loss_cuda(*args)
    gp, lp, wp = field_kernel.bundle_loss_plain(*args)
    torch.cuda.synchronize()
    act32 = cfg.act_dtype == "float32"
    launched = _by_name(field_kernel.bundle_loss_cuda, "bundle_loss", "bundle_loss_act32")
    assert tuple(a - b for a, b in zip(launched, counted)) == ((0, 1) if act32 else (1, 0))
    if act32:
        _, lb, wb = field_kernel.bundle_loss_cuda(*args[:-1], "bfloat16")
        assert torch.equal(lk, lb) and torch.equal(wk, wb)
        gaps = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3) for a, b in zip(gk, gp)]
        print(f"float32-activation K4 {n_halves} x {R} x {P}: grads {max(gaps):.3e} of a block's max "
              f"({field_kernel.LOSS_BLOCKS[gaps.index(max(gaps))]}), loss rel "
              f"{float(((lk - lp).abs() / lp.abs().clamp_min(1e-12)).max()):.3e}, w {float((wk - wp).abs().max()):.3e}")
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


FIELD_COLOR_CASES = [  # cfg, halves, rays, points: a chunk's shapes, ragged R, both embeddings; both activation dtypes
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
    (FieldConfig(act_dtype="bfloat16"), 1, 4096, 320),
    (FieldConfig(), 1, 4096, 64),
    (FieldConfig(), 1, 4096, 320),
    (FieldConfig(), 2, 704, 320),
    (FieldConfig(embed_method="grouped"), 2, 257, 64),
    (FieldConfig(), 2, 5, 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48), 2, 5, 77),
    (FieldConfig(n_harmonic_functions=8, n_hidden=48, embed_method="grouped"), 1, 9, 77),
]


@pytest.mark.parametrize("cfg,n_halves,R,P", FIELD_COLOR_CASES)
def test_field_color_kernels_match_plain(cuda, cfg, n_halves, R, P):
    """K5 / K6 (the variant of the field's ``act_dtype``) against their
    plain versions; the float32 variant's heads are the bf16 variant's bit
    for bit, and its f32 residuals the unrounded activations."""
    pts, dn, _, fm, weights, ladder = _bundle_inputs(cfg, n_halves, R, P, cuda, R + P)
    beta, act = cfg.softplus_beta, cfg.act_dtype
    dk, rk, res_k = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta, act)
    dp, rp, res_p = field_kernel.field_color_fwd_plain(pts, dn, fm, weights, ladder, beta, act)
    torch.cuda.synchronize()
    # K5: the same rounding points, f32 sums in another order.  The tensor
    # cores' sum order flips some bf16 roundings of the residuals; a head
    # moves by more than 1e-4 only at a point whose rounded input differs
    # (dens reads h1, rgb reads c1), and from K5's own residual it agrees
    # to f32 sums
    assert float(dp.std()) > 1e-3
    rounded = {k: (res_k[k].to(torch.bfloat16), res_p[k].to(torch.bfloat16)) for k in field_kernel.RESIDUALS}
    for k in field_kernel.RESIDUALS:
        want = torch.float32 if act == "float32" and k in ("h1", "h2", "c1") else torch.bfloat16
        assert res_k[k].dtype == res_p[k].dtype == want and res_k[k].shape == res_p[k].shape, k
        assert float((rounded[k][0] != rounded[k][1]).float().mean()) < 1e-2, k
        if want == torch.float32:
            close = (res_k[k] - res_p[k]).abs() <= 1e-5 + 1e-5 * res_p[k].abs()
            assert float(close.float().mean()) > 0.98, k
    if act == "float32":
        db, rb, _ = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta, "bfloat16")
        assert torch.equal(dk, db) and torch.equal(rk, rb)
    heads = field_kernel.field_color_heads(res_k, weights, beta)
    for got, want, src, own in ((dk, dp, "h1", heads[0]), (rk, rp, "c1", heads[1])):
        err = (got - want).abs()
        assert float(err.max()) < 2e-2
        assert float((got - own).abs().max()) < 1e-5, src
        assert not ((err > 1e-4).any(-1) & ~(rounded[src][0] != rounded[src][1]).any(-1)).any(), src
    # K6 on the kernel's own residuals and random cotangents: each block
    # within 3e-2 of its max |g|, the reference's own bar for its kernels
    g = torch.Generator(device=cuda).manual_seed(R)
    gdens = torch.randn(dk.shape, generator=g, device=cuda)
    grgb = torch.randn(rk.shape, generator=g, device=cuda)
    args = (dn, fm, weights, res_k, dk, rk, gdens, grgb, ladder, beta, act)
    gk = field_kernel.field_color_bwd_cuda(*args)
    gp = field_kernel.field_color_bwd_plain(*args)
    torch.cuda.synchronize()
    gaps = []
    for name, a, b in zip(field_kernel.LOSS_BLOCKS, gk, gp):
        assert a.shape == b.shape, name
        s = max(float(b.abs().max()), 1e-3)
        gaps.append(float((a - b).abs().max()) / s)
        assert gaps[-1] < 3e-2, name
    if act == "float32":
        print(f"float32-activation K6 {n_halves} x {R} x {P}: grads {max(gaps):.3e} of a block's max "
              f"({field_kernel.LOSS_BLOCKS[gaps.index(max(gaps))]})")
    # no atomics, fixed-order sums: a second launch of each is bit-identical
    dk2, rk2, res_k2 = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta, act)
    gk2 = field_kernel.field_color_bwd_cuda(*args)
    assert torch.equal(dk, dk2) and torch.equal(rk, rk2)
    assert all(torch.equal(res_k[k], res_k2[k]) for k in field_kernel.RESIDUALS)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk2))
    # K6 reads K5's records: named residuals alone are refused
    loose = {k: res_k[k] for k in field_kernel.RESIDUALS}
    with pytest.raises(ValueError, match="record"):
        field_kernel.field_color_bwd_cuda(dn, fm, weights, loose, *args[4:])
    if act == "float32":  # and the float32 variant its f32 record too
        with pytest.raises(ValueError, match="acts"):
            field_kernel.field_color_bwd_cuda(dn, fm, weights, {"record": res_k["record"]}, *args[4:])


# the device functions of each kernel in the built extension (K4 and K6 are
# two each: the tile kernel and the weight-grad contraction kernel they
# share; each float32-activation variant has a tile kernel of its own)
DEVICE_FUNCTIONS = {
    "density": ("density_kernel",),
    "nn_min": ("nn_min_kernel", "nn_min_merge_kernel"),
    "corr_argmax": ("corr_argmax_kernel", "corr_argmax_merge_kernel"),
    "bundle_loss": ("bundle_loss_kernel", "dw_kernel"),
    "field_color_fwd": ("field_color_fwd_kernel",),
    "field_color_bwd": ("field_color_bwd_kernel", "dw_kernel"),
    "bundle_loss_act32": ("bundle_loss_act32_kernel", "dw_kernel"),
    "field_color_fwd_act32": ("field_color_fwd_act32_kernel",),
    "field_color_bwd_act32": ("field_color_bwd_act32_kernel", "dw_kernel"),
}
# the kernels whose products must run on the tensor cores: K1, K4-K6
TENSOR_CORE_KERNELS = ("density", "bundle_loss", "field_color_fwd", "field_color_bwd", "bundle_loss_act32",
                       "field_color_fwd_act32", "field_color_bwd_act32")


def test_field_kernels_run_on_the_tensor_cores(cuda):
    """Each device function of ``DEVICE_FUNCTIONS`` is found once in the
    built extension's SASS (``cuobjdump -sass``), and every one of K1, K4,
    K5, K6, their float32-activation variants and ``dw_kernel`` holds HMMA /
    HGMMA instructions."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        pytest.skip("needs cuobjdump (the CUDA toolkit) to read the extension's SASS")
    sass = subprocess.run([tool, "-sass", cuda_build.kernels().__file__], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    per_function, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            per_function[current] = 0
        elif current is not None and ("HMMA" in line or "HGMMA" in line):
            per_function[current] += 1
    counts = {}
    for name, functions in DEVICE_FUNCTIONS.items():
        for fn in functions:
            hits = [n for k, n in per_function.items() if fn in k]
            assert len(hits) == 1, (fn, hits)
            counts[name, fn] = hits[0]
    print("tensor-core instructions in SASS:", counts)
    for name in TENSOR_CORE_KERNELS:
        for fn in DEVICE_FUNCTIONS[name]:
            assert counts[name, fn] > 0, (name, fn)


def test_fps_graphs_select_what_the_launch_sequence_selects(cuda, monkeypatch):
    """Farthest-point sampling of all of 20,000 points near a shell (the
    bake's key count) on the card: its selections replayed from CUDA graphs
    of ``FPS_GRAPH_BLOCK`` (the program's path; the last block ragged) and
    launched one selection at a time (``FPS_GRAPH_BLOCK`` 0) pick the same
    indices."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud

    g = torch.Generator(device=cuda).manual_seed(3)
    v = torch.randn((20_000, 3), generator=g, device=cuda)
    pts = 0.5 * v / v.norm(dim=-1, keepdim=True) + 0.01 * torch.randn((20_000, 3), generator=g, device=cuda)
    assert pointcloud.FPS_GRAPH_BLOCK > 0 and (pts.shape[0] - 2) % pointcloud.FPS_GRAPH_BLOCK
    graphs = pointcloud.farthest_point_sampling(pts, pts.shape[0])
    monkeypatch.setattr(pointcloud, "FPS_GRAPH_BLOCK", 0)
    launches = pointcloud.farthest_point_sampling(pts, pts.shape[0])
    assert torch.equal(graphs, launches)
    assert graphs.unique().numel() == pts.shape[0]


# SHA-256 of the float32-activation variants' outputs from _bundle_inputs at
# seed R + P (``_act32_digest``): K4's 13 grads, loss sums and EA weights at
# the train step's fine shape, a ragged tile (P = 77) and the grouped
# ladder; K6's 13 grads at a chunk's shape, on K5's records and random
# cotangents.  Recorded on an H100 80GB HBM3 (torch 2.11.0 + cu128) with the
# build of commit c9bb11c, whose pass B read its f32 activations from device
# memory: staging them on chip moves where they are read from, not one bit.
ACT32_DIGESTS = {
    ("k4", "direct", 2, 1200, 320): "db2718c994f4e6ce45a2e09475fd62f23309e849899e225e10d50d5b4c17990e",
    ("k4", "direct", 2, 5, 77): "5f47ac5d7006e8a35834614a11665b8372ad4c8bb20a2d2c21c27571a4f347ac",
    ("k4", "grouped", 2, 257, 320): "ad231b80fae49e6b7e9a5cb1aa815e03bf7c87558656e143f2333725b66cea20",
    ("k6", "direct", 2, 704, 320): "bec9f064eeefa2b8f69a3622b69d83f4b8df87915160a8d7b0d20e2fb3b98dbc",
}


def _act32_digest(path, embed, n_halves, R, P, dev) -> str:
    """SHA-256 over the bytes of the float32-activation K4's (``path``
    "k4") or K6's ("k6") outputs at ``FieldConfig(embed_method=embed)``."""
    cfg = FieldConfig(embed_method=embed)
    pts, dn, tgt, fm, weights, ladder = _bundle_inputs(cfg, n_halves, R, P, dev, R + P)
    beta = cfg.softplus_beta
    if path == "k4":
        grads, loss, w = field_kernel.bundle_loss_cuda(pts, dn, tgt, fm, weights, ladder, beta, 0.1, 500.0 / R, True,
                                                       "float32")
        outs = (*grads, loss, w)
    else:
        dk, rk, res = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta, "float32")
        g = torch.Generator(device=dev).manual_seed(R)
        gdens = torch.randn(dk.shape, generator=g, device=dev)
        grgb = torch.randn(rk.shape, generator=g, device=dev)
        outs = field_kernel.field_color_bwd_cuda(dn, fm, weights, res, dk, rk, gdens, grgb, ladder, beta, "float32")
    digest = hashlib.sha256()
    for t in outs:
        digest.update(t.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


@pytest.mark.parametrize("path,embed,n_halves,R,P", list(ACT32_DIGESTS))
def test_act32_kernels_give_the_recorded_bits(cuda, path, embed, n_halves, R, P):
    """K4's and K6's float32-activation variants give the recorded bits
    (``ACT32_DIGESTS``): the P = 77 case reads the ragged tile's
    zero-filled rows."""
    assert _act32_digest(path, embed, n_halves, R, P, cuda) == ACT32_DIGESTS[(path, embed, n_halves, R, P)]


@pytest.mark.parametrize("path", ["k4", "k5k6"])
@pytest.mark.parametrize("embed", ["direct", "grouped"])
def test_act32_kernels_are_the_kernel_forwards_gradient(cuda, path, embed):
    """The field kernels' float32-activation variants (K4, or K5 / K6
    through ``FieldColor``) against autograd through the kernels' own
    forward (``test_torch_field_act32._kernel_forward``, on the CPU) at 48
    hidden units, with the bf16 variants on the same inputs: on the
    sigmoid'-carrying leaves the float32 kernels' worst gap is under a
    third of the bf16 kernels', which part from that gradient by the
    activations' bf16 rounding.  So a float32 variant that read the bf16
    activations fails here (the plain twins on the CPU: 1.4e-5 to 2.0e-5
    against 1.57e-3)."""
    import test_torch_field_act32 as act32

    H, R, P, hs = 2, 24, 16, 0.1
    scale = 500.0 / R
    pts, d, col, sil = act32._rays(H, R, P, 7)
    gaps = {}
    for act in ("float32", "bfloat16"):
        cfg = FieldConfig(**act32.SMALL, embed_method=embed, act_dtype=act, fused_kernel=True)
        fields = act32._init_fields(cfg, H, 11)
        want = act32._autograd_grads(cfg, fields, pts, d, col, sil, hs, scale)
        on_card = [f.to(cuda) for f in copy.deepcopy(fields)]
        got = act32._twin_grads(path, cfg, on_card, *(x.to(cuda) for x in (pts, d, col, sil)), hs, scale)
        gaps[act] = act32._leaf_gaps({k: v.cpu() for k, v in got.items()}, want)
    sig = [k for k in gaps["float32"] if k[1] in act32.SIG_LEAVES]
    worst = {act: max(g[k] for k in sig) for act, g in gaps.items()}
    print(f"{path} {embed}: sigmoid'-carrying leaves' worst gap, float32 kernels {worst['float32']:.3e}, bf16 "
          f"kernels {worst['bfloat16']:.3e}; every leaf, float32 kernels {max(gaps['float32'].values()):.3e}")
    assert worst["float32"] < worst["bfloat16"] / 3.0, gaps


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
    args = (pts, dn, tgt, fm, weights, ladder, beta, 0.1, 500.0 / R, True, cfg.act_dtype)
    gk, lk, wk = field_kernel.bundle_loss_cuda(*args)
    dens, _, _ = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta, cfg.act_dtype)
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
    _pose_step_card_vs_cpu(cuda, FieldConfig(n_harmonic_functions=8, n_hidden=48))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_nosiren_pose_train_step_on_card_matches_cpu(cuda, compute, monkeypatch):
    """The same step with the softplus MLP head (siren=False, 8 harmonics,
    48 hidden) while the process allows TF32: the step's own ``no_tf32``
    must keep the head's and the UNet's f32 products in f32 (TF32 would
    show as grad errors of ~1e-3 of the max, above the bar).  With f32
    products the head's grads hold at the bar; with bf16 products the card
    sums each product in another order than the CPU, which may flip a bf16
    rounding of an output or a cotangent, so those grads are held to
    3e-2 of their max (the autograd-step bar of the NeRF parity test)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    worst = _pose_step_card_vs_cpu(cuda, FieldConfig(n_harmonic_functions=8, n_hidden=48, siren=False,
                                                     compute_dtype=compute),
                                   head_grad_rel=1e-3 if compute == "float32" else 3e-2)
    print(f"siren=False {compute}: largest grad error over its bar {worst:.3e}")
    assert torch.backends.cuda.matmul.allow_tf32      # the step restored the caller's setting


def _pose_step_card_vs_cpu(cuda, field_cfg, head_grad_rel=1e-3):
    """Returns the largest grad error over its bar."""
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
    field = NerfField(field_cfg)
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
    heads = {id(p) for p in pose_trainer.head_params(cpu_state.field)}
    worst = 0.0
    for n, a, b in pairs:
        rel = head_grad_rel if id(a) in heads else 1e-3
        delta = rel * float(a.grad.abs().max()) + 1e-5 * g_all
        err = float((b.grad.cpu() - a.grad).abs().max())
        worst = max(worst, err / delta)
        assert err <= delta, n
        # Adam's first step moves each param by rate * g / (|g| + eps): a grad
        # error delta moves that by at most delta * eps / (|g| - delta + eps)^2
        # of the rate (so up to the whole rate where |g| is near eps)
        rate = opt.learning_rate(cfg.lr_mlp if id(a) in heads else cfg.lr_cnn, 0)
        eps = 1e-8
        near = (a.grad.abs() - delta).clamp_min(0.0) + eps
        bar = 1e-6 + rate * torch.clamp(delta * eps / near ** 2, max=2.0)
        assert bool(((b.detach().cpu() - a.detach()).abs() <= bar).all()), n
    assert card_state.step == cpu_state.step == 1
    return worst


def test_nosiren_keys_at_full_width_on_card_match_cpu(cuda):
    """The softplus MLP head at full width (60 harmonics: angles up to
    0.1 * 2^59 * |x| rad, 360 -> 256 -> 12, bf16 products and storage) on
    the card against the CPU at 200,000 points in the object's box.  Both
    take the same f32 angles; CUDA's ``sinf`` and the CPU's vectorized sin
    each reduce them exactly, so the embedding agrees to an ulp or two and
    its bf16 storage flips rarely.  Keys agree to 1e-5 wherever no bf16
    rounding of the embedding or of feat1's or feat2's output differs; the
    flipped points stay few and move by little."""
    cfg = FieldConfig(act_dtype="bfloat16", siren=False)
    field = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(5))
    card = copy.deepcopy(field).to(cuda)
    pts = (torch.rand((200_000, 3), generator=torch.Generator().manual_seed(6)) * 2.4 - 1.2)
    with torch.no_grad():
        stages = []
        for f, x in ((field, pts), (card, pts.to(cuda))):
            e = f.embed(x)
            z1 = f._matmul(e, f.feat1)
            z2 = f._matmul(softplus_beta(z1, cfg.softplus_beta), f.feat2)
            stages.append([t.cpu() for t in (e, z1, z2, torch.sigmoid(z2))])
        got = eval_keys(card, pts.to(cuda)).cpu()
    (e_c, z1_c, z2_c, k_c), (e_g, z1_g, z2_g, k_g) = stages
    assert torch.equal(got, k_g)
    ang = (pts[:, :, None] * (cfg.omega0 * 2.0 ** torch.arange(cfg.n_harmonic_functions))).reshape(len(pts), -1)
    raw_c, raw_g = torch.sin(ang), torch.sin(ang.to(cuda)).cpu()
    sin_ulps = ((raw_g - raw_c).abs() / torch.finfo(torch.float32).eps).max()
    flipped = (e_c != e_g).any(-1) | (z1_c != z1_g).any(-1) | (z2_c != z2_g).any(-1)
    err = (k_g - k_c).abs().max(-1).values
    print(f"sin max diff {float((raw_g - raw_c).abs().max()):.3e} ({float(sin_ulps):.1f} eps); embedding bf16 "
          f"values differing {float((e_c != e_g).float().mean()):.3e}; points with a flipped rounding "
          f"{float(flipped.float().mean()):.3e}; key error max {float(err.max()):.3e}, unflipped "
          f"{float(err[~flipped].max()) if (~flipped).any() else 0.0:.3e}")
    assert bool((err[~flipped] <= 1e-5).all())
    assert float(flipped.float().mean()) < 5e-2 and float(err.max()) < 5e-2
    assert bool(((k_g > 0) & (k_g < 1)).all())


def _pose_run(dev):
    """``run(n_steps, **kw)``: ``train_pose`` on ``dev`` at the chain's
    widths (a full-width bf16 field and ResNetUNet, 4 views at 112 px,
    256 samples a view, the distractor augmentation), from one seed; it
    returns (state, losses)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import PoseTrainConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as aug_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer

    V, S, M = 4, 112, 1024
    scene = synthetic.make_scene(V, S, torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    xys = torch.rand((V, M, 2), generator=g, device=dev) * 2.0 - 1.0
    pos = torch.randn((V, M, 3), generator=g, device=dev) * 0.4
    valid = torch.ones((V, M), dtype=torch.bool, device=dev)
    bank = pose_trainer.RayBank(pos, xys, pos, xys, valid, valid)
    neg = torch.randn((2000, 3), generator=g, device=dev) * 0.4
    field = NerfField(FieldConfig(act_dtype="bfloat16")).reset_parameters(torch.Generator().manual_seed(2)).to(dev)
    cfg = PoseTrainConfig(warmup_steps=4, sample_size=256)
    aug_cfg = aug_lib.AugmentConfig(crop_res=S, min_mask_sum=10.0, p_distractor=0.5)

    def run(n, **kw):
        return pose_trainer.train_pose(field, scene.images, scene.sils, bank, neg, cfg=cfg, aug_cfg=aug_cfg,
                                       n_steps=n, seed=1, device=dev, **kw)

    return run


def _pose_tensors(state) -> list:
    opt = state.opt
    return (list(state.field.parameters()) + list(state.cnn.parameters()) + opt.head_mu + opt.head_nu + opt.cnn_mu
            + opt.cnn_nu)


def test_train_pose_is_bit_reproducible_on_card(cuda):
    """Two 5-step descriptor runs from one seed on the card (``_pose_run``;
    each step after a run's second replays its graph): bit-identical
    parameters, Adam moments and losses."""
    run = _pose_run(cuda)
    (a, la), (b, lb) = run(5), run(5)
    assert la == lb and len(la) == 5
    assert all(torch.equal(x, y) for x, y in zip(_pose_tensors(a), _pose_tensors(b)))


def test_train_pose_resumed_on_card_equals_the_whole_run(cuda):
    """A run resumed at step 2 from a copy of its state (new modules: its
    step 2 runs eagerly, step 3 captures a graph anew, step 4 replays it)
    gives the losses, parameters and Adam moments of the uninterrupted
    5-step run (eager, capture, three replays), bit for bit."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer

    run = _pose_run(cuda)
    full, full_losses = run(5)
    saved = []
    _, head = run(2, on_checkpoint=lambda st, i: saved.append(copy.deepcopy(st)))
    captures = pose_trainer.POSE_GRAPH_COUNT["captures"]
    end, tail = run(5, resume_state=saved[-1])
    assert pose_trainer.POSE_GRAPH_COUNT["captures"] == captures + 1
    assert head + tail == full_losses and end.step == full.step == 5
    assert all(torch.equal(x, y) for x, y in zip(_pose_tensors(end), _pose_tensors(full)))


@contextlib.contextmanager
def _cuda_sync_mode(mode):
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def test_pose_step_graph_matches_eager_step(cuda, monkeypatch):
    """Eight descriptor steps at full width (8 of 16 views at 224 px a step,
    1,024 samples a view, 80,000 negatives, the SIREN field and the
    ResNetUNet in bf16, the default augmentation, the sampled rays drawn
    in the step): the eager first call, the capture, two replays, an eager
    step of 4 views, three replays.  Run once as the program runs them,
    the replays under sync-debug "error" but for the ray draw between
    their graphs, and once on a copy of the state with the graph lookup
    replaced by the eager body: after every step the loss terms, grads
    (the replay's own after the 4-view step), parameters, Adam moments and
    the step generator's state are equal bit for bit; one capture and five
    replays."""
    from collections import OrderedDict

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import PoseTrainConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment as aug_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import pose_trainer

    monkeypatch.setattr(pose_trainer, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(pose_trainer, "_SEEN", OrderedDict())
    monkeypatch.setattr(pose_trainer, "POSE_GRAPH_COUNT", dict.fromkeys(pose_trainer.POSE_GRAPH_COUNT, 0))
    draw = aug_lib._draw_with_replacement

    def draw_allowed_to_sync(*a):
        with _cuda_sync_mode(0):
            return draw(*a)

    monkeypatch.setattr(aug_lib, "_draw_with_replacement", draw_allowed_to_sync)
    V, B, B_other, S, M, n_neg = 16, 8, 4, 224, 4096, 80_000
    scene = synthetic.make_scene(V, S, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    xys = torch.rand((V, M, 2), generator=g, device=cuda) * 2.2 - 1.1
    pos = torch.randn((V, M, 3), generator=g, device=cuda) * 0.4
    valid = torch.rand((V, M), generator=g, device=cuda) > 0.1
    neg = torch.randn((n_neg, 3), generator=g, device=cuda) * 0.4
    field = NerfField(FieldConfig(act_dtype="bfloat16")).reset_parameters(torch.Generator().manual_seed(2))
    cnn = ResNetUNet().reset_parameters(torch.Generator().manual_seed(3))
    cfg = PoseTrainConfig(batch_size=B, warmup_steps=3)
    aug_cfg = aug_lib.AugmentConfig(crop_res=S, min_mask_sum=10.0)
    opt = pose_trainer.make_pose_optimizer(cfg)
    sides = [pose_trainer.init_pose_state(field, cfg, cnn, device=cuda) for _ in range(2)]
    gens = [torch.Generator(device=cuda).manual_seed(4) for _ in range(2)]
    eager = lambda field, cnn, trained, cfg, aug_cfg, args: pose_trainer._one_entry_losses(  # noqa: E731
        field, cnn, cfg, aug_cfg, *args)
    sizes = [B] * 4 + [B_other] + [B] * 3
    for i, b in enumerate(sizes):
        idx = torch.randperm(V, generator=torch.Generator().manual_seed(10 + i))[:b].to(cuda)
        draws = pose_trainer.draw_pose_step(torch.Generator(device=cuda).manual_seed(20 + i), b, S, n_neg, cfg,
                                            aug_cfg)
        args = (scene.images[idx], scene.sils[idx], pos[idx], xys[idx], valid[idx], neg, cfg, aug_cfg, draws)
        replays = pose_trainer.POSE_GRAPH_COUNT["replays"]
        with _cuda_sync_mode("error" if i >= 2 and b == B else 0):
            sides[0], loss, terms = pose_trainer.pose_train_step(sides[0], opt, *args, gens[0])
        assert pose_trainer.POSE_GRAPH_COUNT["replays"] == replays + (i >= 2 and b == B), i
        with monkeypatch.context() as mp:
            mp.setattr(pose_trainer, "_one_entry_step", eager)
            sides[1], loss_e, terms_e = pose_trainer.pose_train_step(sides[1], opt, *args, gens[1])
        assert torch.equal(loss, loss_e) and all(torch.equal(terms[k], terms_e[k]) for k in terms), i
        assert torch.equal(gens[0].get_state(), gens[1].get_state()), i
        assert all(torch.equal(x, y) for x, y in zip(_pose_tensors(sides[0]), _pose_tensors(sides[1]))), i
        grads = [pose_trainer._trained(st.field, st.cnn) for st in sides]
        assert all(torch.equal(x.grad, y.grad) for x, y in zip(*grads)), i
    assert float(sides[0].opt.cnn_mu[0].abs().max()) > 0
    assert pose_trainer.POSE_GRAPH_COUNT == {"captures": 1, "replays": 5, "eager": 2}


def _cli_argv(root, *extra, uh=1, act="bfloat16"):
    """``act`` None: the CLI's default ``--act-dtype`` (float32)."""
    return ["--objid", "1", "--dataset", "ruapc", "--UH", str(uh), "--root", str(root), "--synthetic",
            "--synthetic-views", "4", "--image-size", "64", *(["--act-dtype", act] if act else []), "--viz-every",
            "0", "--log-every", "0", *extra]


@pytest.mark.parametrize("act", ["bfloat16", None])
def test_cli_train_nerf_resumes_exactly_on_card(cuda, tmp_path, monkeypatch, act):
    """``train-nerf --steps 40`` on the card at ``--act-dtype bfloat16`` and
    at the CLI's default (float32: K4's float32-activation variant), K4 a
    pass on each card of the default mesh (every card where there are
    several), stopped after its step-20 checkpoint and resumed with
    ``--cont --steps 40``, equals the straight 40-step run bit for bit."""
    import functools

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import cli, config
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint

    monkeypatch.setattr(config, "NerfTrainConfig", functools.partial(config.NerfTrainConfig, ckpt_every=20))
    argv = functools.partial(_cli_argv, act=act)
    cuda_build.reset(field_kernel.bundle_loss_cuda)
    cli.main(["train-nerf", *argv(tmp_path / "straight", "--steps", "40")])
    cards = torch.cuda.device_count() if torch.cuda.device_count() >= 2 else 1
    # 40 steps x (coarse + fine) x entries, all of the variant of the activation dtype
    want = "bundle_loss" if act == "bfloat16" else "bundle_loss_act32"
    assert field_kernel.bundle_loss_cuda.by_name == {want: 80 * cards}

    class Stop(Exception):
        pass

    save_latest = checkpoint.save_latest

    def stop_at_20(directory, state):
        save_latest(directory, state)
        if state.step == 20:
            raise Stop

    monkeypatch.setattr(checkpoint, "save_latest", stop_at_20)
    with pytest.raises(Stop):
        cli.main(["train-nerf", *argv(tmp_path / "cut", "--steps", "40")])
    monkeypatch.setattr(checkpoint, "save_latest", save_latest)
    cli.main(["train-nerf", *argv(tmp_path / "cut", "--steps", "40", "--cont")])
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


def sharp_features(p):
    """A high-frequency injective descriptor of surface points, norm 3."""
    f = torch.cat([torch.sin(14.0 * p), torch.cos(11.0 * p), torch.sin(17.0 * p.flip(-1)), 2.0 * p], -1)
    return 3.0 * f / f.norm(dim=-1, keepdim=True)


def ideal_view(pts, S: int):
    """A planted pose of the blob's points ``pts`` (M, 3), the camera of an S
    px crop on it and the ideal maps of that view (S, S, 13): the sharp
    keys of each pixel's nearest point and mask logits (+6 on the object,
    -6 off it).  Returns (R, t, K, maps) on the points' device."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import rotvec_to_matrix
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.rasterize import render_object_coords

    dev = pts.device
    R = rotvec_to_matrix(torch.tensor([0.3, -0.2, 0.4], device=dev))
    t = torch.tensor([0.05, -0.03, 4.0], device=dev)
    K = torch.tensor([[2.1 * S, 0.0, S / 2 - 0.5], [0.0, 2.1 * S, S / 2 - 0.5], [0.0, 0.0, 1.0]], device=dev)
    coords, mask = render_object_coords(pts, R, t, K, S)
    maps = torch.cat([sharp_features(coords) * mask[..., None], (mask * 12.0 - 6.0)[..., None]], -1)
    return R, t, K, maps


def ideal_cnn(maps):
    """A CNN stand-in: ``maps`` (S, S, 13) for any image."""

    class IdealMaps(torch.nn.Module):
        def forward(self, images):
            return maps[None].expand(images.shape[0], *maps.shape)

    return IdealMaps()


def cdf_drift(dev, seed: int, n: int, m: int, n_draws: int = 40_000) -> dict:
    """The SurfEmb cdf at n pixels x m keys (random queries and keys of the
    trained descriptors' norm, sigmoid mask probabilities, alpha 1.5): the
    share of ``n_draws`` uniform draws whose index moves, against an f64
    running sum of the same f32 entries, for the port's two-level f64 cdf
    and for a single f32 ``torch.cumsum`` (the reference's expression)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import no_tf32
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_est_surf as pes

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((n, 12), generator=g, device=dev)
    k = torch.randn((m, 12), generator=g, device=dev)
    q, k = 3 * q / q.norm(dim=-1, keepdim=True), 3 * k / k.norm(dim=-1, keepdim=True)
    mask_prob = torch.sigmoid(4 * torch.randn((n,), generator=g, device=dev))
    u = torch.rand((n_draws,), generator=g, device=dev)
    _, cdf = pes.correspondence_distribution(q, k, mask_prob, 1.5)
    got = pes.inverse_cdf(cdf, u)
    del cdf
    flat = torch.empty((n, m), device=dev)
    for r0 in range(0, n, pes.ROW_CHUNK):
        rows = slice(r0, r0 + pes.ROW_CHUNK)
        with no_tf32():
            logits = q[rows] @ k.T
        flat[rows] = (torch.exp(torch.log_softmax(logits, 1)) * mask_prob[rows, None]) ** 1.5
    flat = flat.view(-1)
    c64 = torch.cumsum(flat.double(), 0)
    want = torch.searchsorted(c64 / c64[-1], u.double()).clamp_max(n * m - 1)
    del c64
    c32 = torch.cumsum(flat, 0)
    f32 = torch.searchsorted(c32 / c32[-1], u).clamp_max(n * m - 1)
    return {"port": float((got != want).float().mean()), "f32": float((f32 != want).float().mean())}


def _surf_scene(S: int, subdivisions: int):
    """The blob's vertices as baked points (sharp keys, its normals), a
    planted pose, the crop camera of an S px crop and the ideal maps of
    that view (``ideal_view``): CPU tensors."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene

    verts, _, _, normals = (torch.as_tensor(x) for x in mesh_scene.blob_mesh(subdivisions))
    R, t, K, maps = ideal_view(verts, S)
    return dict(verts=verts, normals=normals, feats=sharp_features(verts), R=R, t=t, K=K, maps=maps)


def test_estimate_pose_surfemb_on_card_matches_cpu(cuda):
    """One 96 px view of the blob (2,562 keys), 2,000 hypotheses, 200
    scored, the same draws on the card and on the CPU: the distribution
    draws the same correspondences (99 % of the 8,000 draws or more; a
    draw that moves lies within 1e-6 of an edge of its CPU bin: the f32
    entries round differently on the card), the CPU's hypotheses score the
    same on the card (mask scores to 1e-5; coord scores to 1e-3 on 99 % of
    them: a z-buffer winner flips at a rounding edge), and
    ``estimate_pose_surfemb`` with 10 BFGS steps lands within 0.1 of the
    planted rotation and 5 % of its distance on both, and repeats itself on
    the card bit for bit.  The hypotheses themselves are not compared slot
    for slot: on random draws many P3P triples are ill-posed, and f32
    Grunert under the card's rounding moves their roots by up to 0.2
    (ROADMAP C, P3P conditioning)."""
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
        args = (ideal_cnn(on["maps"]), torch.zeros((96, 96, 3), device=dev), on["K"], on["verts"], on["normals"],
                on["feats"], 1.2)
        est = inference.estimate_pose_surfemb(*args, cfg=cfg, refine_steps=10,
                                              draws=inference.SurfEmbDraws(*(x.to(dev) for x in draws)))
        if dev != "cpu":
            again = inference.estimate_pose_surfemb(*args, cfg=cfg, refine_steps=10,
                                                    draws=inference.SurfEmbDraws(*(x.to(dev) for x in draws)))
            assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b)) for a, b in zip(est, again))
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
    (``cdf_drift``)."""
    drift = cdf_drift(cuda, 0, 5_476, 80_000)
    print(f"moved draws: port {drift['port']:.2e}, f32 cumsum {drift['f32']:.2e}")
    assert drift["port"] == 0.0


def test_surfemb_full_shape_repeats_and_syncs_as_counted(cuda):
    """``estimate_pose_surfemb`` at its full shape: a 224 px crop (5,476
    cells) against 80,000 keys (points of the blob, the ideal maps of a
    view of them), 10,000 hypotheses, 1,000 scored, 10 BFGS steps.  Two
    calls on the same draws give the same bits; under sync-debug "warn" a
    call syncs exactly as often as ``SURF_COUNT`` and ``REFINE_COUNT``
    count host reads: 8 an image, none of them in the refiner (its BFGS is
    a graph replay that reads nothing back)."""
    import warnings

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import (
        inference,
        pose_est_surf,
        pose_refine,
    )

    verts, _, _, normals = (torch.as_tensor(x) for x in mesh_scene.blob_mesh(7))
    take = torch.randperm(verts.shape[0], generator=torch.Generator().manual_seed(0))[:80_000]
    verts, normals = verts[take].contiguous().to(cuda), normals[take].contiguous().to(cuda)
    _, _, K, maps = ideal_view(verts, 224)
    cfg = InferenceConfig()
    args = (ideal_cnn(maps), torch.zeros((224, 224, 3), device=cuda), K, verts, normals, sharp_features(verts), 1.2)
    draws = inference._draw_surfemb(torch.Generator(device=cuda).manual_seed(1), cfg, 80_000, True)
    one = lambda: inference.estimate_pose_surfemb(*args, cfg=cfg, refine_steps=10, draws=draws)  # noqa: E731
    first, again = one(), one()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]) and first[2] == again[2]
    assert math.isfinite(first[2])
    reads = pose_est_surf.SURF_COUNT["host_reads"] + pose_refine.REFINE_COUNT["host_reads"]
    with warnings.catch_warnings(record=True) as seen, _cuda_sync_mode("warn"):
        warnings.simplefilter("always")
        one()
    syncs = sum("called a synchronizing" in str(w.message) for w in seen)
    counted = pose_est_surf.SURF_COUNT["host_reads"] + pose_refine.REFINE_COUNT["host_reads"] - reads
    print(f"syncs an image: {syncs}, counted host reads: {counted}")
    assert syncs == counted > 0


def test_refine_graph_matches_eager_body_at_full_shape(cuda, monkeypatch):
    """The refiner at the cell's full shape (a 224 px query image, 80,000
    baked keys, 10,960 denominator keys, 50 BFGS steps) on two different
    crops and starts: the first call captures BFGS's graph, the second
    replays it under sync-debug "error", and each refined R, t and
    objective equal ``_bfgs`` over the module-level objective of the same
    inputs, run eagerly, bit for bit.  The second crop's answer differs
    from the first's: the replay reloaded its inputs."""
    import time
    from collections import OrderedDict

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import rotvec_to_matrix
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine

    monkeypatch.setattr(pose_refine, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(pose_refine, "REFINE_GRAPH_COUNT", dict.fromkeys(pose_refine.REFINE_GRAPH_COUNT, 0))
    verts = torch.as_tensor(mesh_scene.blob_mesh(7)[0])
    take = torch.randperm(verts.shape[0], generator=torch.Generator().manual_seed(0))[:80_000]
    verts = verts[take].contiguous().to(cuda)
    feats = sharp_features(verts)
    R, t, K, maps = ideal_view(verts, 224)
    g = torch.Generator(device=cuda).manual_seed(3)
    query = maps[..., :12]
    crops = [query, query + 0.5 * torch.randn(query.shape, generator=g, device=cuda)]
    starts = [(rotvec_to_matrix(torch.tensor([0.02, -0.015, 0.02], device=cuda)) @ R,
               t + torch.tensor([0.01, -0.01, 0.05], device=cuda)),
              (rotvec_to_matrix(torch.tensor([-0.03, 0.01, 0.025], device=cuda)) @ R,
               t + torch.tensor([-0.02, 0.015, -0.06], device=cuda))]
    sels = [torch.randperm(80_000, generator=g, device=cuda) for _ in crops]
    got, took, ends = [], [], []
    capture_end = torch.cuda.CUDAGraph.capture_end

    def timed_end(graph):       # ends the capture and instantiates the graph
        start = time.perf_counter()
        capture_end(graph)
        ends.append(time.perf_counter() - start)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_end", timed_end)
    for i, ((R0, t0), q, sel) in enumerate(zip(starts, crops, sels)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with _cuda_sync_mode("error" if i else 0):
            got.append(pose_refine.refine_pose(R0, t0, q, K, verts, feats, n_steps=50, sel=sel))
        torch.cuda.synchronize()
        took.append(time.perf_counter() - start)
    assert pose_refine.REFINE_GRAPH_COUNT == {"captures": 1, "replays": 1, "eager": 0}
    for ((R0, t0), q, sel), (R1, t1, f1) in zip(zip(starts, crops, sels), got):
        inputs = pose_refine.refine_inputs(R0, t0, q, K, verts, feats, sel=sel)
        torch.cuda.synchronize()
        start = time.perf_counter()
        x, fx = pose_refine._bfgs(lambda p: pose_refine.objective(p, *inputs), torch.zeros(6, device=cuda), 50, 12,
                                  0.3)
        R_e, t_e = pose_refine.pose(x, R0, t0, inputs[8])
        torch.cuda.synchronize()
        took.append(time.perf_counter() - start)
        assert torch.equal(R1, R_e) and torch.equal(t1, t_e) and torch.equal(f1, fx)
        assert float((t1 - t0).abs().max()) > 0 and math.isfinite(float(f1))
    assert not torch.equal(got[0][1], got[1][1]) and not torch.equal(got[0][2], got[1][2])
    print(f"refine_pose: capture call {took[0]:.3f} s (capture end and instantiation {sum(ends):.3f} s), "
          f"replay call {took[1]:.3f} s; eager BFGS {took[2]:.3f} / {took[3]:.3f} s")


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


# ------------------------------------------------------------ the chain on the card


# The synthetic chain's sizes: 8 views a half at 224 px; NeRF steps of 3
# views x 400 rays a half, 400 of them (a surface at the correspondence
# threshold), warmup min(300, 400 // 3); correspondences, negatives and the
# bake on a 128^3 grid at threshold 0.2; 100 descriptor steps with the
# distractor augmentation; 8 images posed at InferenceConfig(); ICP 20
# iterations.  ``same_steps``: the NeRF steps that show the MLP key head
# leaves NeRF training as it is
CHAIN = {"views": 8, "image_size": 224, "n_rays": 400, "batch": 3, "nerf_steps": 400, "warmup": 133,
         "grid_res": 128, "threshold": 0.2, "neg_loops": 20, "pose_steps": 100, "n_points": 20_000,
         "n_infer": 8, "icp_iters": 20, "same_steps": 50}


def _launched(fn):
    """``fn()`` and each of K1-K6's launches during it, by kernel."""
    for w in WRAPPERS.values():
        cuda_build.reset(w)
    out = fn()
    return out, {k: w.launches for k, w in WRAPPERS.items()}


def _is_head(name: str) -> bool:
    """Is the field's parameter ``name`` one of its key head's?"""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NON_FEATURE_MODULES

    return name.split(".")[0] not in NON_FEATURE_MODULES


def _body(states, head: bool = False) -> list:
    """The NeRF states' tensors outside the key head (``head``: its own),
    coarse and fine fields of each half in order."""
    return [p for st in states for f in (st.coarse, st.fine) for n, p in f.state_dict().items() if _is_head(n) == head]


def _hits_on_the_mesh(cors: str, scene, cfg, S: int, dev):
    """What generate_cors wrote for one half: front and back hits within
    ``mesh_filter_dist`` of its surface a1, each back hit behind its front
    hit along the back ray (the direction -camera origin) and no nearer the
    camera."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as cam_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts

    a1 = torch.as_tensor(artifacts.load_array(cors, "a1.npy"), device=dev)
    origins = cam_lib.camera_center(cam_lib.camera_from_bop(scene.R_bop, scene.t_bop, scene.K, S)).cpu().numpy()
    n_front = n_back = 0
    for v in range(scene.R_bop.shape[0]):
        xys, front, bxys, back = artifacts.load_view_rays(cors, S, v)
        for hits in (front, back):
            if hits.shape[0]:
                d, _ = point_kernels.nn_min_plain(torch.as_tensor(hits, device=dev), a1)
                assert float(d.max()) < cfg.mesh_filter_dist
        pixel = [np.rint((1.0 - x) * S / 2.0 - 0.5).astype(np.int64) for x in (xys, bxys)]
        row = dict(zip((pixel[0][:, 1] * S + pixel[0][:, 0]).tolist(), range(xys.shape[0])))
        front = front[[row[q] for q in (pixel[1][:, 1] * S + pixel[1][:, 0]).tolist()]]
        o = origins[v]
        if back.shape[0]:
            assert ((back - front) @ (-o / np.linalg.norm(o)) >= 0.0).all()
            assert (np.linalg.norm(back - o, axis=-1) >= np.linalg.norm(front - o, axis=-1)).all()
        n_front, n_back = n_front + xys.shape[0], n_back + back.shape[0]
    assert n_front > 0 and n_back > 0


def _icp_card_vs_cpu(dev, upper, lower, cad, R_gt, t_gt, diameter: float, scale: float):
    """ICP of the baked keys from the ground-truth pose composed with a
    3-degree rotation and a 0.02 x scale shift, on the card and on the CPU:
    both find inliers and move the pose, and they agree."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import rotations
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import registration

    axis = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
    dR = rotations.rotvec_to_matrix(torch.as_tensor(axis * np.deg2rad(3.0), dtype=torch.float32)).numpy()
    R0, t0 = R_gt @ dR, t_gt + 0.02 * scale * axis.astype(np.float32)
    R_start, t_start = (x.numpy() for x in rotations.invert_pose(torch.as_tensor(R0), torch.as_tensor(t0)))
    args = (upper, lower[::5], R_gt, t_gt, R0, t0, cad[::5])
    kw = dict(diameter=diameter, icp_threshold=0.2 * scale, icp_iters=CHAIN["icp_iters"])
    card = registration.register_halves(*args, device=dev, **kw)
    cpu = registration.register_halves(*args, device="cpu", **kw)
    print(f"ICP from a perturbed GT pose: fitness card {card['fitness']:.3f} / CPU {cpu['fitness']:.3f}, card - CPU "
          f"|dR| {np.abs(card['R'] - cpu['R']).max():.2e}, |dt| {np.abs(card['t'] - cpu['t']).max():.2e}")
    assert card["fitness"] > 0.5 and cpu["fitness"] > 0.5
    assert float(np.abs(card["t"] - t_start).max() + np.abs(card["R"] - R_start).max()) > 1e-4
    assert np.abs(card["R"] - cpu["R"]).max() < 1e-3 and np.abs(card["t"] - cpu["t"]).max() < 1e-3 * scale
    assert abs(card["chamfer"] - cpu["chamfer"]) < 1e-4 * max(1.0, cpu["chamfer"])


@pytest.mark.parametrize("siren", [True, False])
def test_chain_on_card(cuda, tmp_path, monkeypatch, siren):
    """The synthetic chain on one card through its entry points at
    ``CHAIN``'s sizes, with the SIREN key head or the softplus MLP head
    (``siren=False``): both halves' NeRFs (``train_nerf_fused``, K4 twice a
    step), ``generate_cors`` (K1, K2; its hits on the mesh), negatives (K1,
    K2), descriptor training (the loss falls; the head moves, the trunk
    does not), the bake (K1, K2), ``run_sequence`` (K3),
    ``verify_consecutive`` and ``register_halves`` (K2): every kernel of a
    stage launches, the outputs are finite, and ICP from a perturbed
    ground-truth pose agrees with the CPU.  NeRF training leaves the key
    head bit-identical, and the MLP head's NeRF runs as the SIREN one's
    from the same weights, bit for bit."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import (
        CorsConfig,
        FeatConfig,
        InferenceConfig,
        NerfTrainConfig,
        PoseTrainConfig,
        RenderConfig,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import normalize_image
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import metrics
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import (
        artifacts,
        gen_feat,
        generate_cors,
        inference,
        registration,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import augment, nerf_trainer, pose_trainer

    monkeypatch.setattr(mesh_lib, "auto_mesh", lambda *a, **k: None)      # one card, however many there are
    c, dev = CHAIN, cuda
    S, V = c["image_size"], c["views"]
    halves = [synthetic.make_scene(V, S, torch.Generator(device=dev).manual_seed(uh), device=dev) for uh in (0, 1)]
    data = [torch.stack([getattr(h, f) for h in halves]) for f in ("images", "sils", "R_bop", "t_bop", "K")]
    cfg = FieldConfig(act_dtype="bfloat16", siren=siren)
    render = RenderConfig(n_rays_per_image=c["n_rays"])
    train = NerfTrainConfig(warmup_steps=c["warmup"], batch_size=c["batch"])

    def fresh(field_cfg):
        return [nerf_trainer.init_state(field_cfg, train, torch.Generator().manual_seed(1 + h), device=dev)
                for h in (0, 1)]

    def nerf(field_cfg, states, n_steps):
        return nerf_trainer.train_nerf_fused(*data, field_cfg, render, train, n_steps=n_steps, seed=1, device=dev,
                                             init_states=states)

    if not siren:
        twin, states = fresh(FieldConfig(act_dtype="bfloat16")), fresh(cfg)
        for st, src in zip(states, twin):
            for f, g in ((st.coarse, src.coarse), (st.fine, src.fine)):
                f.load_state_dict({k: v for k, v in g.state_dict().items() if not _is_head(k)}, strict=False)
        assert len(_body(twin)) == len(_body(states))
        assert all(torch.equal(a, b) for a, b in zip(_body(twin), _body(states)))
        twin, _ = nerf(FieldConfig(act_dtype="bfloat16"), twin, c["same_steps"])
        states, _ = nerf(cfg, states, c["same_steps"])
        assert all(torch.equal(a, b) for a, b in zip(_body(twin), _body(states)))

    states = fresh(cfg)
    head = [p.clone() for p in _body(states, head=True)]
    (states, losses), n = _launched(lambda: nerf(cfg, states, c["nerf_steps"]))
    assert n == dict.fromkeys(WRAPPERS, 0) | {"bundle_loss": 2 * c["nerf_steps"]}
    losses = np.asarray(losses)
    assert np.isfinite(losses).all() and (losses[:, -10:].mean(1) < losses[:, :10].mean(1)).all()
    assert all(torch.equal(a, b) for a, b in zip(head, _body(states, head=True)))
    fields_ = [st.fine for st in states]

    cors_cfg = CorsConfig(density_threshold=c["threshold"])
    cors, n = _launched(lambda: [
        generate_cors.generate_cors(f, h.R_bop, h.t_bop, h.K, h.sils, str(tmp_path / f"{uh}_synth_obj_1"), 1,
                                    cors_cfg, grid_res=c["grid_res"], image_size=S, device=dev)
        for uh, (f, h) in enumerate(zip(fields_, halves))])
    assert n["density"] > 0 and n["nn_min"] > 0
    for d, h in zip(cors, halves):
        _hits_on_the_mesh(d, h, cors_cfg, S, dev)

    h0, h1 = halves
    pose_cfg = PoseTrainConfig(warmup_steps=100)
    neg, n = _launched(lambda: pose_trainer.build_negatives(
        fields_[0], h0.R_bop, h0.t_bop, h0.K, h0.sils, artifacts.load_array(cors[0], "a1.npy"), pose_cfg,
        image_size=S, n_loops=c["neg_loops"], threshold=c["threshold"],
        generator=torch.Generator(device=dev).manual_seed(0), device=dev))
    assert n["density"] > 0 and n["nn_min"] > 0 and neg.shape[0] > 0

    aug_cfg = augment.AugmentConfig(crop_res=S, min_mask_sum=10.0, p_distractor=0.5, scale_jitter=0.15,
                                    trans_frac=0.2)
    bank = pose_trainer.load_ray_bank(cors[0], S, V, device=dev)
    pstate, losses = pose_trainer.train_pose(fields_[0], h0.images, h0.sils, bank, neg, cfg=pose_cfg, aug_cfg=aug_cfg,
                                             n_steps=c["pose_steps"], seed=1, device=dev)
    losses = np.asarray(losses)
    print(f"siren={siren}: descriptor loss, first 10 steps {losses[:10].mean():.6f}, last 10 {losses[-10:].mean():.6f}")
    assert np.isfinite(losses).all() and losses[-10:].mean() < losses[:10].mean()
    assert torch.equal(pstate.field.trunk1.weight, fields_[0].trunk1.weight)
    assert not torch.equal(pose_trainer.head_params(pstate.field)[-2], pose_trainer.head_params(fields_[0])[-2])

    diam = h0.diameter
    scale = diam / 1.8
    exp0 = str(tmp_path / "serve" / "0_synth_obj_1")
    (verts_scaled, feats, _), n = _launched(lambda: gen_feat.gen_feat(
        pstate.field, h0.R_bop, h0.t_bop, h0.K, h0.sils, diam, exp0, 1,
        FeatConfig(mc_threshold=0.05, n_points=c["n_points"], sample_loops=3), image_size=S, grid_res=c["grid_res"],
        threshold=c["threshold"], generator=torch.Generator(device=dev).manual_seed(0)))
    assert n["density"] > 0 and n["nn_min"] > 0
    assert feats.shape == (verts_scaled.shape[0], 12) and np.isfinite(feats).all()
    if not siren:   # the MLP head's sigmoid keys
        assert feats.min() > 0.0 and feats.max() < 1.0

    k = c["n_infer"]
    Ks = h1.K[:k].clone()
    Ks[:, 0:2, 2] -= 0.5  # pixel-center convention
    (pred_R, pred_t), n = _launched(lambda: inference.run_sequence(
        pstate.cnn, normalize_image(h1.images[:k]), h1.sils[:k], Ks, verts_scaled, feats, cfg=InferenceConfig(),
        seed=0, batch=k, device=dev))
    assert n["corr_argmax"] > 0
    assert np.isfinite(pred_R).all() and np.isfinite(pred_t).all()
    assert np.abs(np.einsum("nij,nkj->nik", pred_R, pred_R) - np.eye(3)).max() < 1e-3
    verts_real, _, _, n_real = artifacts.load_keys(artifacts.pose_dir(exp0, 1))
    R_gt, t_gt = h1.R_bop[:k], h1.t_bop[:k] * scale
    adds = metrics.add_metric(torch.as_tensor(verts_real, device=dev), R_gt, t_gt, torch.as_tensor(pred_R, device=dev),
                              torch.as_tensor(pred_t, device=dev))
    assert n_real > 0 and bool(torch.isfinite(adds).all())

    cad_pts, ok = synthetic.analytic_surface_points(20_000, torch.Generator(device=dev).manual_seed(9), device=dev)
    cad = (cad_pts[ok] * scale).cpu().numpy()
    upper, lower = verts_real[:20_000], cad[cad[:, 2] < 2]

    def register():
        best, chamfers = registration.verify_consecutive(verts_real[::max(verts_real.shape[0] // 4000, 1)], R_gt,
                                                         t_gt, pred_R, pred_t, device=dev)
        out = registration.register_halves(upper, lower, R_gt[best].cpu().numpy(), t_gt[best].cpu().numpy(),
                                           pred_R[best], pred_t[best], cad, diameter=diam * scale,
                                           icp_threshold=0.2 * scale, icp_iters=c["icp_iters"], device=dev)
        return best, chamfers, out

    (best, chamfers, out), n = _launched(register)
    assert n["nn_min"] > 0
    assert len(chamfers) == k - 1 and np.isfinite(out["chamfer"])
    _icp_card_vs_cpu(dev, upper, lower, cad, R_gt[best].cpu().numpy(), t_gt[best].cpu().numpy(), diam * scale, scale)


# ------------------------------------------------------------ several devices


def _kernel_runs(dev):
    """K1-K6 once each on inputs made on the CPU and moved to ``dev``
    (full-width fields): every output, back on the CPU, by kernel."""
    cfg = FieldConfig(act_dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(1))
    torch.nn.init.zeros_(f.density_layer.bias)
    f = f.to(dev)
    ladder, beta = field_kernel.ladder_of(cfg), cfg.softplus_beta
    out = {"density": [field_kernel.density_cuda((torch.rand((100_003, 3), generator=g) * 2.4 - 1.2).to(dev),
                                                 field_kernel.density_weights(f), ladder, beta)]}
    q, r = torch.randn((5_003, 3), generator=g).to(dev), torch.randn((60_001, 3), generator=g).to(dev)
    out["nn_min"] = list(point_kernels.nn_min_cuda(q, r))
    qs, ks = torch.randn((5_003, 12), generator=g).to(dev), torch.randn((20_011, 12), generator=g).to(dev)
    out["corr_argmax"] = list(point_kernels.correspondence_argmax_cuda(qs, ks))
    pts, dn, tgt, fm, weights, _ = _bundle_inputs(cfg, 2, 257, 64, torch.device("cpu"), 5)
    pts, dn, tgt, fm = (x.to(dev) for x in (pts, dn, tgt, fm))
    weights = tuple(w.to(dev) for w in weights)
    gk, lk, wk = field_kernel.bundle_loss_cuda(pts, dn, tgt, fm, weights, ladder, beta, 0.1, 500.0 / 257, True,
                                               cfg.act_dtype)
    out["bundle_loss"] = [*gk, lk, wk]
    dk, rk, res = field_kernel.field_color_fwd_cuda(pts, dn, fm, weights, ladder, beta, cfg.act_dtype)
    out["field_color_fwd"] = [dk, rk, res["record"]]
    gdens, grgb = torch.randn(dk.shape, generator=g).to(dev), torch.randn(rk.shape, generator=g).to(dev)
    out["field_color_bwd"] = list(field_kernel.field_color_bwd_cuda(dn, fm, weights, res, dk, rk, gdens, grgb,
                                                                    ladder, beta, cfg.act_dtype))
    torch.cuda.synchronize(dev)
    return {k: [t.cpu() for t in v] for k, v in out.items()}


WRAPPERS = {"density": field_kernel.density_cuda, "nn_min": point_kernels.nn_min_cuda,
            "corr_argmax": point_kernels.correspondence_argmax_cuda, "bundle_loss": field_kernel.bundle_loss_cuda,
            "field_color_fwd": field_kernel.field_color_fwd_cuda,
            "field_color_bwd": field_kernel.field_color_bwd_cuda}


def _two_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two CUDA devices (runs each kernel on cuda:1 while cuda:0 is current); {n} present")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_kernels_launch_on_their_inputs_device():
    """Each of K1-K6 with its inputs on cuda:1 while cuda:0 is the current
    device: bit-identical to the same launch on cuda:0 (the launch, its
    stream and its shared-memory limit belong to the inputs' device), and
    counted on device 1."""
    c0, c1 = _two_cards()
    with torch.cuda.device(c0):
        want = _kernel_runs(c0)
        before = {k: w.per_device.get(1, 0) for k, w in WRAPPERS.items()}
        got = _kernel_runs(c1)
        assert torch.cuda.current_device() == 0
    for name, outs in want.items():
        assert all(torch.equal(a, b) for a, b in zip(outs, got[name])), name
        assert WRAPPERS[name].per_device.get(1, 0) == before[name] + 1, name


@pytest.mark.parametrize("kind", ["one card twice", "two cards"])
def test_stages_on_a_mesh_match_unsharded(cuda, kind):
    """K2's nn_query over a mesh is bit-identical to the unsharded call; 3
    fused NeRF steps (full-width bf16 fields, 2 halves x 2 cams x 200 rays,
    K4 on each entry's rays) agree with the unsharded run: the losses at
    the reference's sharded bar (rtol 1e-4), each param within 2.01 x the
    summed rates (Adam's first updates are ~ the rate times sign(g), and
    the entries' grads are summed in another order than one launch's); one
    step's grads within 1e-4 of each tensor's max; every entry launches K4
    twice a step."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import NerfTrainConfig, RenderConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import cuda_build, pointcloud
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as mesh_lib
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    if kind == "two cards":
        _two_cards()
    cuda = torch.device("cuda", 0)
    mesh = mesh_lib.Mesh([cuda, cuda]) if kind == "one card twice" else mesh_lib.make_mesh(2)
    g = torch.Generator(device=cuda).manual_seed(0)
    q, r = torch.randn((14_497, 3), generator=g, device=cuda), torch.randn((213_932, 3), generator=g, device=cuda)
    d0, i0 = pointcloud.nn_query(q, r)
    d1, i1 = pointcloud.nn_query(q, r, mesh=mesh)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    halves = [synthetic.make_scene(8, 64, torch.Generator(device=cuda).manual_seed(h), device=cuda) for h in (0, 1)]
    args = [torch.stack([getattr(h, f) for h in halves]) for f in ("images", "sils", "R_bop", "t_bop", "K")]
    kw = dict(field_cfg=FieldConfig(act_dtype="bfloat16"), render_cfg=RenderConfig(n_rays_per_image=200),
              train_cfg=NerfTrainConfig(batch_size=2, warmup_steps=10), n_steps=3, seed=1)
    st0, l0 = nerf_trainer.train_nerf_fused(*args, device=cuda, mesh=None, **kw)
    cuda_build.reset(field_kernel.bundle_loss_cuda)
    st1, l1 = nerf_trainer.train_nerf_fused(*args, mesh=mesh, **kw)
    torch.cuda.synchronize()
    assert field_kernel.bundle_loss_cuda.launches == 2 * 2 * 3
    assert field_kernel.bundle_loss_cuda.per_device == {d.index: 2 * 3 * sum(e == d for e in mesh.devices)
                                                        for d in set(mesh.devices)}
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    opt = nerf_trainer.make_optimizer(kw["train_cfg"])
    rates = 2.01 * sum(opt.learning_rate(k) for k in range(3))
    for a, b in zip(st1, st0):
        for p, q in zip(nerf_trainer.train_params(a), nerf_trainer.train_params(b)):
            assert p.device == cuda
            assert float((p - q).detach().abs().max()) <= rates
    # one step from the same init: the grads summed over the entries on home
    kw["n_steps"] = 1
    st0, _ = nerf_trainer.train_nerf_fused(*args, device=cuda, mesh=None, **kw)
    st1, _ = nerf_trainer.train_nerf_fused(*args, mesh=mesh, **kw)
    for a, b in zip(st1, st0):
        for p, q in zip(nerf_trainer.train_params(a), nerf_trainer.train_params(b)):
            assert float((p.grad - q.grad).abs().max()) <= 1e-4 * float(q.grad.abs().max())


# ------------------------------------------------------------ the program's spans


def _traced(fn, tmp_path) -> list:
    """The Chrome trace events of ``fn`` under the profiler (the host and
    the card)."""
    import json

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _launched_in(events, prefix: str) -> dict:
    """Device kernels by the program span (name starting with ``prefix``)
    whose host range holds their launch, matched through the launch's
    correlation id: {span name: [kernel base names]}."""
    x = [e for e in events if e.get("ph") == "X"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in x
             if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)]
    at = {e["args"]["correlation"]: e["ts"] for e in x
          if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    out = {}
    for e in x:
        if e.get("cat") != "kernel" or e["args"].get("correlation") not in at:
            continue
        t = at[e["args"]["correlation"]]
        name = e["name"].replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()[-1]
        name = name.split("::")[-1]
        for s, a, b in spans:
            if a <= t < b:
                out.setdefault(s, []).append(name)
    return out


def test_kernel_spans_on_card(cuda, tmp_path):
    """Each of K1-K6 launches inside its ``kernel.<name>`` span, and the
    span holds its kernels and nothing else."""
    _kernel_runs(cuda)
    got = {k: sorted(v) for k, v in _launched_in(_traced(lambda: _kernel_runs(cuda), tmp_path), "kernel.").items()}
    assert set(got) == {"kernel." + k for k in WRAPPERS}, got
    assert got["kernel.density"] == ["density_kernel"]
    for k in ("nn_min", "corr_argmax"):
        assert got["kernel." + k][0] == k + "_kernel" and set(got["kernel." + k][1:]) <= {k + "_merge_kernel"}
    assert got["kernel.bundle_loss"] == ["bundle_loss_kernel", "dw_kernel", "sum_slices", "sum_slices"]
    assert got["kernel.field_color_fwd"] == ["field_color_fwd_kernel"]
    assert got["kernel.field_color_bwd"] == ["dw_kernel", "field_color_bwd_kernel", "sum_slices", "sum_slices"]


def test_fused_nerf_step_spans_on_card(cuda, tmp_path):
    """Two fused NeRF steps (full-width bf16 fields, 2 halves x 2 cams x
    200 rays): each step's coarse and fine passes launch K4 once, inside
    ``nerf.coarse`` and ``nerf.fine`` under ``nerf.field``."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import NerfTrainConfig, RenderConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    halves = [synthetic.make_scene(8, 64, torch.Generator(device=cuda).manual_seed(h), device=cuda) for h in (0, 1)]
    args = [torch.stack([getattr(h, f) for h in halves]) for f in ("images", "sils", "R_bop", "t_bop", "K")]
    kw = dict(field_cfg=FieldConfig(act_dtype="bfloat16"), render_cfg=RenderConfig(n_rays_per_image=200),
              train_cfg=NerfTrainConfig(batch_size=2, warmup_steps=10), n_steps=2, seed=1, device=cuda, mesh=None)
    nerf_trainer.train_nerf_fused(*args, **kw)
    events = _traced(lambda: nerf_trainer.train_nerf_fused(*args, **kw), tmp_path)
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    named = lambda n: [(e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == n]  # noqa: E731
    inside = lambda s, outer: any(a <= s[0] and s[1] <= b for a, b in named(outer))  # noqa: E731
    assert len(named("nerf.field")) == 2
    for stage in ("nerf.coarse", "nerf.fine"):
        assert len(named(stage)) == 2 and all(inside(s, "nerf.field") for s in named(stage))
    launches = named("kernel.bundle_loss")
    assert len(launches) == 4
    assert sum(inside(s, "nerf.coarse") for s in launches) == sum(inside(s, "nerf.fine") for s in launches) == 2
    k4 = _launched_in(events, "kernel.bundle_loss")["kernel.bundle_loss"]
    assert sorted(k4) == sorted(["bundle_loss_kernel", "sum_slices", "dw_kernel", "sum_slices"] * 4)


def test_field_config_default_trains_through_the_act32_kernels(cuda, tmp_path):
    """``FieldConfig()`` (float32 activations) on the card: a fused NeRF
    step runs K4's float32-activation variant, its launches counted apart,
    its ``kernel.bundle_loss_act32`` spans holding ``bundle_loss_act32_kernel``
    and no ``bundle_loss_kernel`` anywhere in the trace; a chunked step runs
    K5 / K6's float32 variants; the density grid runs K1."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import NerfTrainConfig, RenderConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    halves = [synthetic.make_scene(8, 64, torch.Generator(device=cuda).manual_seed(h), device=cuda) for h in (0, 1)]
    args = [torch.stack([getattr(h, f) for h in halves]) for f in ("images", "sils", "R_bop", "t_bop", "K")]
    kw = dict(field_cfg=FieldConfig(), render_cfg=RenderConfig(n_rays_per_image=200),
              train_cfg=NerfTrainConfig(batch_size=2, warmup_steps=10), n_steps=2, seed=1, device=cuda, mesh=None)
    cuda_build.reset(field_kernel.bundle_loss_cuda)
    states, _ = nerf_trainer.train_nerf_fused(*args, **kw)
    assert field_kernel.bundle_loss_cuda.by_name == {"bundle_loss_act32": 4}  # 2 steps x (coarse + fine)
    events = _traced(lambda: nerf_trainer.train_nerf_fused(*args, **kw), tmp_path)
    k4 = _launched_in(events, "kernel.")
    assert set(k4) == {"kernel.bundle_loss_act32"}, set(k4)
    assert sorted(k4["kernel.bundle_loss_act32"]) == sorted(
        ["bundle_loss_act32_kernel", "sum_slices", "dw_kernel", "sum_slices"] * 4)
    assert not any(e.get("cat") == "kernel" and "bundle_loss_kernel" in e["name"] for e in events)
    # a chunked step (400 rays a half in chunks of 256 + 144): K5 / K6's float32 variants
    cuda_build.reset(field_kernel.field_color_fwd_cuda)
    cuda_build.reset(field_kernel.field_color_bwd_cuda)
    nerf_trainer.train_nerf_fused(*args, **kw, ray_chunk=256)
    assert field_kernel.field_color_fwd_cuda.by_name == {"field_color_fwd_act32": 8}
    assert field_kernel.field_color_bwd_cuda.by_name == {"field_color_bwd_act32": 8}
    events = _traced(lambda: nerf_trainer.train_nerf_fused(*args, **kw, ray_chunk=256), tmp_path)
    assert set(_launched_in(events, "kernel.")) == {"kernel.field_color_fwd_act32", "kernel.field_color_bwd_act32"}
    # K1 for the density grid of a FieldConfig() field
    field = states[0].fine
    assert field_kernel.density_eval_fn(field) != field.density
    dens = field_kernel.density_cuda.launches
    renderer.density_grid_cached(field, grid_res=32)
    assert field_kernel.density_cuda.launches > dens


@pytest.mark.parametrize("act", ["bfloat16", "float32"])
def test_fused_nerf_step_waits_on_no_host_copy(cuda, act):
    """A fused NeRF step (K4) on the card makes no host sync: a copy of a
    host value to the card waits for everything queued there, and the host,
    not the card, then sets the step's pace."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import NerfTrainConfig, RenderConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import nerf_trainer

    halves = [synthetic.make_scene(8, 64, torch.Generator(device=cuda).manual_seed(h), device=cuda) for h in (0, 1)]
    images, sils, R, t, K = (torch.stack([getattr(h, f) for h in halves])[:, :2]
                             for f in ("images", "sils", "R_bop", "t_bop", "K"))
    min_d, max_d = nerf_trainer.depth_bounds(t.reshape(-1, 3).cpu().numpy())
    cam = cameras.camera_from_bop(R, t, K, 64)
    field_cfg = FieldConfig(act_dtype=act)
    render_cfg, train_cfg = RenderConfig(n_rays_per_image=200), NerfTrainConfig(batch_size=2, warmup_steps=10)
    states = [nerf_trainer.init_state(field_cfg, train_cfg, torch.Generator().manual_seed(h), device=cuda)
              for h in (0, 1)]
    opt = nerf_trainer.make_optimizer(train_cfg)
    gens = [torch.Generator(device=cuda).manual_seed(h) for h in (0, 1)]

    def step(sts):
        return nerf_trainer.train_step(sts, cam, images, sils, opt, render_cfg, train_cfg, min_d, max_d,
                                       generators=gens)[0]

    states = step(states)                      # builds the kernels
    torch.cuda.synchronize()
    cuda_build.reset(field_kernel.bundle_loss_cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        states = step(states)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert field_kernel.bundle_loss_cuda.by_name == {field_kernel._variant("bundle_loss", act == "float32"): 2}


# ------------------------------------------------------------ RANSAC as a CUDA graph


def _ransac_inputs(dev, B: int, seed: int, S: int = 75, n_hyp: int = 500):
    """Correspondences as serving makes them (224 px crops at stride 3: a 75
    x 75 pixel grid, N = 5,625): each pixel's point on a plane at depth
    0.6-0.7 under a pose drawn from ``seed``, 40 % of them replaced by
    random points, 80 % of the pixels kept by the confidence filter, and
    ``n_hyp`` draws of 4 from the kept: (p3d, p2d, K, weights, samples)."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import rotvec_to_matrix

    g = torch.Generator(device=dev).manual_seed(seed)
    N = S * S
    yy = torch.arange(S, device=dev)
    gy, gx = torch.meshgrid(yy, yy, indexing="ij")
    p2d = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).to(torch.float32)
    K = torch.tensor([[170.0, 0.0, 37.0], [0.0, 170.0, 37.0], [0.0, 0.0, 1.0]], device=dev).expand(B, 3, 3).contiguous()
    R = rotvec_to_matrix(0.5 * torch.randn((B, 3), generator=g, device=dev))
    t = torch.tensor([0.0, 0.0, 0.65], device=dev) + 0.02 * torch.randn((B, 3), generator=g, device=dev)
    z = 0.6 + 0.1 * torch.rand((B, N), generator=g, device=dev)
    xc = torch.stack([(p2d[:, 0] - 37.0) / 170.0 * z, (p2d[:, 1] - 37.0) / 170.0 * z, z], -1)
    p3d = (xc - t[:, None]) @ R                                           # R^T (xc - t), row form
    out = torch.rand((B, N), generator=g, device=dev) < 0.4
    p3d = torch.where(out[..., None], 0.1 * torch.randn((B, N, 3), generator=g, device=dev), p3d)
    w = (torch.rand((B, N), generator=g, device=dev) < 0.8).to(torch.float32)
    samples = torch.multinomial(w.clamp_min(1e-12), n_hyp * 4, replacement=True, generator=g).view(B, n_hyp, 4)
    return p3d.contiguous(), p2d, K, w, samples


@pytest.mark.parametrize("B", [16, 1])
def test_ransac_graph_matches_eager_body(cuda, B, monkeypatch):
    """At serving's shape (B x 5,625 correspondences, 500 hypotheses, 10
    refinement steps) and at one image: three calls with different inputs
    capture one graph and replay it twice, each result bit-identical to the
    eager body on the same inputs and unchanged by the calls after it, and
    a replay syncs with the host only in the op cut out of the graph (the
    SVD's convergence check)."""
    from collections import OrderedDict

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp

    monkeypatch.setattr(pnp, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(pnp, "GRAPH_COUNT", dict.fromkeys(pnp.GRAPH_COUNT, 0))
    svd = torch.linalg.svd

    def svd_allowed_to_sync(*a, **k):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return svd(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(torch.linalg, "svd", svd_allowed_to_sync)
    calls = [_ransac_inputs(cuda, B, seed) for seed in (11, 12, 13)]
    got, kept = [], []
    for i, (p3d, p2d, K, w, samples) in enumerate(calls):
        torch.cuda.set_sync_debug_mode("error" if i else 0)
        try:
            got.append(pnp.ransac_pnp(p3d, p2d, K, weights=w, samples=samples))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        kept.append([x.clone() for x in got[-1]])
    assert pnp.GRAPH_COUNT == {"captures": 1, "replays": 2, "eager": 0}
    assert len(pnp._GRAPHS) == 1
    for (p3d, p2d, K, w, samples), res, before in zip(calls, got, kept):
        want = pnp.ransac_body(p3d, p2d, K, w, None, samples, reproj_err=2.0, refine_iters=10)
        for name, a, b, c in zip(pnp.RansacResult._fields, res, want, before):
            assert torch.equal(a, b), name
            assert torch.equal(a, c), name
        assert bool(res.success.all()) and int(res.n_inliers.min()) > 1000
    assert not torch.equal(got[0].R, got[1].R)


def test_ransac_replay_spans_on_card(cuda, tmp_path, monkeypatch):
    """A replayed RANSAC call opens ``pnp.replay`` and no other ``pnp.``
    span, and the graph's kernels are launched inside it (by the graph
    launch's correlation)."""
    from collections import OrderedDict

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pnp

    monkeypatch.setattr(pnp, "_GRAPHS", OrderedDict())
    p3d, p2d, K, w, samples = _ransac_inputs(cuda, 2, 5, n_hyp=64)
    pnp.ransac_pnp(p3d, p2d, K, weights=w, samples=samples)
    events = _traced(lambda: pnp.ransac_pnp(p3d, p2d, K, weights=w, samples=samples), tmp_path)
    spans = {e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    assert {s for s in spans if s.startswith("pnp.")} == {"pnp.replay"}
    kernels = _launched_in(events, "pnp.")["pnp.replay"]
    assert "batched_svd_parallel_jacobi_32x16" in kernels and len(kernels) > 500
