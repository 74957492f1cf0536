"""Plain versions of kernels K1-K3 against the reference's Pallas kernels in
interpret mode, and the CPU side of the kernel dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.models import fields as jfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import field_kernel as jfk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import pallas_kernels as pk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models import fields as tfields
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as tfk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as tpk
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as tpc

torch.set_num_threads(1)


def _field(embed, seed=0):
    cfg = FieldConfig(n_harmonic_functions=8, n_hidden=48, act_dtype="bfloat16", embed_method=embed)
    jf = jfields.NerfField(cfg)
    params = jfields.init_field(jf, jax.random.PRNGKey(seed))
    tf = tfields.NerfField(cfg)
    tf.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params)))
    return cfg, jf, params, tf


@pytest.mark.parametrize("embed", ["direct", "grouped"])
def test_density_plain_matches_pallas_and_flax(embed):
    cfg, jf, params, tf = _field(embed)
    # a ragged count (not a multiple of the reference's 4096-point tile)
    pts = (np.random.default_rng(2).normal(size=(301, 3)) * 0.6).astype(np.float32)
    ours = tfk.field_density(tf, torch.from_numpy(pts)).numpy()
    pallas = np.asarray(jfk.field_density(params, jnp.asarray(pts), cfg, interpret=True))
    flax_d = np.asarray(jf.apply(params, jnp.asarray(pts), method=jf.density))
    assert ours.shape == pallas.shape == (301, 1)
    # same rounding points as the Pallas kernel: f32 sum order may flip a
    # bf16 rounding of h1, worth ~1e-4 in the density
    np.testing.assert_allclose(ours, pallas, atol=1e-3, rtol=0)
    # the flax path rounds at other points (bf16 matmul outputs, bf16 bias)
    np.testing.assert_allclose(ours, flax_d, atol=2e-2, rtol=2e-2)


def test_density_dispatch_on_cpu():
    cfg, _, _, tf = _field("direct")
    pts = torch.zeros((4, 3))
    # off CUDA the auto dispatch is the field's own (flax-numerics) density
    assert tfk.density_eval_fn(tf) == tf.density
    assert not tfk.enabled(cfg, "cpu") and tfk.enabled(cfg, "cuda")
    assert tfk.enabled(FieldConfig(fused_kernel=True), "cpu")
    assert tfk.enabled(FieldConfig(), "cuda")  # f32 activations: the kernels' float32-activation variant
    assert not tfk.enabled(FieldConfig(compute_dtype="float32"), "cuda")  # f32 products: not the kernels'
    before = tfk.density_cuda.launches
    tfk.field_density(tf, pts)
    assert tfk.density_cuda.launches == before  # CPU tensors take the plain version
    with pytest.raises(ValueError):
        tfk.density_op(torch.zeros((4, 3), device="meta"), tfk.density_weights(tf), 0, 10.0)


@pytest.mark.parametrize("embed", ["direct", "grouped"])
def test_field_constants_made_once_per_device(embed):
    """The frequency matrix and the ladder's permutations on a device are
    the host arrays, made there once and shared by later calls."""
    cfg = FieldConfig(n_harmonic_functions=8, embed_method=embed)
    fm = tfk.fmat_on(cfg, "cpu")
    np.testing.assert_array_equal(fm.numpy(), tfk.fmat_of(cfg))
    assert tfk.fmat_on(cfg, torch.device("cpu")) is fm
    ladder = tfk.ladder_of(cfg)
    if ladder:
        perm = tfk.ladder_perm_on(8, ladder, "cpu")
        np.testing.assert_array_equal(perm.numpy(), tfk.ladder_perm(8, ladder))
        assert torch.equal(perm[tfk.ladder_perm_on(8, ladder, "cpu", inverse=True)], torch.arange(len(perm)))
        assert tfk.ladder_perm_on(8, ladder, "cpu") is perm


@pytest.mark.parametrize("n,m", [(333, 3001), (64, 700)])
def test_nn_min_plain_matches_pallas(n, m):
    rng = np.random.default_rng(n)
    q = rng.normal(size=(n, 3)).astype(np.float32)
    r = rng.normal(size=(m, 3)).astype(np.float32)
    mask = rng.uniform(size=m) > 0.3
    d_p, i_p = pk.nn_min(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask),
                         tile_n=128, tile_m=512, interpret=True)
    d_t, i_t = tpk.nn_min(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(mask))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    assert i_t.dtype == torch.int32
    # exact ties go to the lowest index
    dup = np.concatenate([r[:10], r[:10]])
    _, i_dup = tpk.nn_min(torch.from_numpy(dup[:3] + 0.0), torch.from_numpy(dup))
    np.testing.assert_array_equal(i_dup.numpy(), [0, 1, 2])
    c_t = float(tpk.chamfer_distance(torch.from_numpy(q), torch.from_numpy(r)))
    c_p = float(pk.chamfer_distance(jnp.asarray(q), jnp.asarray(r), interpret=True))
    np.testing.assert_allclose(c_t, c_p, rtol=1e-6)


def test_nn_query_raises_on_empty():
    with pytest.raises(ValueError):
        tpc.nn_query(torch.zeros((0, 3)), torch.zeros((5, 3)))
    with pytest.raises(ValueError):
        tpc.nn_query(torch.zeros((5, 3)), torch.zeros((0, 3)))


@pytest.mark.parametrize("n,m", [(300, 5000), (37, 2049)])
def test_correspondence_plain_matches_pallas(n, m):
    rng = np.random.default_rng(m)
    q = rng.normal(size=(n, 12)).astype(np.float32)
    k = rng.normal(size=(m, 12)).astype(np.float32)
    i_p, c_p = pk.correspondence_argmax(jnp.asarray(q), jnp.asarray(k), interpret=True)
    i_t, c_t = tpk.correspondence_argmax(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_p), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,m,slots", [
    (1, 50_000, 1320),       # one query tile: the most splits
    (913, 14_018, 1320),     # the serve's ICP launch
    (913, 913, 1320),        # verify_consecutive's Chamfers
    (50_000, 50_000, 1320),
    (45_000, 1_024, 528),    # K3 in the serve: 8 crops against the padded keys
    (45_000, 80_000, 528),
    (45_000, 80_000, 396),
    (300_000, 10**6, 1320),  # the query tiles alone fill the card
    (5_000, 100, 1320),      # fewer references than two splits' minimum
    (1, 128, 1320),          # exactly two splits' minimum
    (7, 100_003, 1),         # a card of one block
    (10, 50_001, 1320),      # M prime to every split count
])
def test_split_plan(n, m, slots):
    splits, length = tpk.split_plan(n, m, slots, 512)
    assert 1 <= splits <= 65535 and length >= 1
    assert splits * length >= m                       # the splits cover every reference
    assert (splits - 1) * length < m                  # no planned split is empty
    tiles = -(-n // 512)
    if tiles >= slots or m < 2 * tpk.MIN_SPLIT:
        assert splits == 1
    else:
        assert length >= tpk.MIN_SPLIT and tiles * splits <= tpk.MAX_WAVES * slots


def test_split_plan_values():
    # K2 (10 blocks an SM on 132 SMs) at the serve's ICP shape and at 50k x
    # 50k; K3 (4 an SM) at the serve's shape, one crop and 8 crops against
    # 80,000 keys; 512 queries a block
    assert tpk.split_plan(913, 14_018, 1320, 512) == (216, 65)
    assert tpk.split_plan(50_000, 50_000, 1320, 512) == (13, 3847)
    assert tpk.split_plan(45_000, 1_024, 528, 512) == (6, 171)
    assert tpk.split_plan(5_625, 80_000, 528, 512) == (46, 1740)
    assert tpk.split_plan(45_000, 80_000, 528, 512) == (6, 13334)


def _slices(m, n_splits):
    """The kernels' split of M: (start, stop) of each of n_splits slices."""
    length = -(-m // n_splits)
    return [(min(s * length, m), min((s + 1) * length, m)) for s in range(n_splits)]


def _nn_split(q, r, mask, n_splits):
    """K2's partials taken slice by slice with the plain per-slice function
    (a slice's index is global where it found a point, else 0, as the
    kernel's), then the plain merge pass."""
    parts = []
    for a, b in _slices(r.shape[0], n_splits):
        d, i = tpk.nn_min_sq_plain(q, r[a:b], None if mask is None else mask[a:b])
        parts.append((d, torch.where(d < 1e30, i + a, 0).to(torch.int32)))
    return tpk.nn_min_merge_plain(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))


@pytest.mark.parametrize("n,m,n_splits", [(333, 3001, 1), (333, 3001, 3), (64, 700, 7), (64, 700, 9)])
def test_nn_min_split_merge_matches_unsplit_and_pallas(n, m, n_splits):
    rng = np.random.default_rng(n + m)
    q = rng.normal(size=(n, 3)).astype(np.float32)
    r = rng.normal(size=(m, 3)).astype(np.float32)
    mask = rng.uniform(size=m) > 0.3
    # exact duplicates on both sides of the first split boundary, both
    # valid, and a query on them: the lower index must win
    b = _slices(m, max(n_splits, 2))[1][0]
    r[b] = r[b - 1]
    mask[b - 1] = mask[b] = True
    q[0] = r[b]
    qt, rt, mt = torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(mask)
    d_s, i_s = _nn_split(qt, rt, mt, n_splits)
    d_u, i_u = tpk.nn_min_plain(qt, rt, mt)
    assert torch.equal(d_s, d_u) and torch.equal(i_s, i_u)  # bit for bit
    assert int(i_s[0]) == b - 1 and float(d_s[0]) == 0.0
    d_p, i_p = pk.nn_min(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask), tile_n=128, tile_m=512,
                         interpret=True)
    np.testing.assert_array_equal(i_s.numpy(), np.asarray(i_p))
    # the interpreted Pallas kernel (XLA's CPU code) rounds a few distances
    # an ulp apart from the unfused f32 chain
    np.testing.assert_allclose(d_s.numpy(), np.asarray(d_p), atol=1e-6, rtol=0)
    # every reference masked: (sqrt(1e30), 0) from every partial and the merge
    none = torch.zeros(m, dtype=torch.bool)
    d_0, i_0 = _nn_split(qt, rt, none, n_splits)
    d_0u, i_0u = tpk.nn_min_plain(qt, rt, none)
    assert torch.equal(d_0, d_0u) and torch.equal(i_0, i_0u) and not bool(i_0.any())
    assert torch.equal(d_0, torch.full((n,), float(np.sqrt(np.float32(1e30))), dtype=torch.float32))


@pytest.mark.parametrize("n,m,n_splits", [(300, 5000, 1), (300, 5000, 4), (37, 2049, 9)])
def test_correspondence_split_merge_matches_unsplit_and_pallas(n, m, n_splits):
    rng = np.random.default_rng(m + n_splits)
    q = rng.normal(size=(n, 12)).astype(np.float32)
    k = rng.normal(size=(m, 12)).astype(np.float32)
    # duplicated keys on both sides of the first split boundary, the argmax
    # of the first queries with an exact logit (24): the first occurrence wins
    b = _slices(m, max(n_splits, 2))[1][0]
    k[b - 1] = k[b] = 2.0
    q[:3] = 1.0
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    parts = []
    for a, z in _slices(m, n_splits):
        best, arg, m_run, s_run = tpk.correspondence_partial_plain(qt, kt[a:z])
        parts.append((best, arg + a, m_run, s_run))
    i_s, c_s = tpk.correspondence_merge_plain(*(torch.stack(x) for x in zip(*parts)))
    i_u, c_u = tpk.correspondence_argmax_plain(qt, kt)
    i_p, c_p = pk.correspondence_argmax(jnp.asarray(q), jnp.asarray(k), interpret=True)
    assert i_s[:3].tolist() == [b - 1] * 3
    np.testing.assert_array_equal(i_s.numpy(), i_u.numpy())
    np.testing.assert_array_equal(i_s.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(c_s.numpy(), c_u.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(c_s.numpy(), np.asarray(c_p), atol=1e-5, rtol=0)


def test_fps_matches_reference():
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import pointcloud as jpc

    pts = np.random.default_rng(4).normal(size=(500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    mask[:3] = False
    i_j = np.asarray(jpc.farthest_point_sampling(jnp.asarray(pts), 60, jnp.asarray(mask)))
    i_t = tpc.farthest_point_sampling(torch.from_numpy(pts), 60, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(i_t, i_j)
