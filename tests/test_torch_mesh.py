"""The port's multi-device layer (``parallel/mesh.py``) and the serving
stages that take a mesh, on the CPU.

The reference runs on ``mesh_lib.make_mesh(n)`` over the virtual CPU
devices of ``conftest.py``, the port on ``Mesh(("cpu",) * n)``: the same
code path a list of cards takes, every entry on the CPU.  Inputs are
numpy arrays from fixed seeds; where the reference draws random numbers
the port is handed its draws.  The bars are the reference's own for its
sharded-against-single checks (``test_parallel_pointcloud.py``: distances
rtol 1e-5, indices equal, ICP 1e-4; ``test_parallel_pipeline.py``: poses
1e-4 / 1e-5), or the standing divergence the port's unsharded parity test
of the same function already bounds by its cause.  The port's own
invariants: a 1-entry mesh is bit-identical to no mesh, 3 entries (uneven
shards) agree with no mesh, and ``mesh="auto"`` on the CPU is no mesh.
SurfEmb's sharded hypotheses and sequence are in ``test_torch_surfemb.py``
beside their unsharded parity tests (they share its scene).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.config import InferenceConfig as JInferenceConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import pointcloud as jpc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.parallel import mesh as jmesh
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import inference as jinf
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import registration as jreg
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import InferenceConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import pointcloud as tpc
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.parallel import mesh as tmesh
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import inference as tinf
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import registration as treg
from test_torch_slice import _unit, inference_state, slice_state  # noqa: F401  (fixtures)

torch.set_num_threads(1)


def cpu_mesh(n):
    return tmesh.Mesh(["cpu"] * n)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _cloud(n, scale=1.0, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(np.float32)


# ----------------------------------------------------------------- the layer


@pytest.mark.parametrize("n_entries", [1, 2, 3, 4, 7])
def test_slices_cut_as_tensor_split(n_entries):
    mesh = cpu_mesh(n_entries)
    for n in range(12):
        x = torch.arange(n)
        want = torch.tensor_split(x, n_entries)
        assert [x[s].tolist() for s in tmesh.slices(n, mesh)] == [w.tolist() for w in want]
        assert [s for _, _, s in tmesh.shards(n, mesh)] == [s for s in tmesh.slices(n, mesh) if s.stop > s.start]


def test_shard_gather_round_trip_keeps_the_tree():
    mesh = cpu_mesh(3)
    cam = tinf.SurfEmbDraws(torch.arange(10.0), torch.arange(20.0).reshape(10, 2), None)
    parts = tmesh.shard_leading(cam, mesh)
    assert [p.u.shape[0] for p in parts] == [4, 3, 3] and all(p.sel is None for p in parts)
    back = tmesh.gather(parts, mesh)
    assert torch.equal(back.u, cam.u) and torch.equal(back.pick, cam.pick) and back.sel is None
    with pytest.raises(ValueError, match="leading"):
        tmesh.shard_leading((torch.zeros(3), torch.zeros(4)), mesh)


def test_replicate_is_distinct_and_broadcast_shares():
    mesh = cpu_mesh(2)
    lin = torch.nn.Linear(3, 2)
    a, b = tmesh.replicate(lin, mesh)
    assert a is not b and a.weight.data_ptr() != b.weight.data_ptr() != lin.weight.data_ptr()
    assert torch.equal(a.weight, lin.weight) and torch.equal(b.bias, lin.bias)
    x = torch.ones(4)
    c, d = tmesh.replicate(x, mesh)
    assert c.data_ptr() != d.data_ptr() != x.data_ptr()
    e, f = tmesh.broadcast(x, mesh)
    assert e.data_ptr() == f.data_ptr() == x.data_ptr()


def test_reductions_run_in_entry_order():
    mesh = cpu_mesh(3)
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(1000, generator=g) * 10 ** k for k in (0, 4, -3)]
    assert torch.equal(tmesh.reduce_sum(parts, mesh), (parts[0] + parts[1]) + parts[2])
    homes = [torch.nn.Parameter(torch.zeros(1000))]
    reps = [[torch.nn.Parameter(torch.zeros(1000))] for _ in parts]
    for r, p in zip(reps, parts):
        r[0].grad = p.clone()
    tmesh.reduce_grads_(homes, reps)
    assert torch.equal(homes[0].grad, (parts[0] + parts[1]) + parts[2])
    assert homes[0].grad.data_ptr() != reps[0][0].grad.data_ptr()
    with torch.no_grad():
        homes[0].add_(1.5)
    tmesh.copy_params_(homes, reps)
    assert all(torch.equal(r[0], homes[0]) and r[0].data_ptr() != homes[0].data_ptr() for r in reps)


@pytest.mark.parametrize("n,k", [(16, 8), (12, 8), (3, 8), (7, 4), (1, 8), (10, 3), (0, 2)])
def test_sizes_match_reference(n, k):
    assert tmesh.pad_to_multiple(n, k) == jmesh.pad_to_multiple(n, k)
    if n:
        assert tmesh.largest_divisor_mesh_size(n, k) == jmesh.largest_divisor_mesh_size(n, k)


def test_auto_on_the_cpu_is_no_mesh():
    assert tmesh.auto_mesh(device="cpu") is None
    assert tmesh.resolve("auto", "cpu") is None
    assert tmesh.place("auto", "cpu") == (None, torch.device("cpu"))
    if not torch.cuda.is_available():
        assert tmesh.auto_mesh() is None
        with pytest.raises(ValueError):
            tmesh.make_mesh(1)
    mesh = cpu_mesh(2)
    assert tmesh.place(mesh) == (mesh, torch.device("cpu"))
    assert tmesh.resolve(mesh, "cpu") is mesh
    with pytest.raises(ValueError, match="home"):
        tmesh.resolve(mesh, "meta")
    with pytest.raises(ValueError):
        tmesh.resolve("all")
    with pytest.raises(ValueError):
        tmesh.Mesh([])


# ----------------------------------------------------------- the point ops


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_nn_query_sharded(n):
    q, ref = _cloud(1003, seed=1), _cloud(517, seed=2)
    mask = np.arange(517) % 5 != 0
    d0, i0 = tpc.nn_query(_t(q), _t(ref), torch.from_numpy(mask))
    d1, i1 = tpc.nn_query(_t(q), _t(ref), torch.from_numpy(mask), mesh=cpu_mesh(n))
    # K2's plain version is exact and takes the lowest index: the split
    # changes nothing
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    c0 = tpc.chamfer_distance(_t(q), _t(ref))
    c1 = tpc.chamfer_distance(_t(q), _t(ref), mesh=cpu_mesh(n))
    assert torch.equal(c0, c1)
    # exact: the f64 distance to the same index, which is a nearest one
    d64 = np.sqrt(((q[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1))
    d64 = np.where(mask[None], d64, np.inf)
    rows = np.arange(q.shape[0])
    np.testing.assert_allclose(d1.numpy(), d64[rows, i1.numpy()], rtol=1e-6)
    np.testing.assert_array_equal(d64[rows, i1.numpy()], d64.min(1))
    if n in (2, 4):
        dj, ij = map(np.asarray, jpc.nn_query(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask),
                                              mesh=jmesh.make_mesh(n)))
        # the reference's sharded sweep squares distances as |a|^2 + |b|^2 -
        # 2 a.b (f32): its error is the cancellation's, a few ulps of |a|^2 +
        # |b|^2; an index differs only where two references are that close
        ulps = 4 * 2.0 ** -23 * ((q ** 2).sum(-1) + (ref[ij] ** 2).sum(-1))
        assert (np.abs(d1.numpy().astype(np.float64) ** 2 - dj.astype(np.float64) ** 2) <= ulps).all()
        flip = i1.numpy() != ij
        assert (np.abs(d64[rows, ij] ** 2 - d64[rows, i1.numpy()] ** 2)[flip] <= 2 * ulps[flip]).all()
        assert flip.mean() < 1e-2
        cj = float(jpc.chamfer_distance(jnp.asarray(q), jnp.asarray(ref), mesh=jmesh.make_mesh(n)))
        np.testing.assert_allclose(float(c1), cj, rtol=1e-5)


# ---------------------------------------------------------- registration


def _icp_inputs():
    src = _cloud(600, seed=7)
    ang = 0.2
    R_true = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.05, -0.03, 0.08], np.float32)
    return src, src @ R_true.T + t_true, R_true


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_icp_sharded(n):
    src, tgt, R_true = _icp_inputs()
    kw = dict(threshold=1.0, max_iters=15)
    r0 = treg.icp_point_to_point(_t(src), _t(tgt), torch.eye(3), torch.zeros(3), **kw)
    r1 = treg.icp_point_to_point(_t(src), _t(tgt), torch.eye(3), torch.zeros(3), mesh=cpu_mesh(n), **kw)
    if n == 1:
        assert all(torch.equal(a, b) for a, b in zip(r0, r1))
    for a, b in zip(r0, r1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)
    np.testing.assert_allclose(r1.R.numpy(), R_true, atol=1e-3)
    if n in (2, 4):
        rj = jreg.icp_point_to_point(jnp.asarray(src), jnp.asarray(tgt), jnp.eye(3), jnp.zeros(3),
                                     mesh=jmesh.make_mesh(n), **kw)
        np.testing.assert_allclose(r1.R.numpy(), np.asarray(rj.R), atol=1e-4)
        np.testing.assert_allclose(r1.t.numpy(), np.asarray(rj.t), atol=1e-4)
        assert float(r1.fitness) == float(rj.fitness) == 1.0
        # at the converged pose every point sits on its target: the port's
        # exact distances give an rmse of f32 rounding, the reference's
        # |a|^2 + |b|^2 - 2 a.b the square root of its cancellation
        # (~sqrt(4 ulps of |a|^2 + |b|^2))
        assert float(r1.inlier_rmse) < 1e-5 and float(rj.inlier_rmse) < 1e-3


def _agreement_inputs(n=6):
    rng = np.random.default_rng(8)
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)])
    R = (R * np.sign(np.linalg.det(R))[:, None, None]).astype(np.float32)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    Rp = (R + rng.normal(size=R.shape) * 0.01).astype(np.float32)
    return R, t, Rp, _cloud(128, seed=9)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_agreement_matrix_sharded(n):
    R, t, Rp, verts = _agreement_inputs()
    rel = [*treg.relative_pose_tensor(_t(R), _t(t)), *treg.relative_pose_tensor(_t(Rp), _t(t))]
    # a diameter whose 0.1 falls among the errors, so the matrix is mixed
    _, e = treg.agreement_matrix(*rel, _t(verts), 1.0, pair_chunk=16)
    diam = 10 * float(np.median(np.unique(e.numpy())))
    a0, e0 = treg.agreement_matrix(*rel, _t(verts), diam, pair_chunk=16)
    a1, e1 = treg.agreement_matrix(*rel, _t(verts), diam, pair_chunk=16, mesh=cpu_mesh(n))
    if n == 1:
        assert torch.equal(e0, e1)
    np.testing.assert_allclose(e1.numpy(), e0.numpy(), rtol=1e-3, atol=1e-5)
    assert torch.equal(a0, a1) and 0 < int(a1.sum()) < 36
    if n in (2, 4):
        jrel = [*jreg.relative_pose_tensor(jnp.asarray(R), jnp.asarray(t)),
                *jreg.relative_pose_tensor(jnp.asarray(Rp), jnp.asarray(t))]
        aj, ej = jreg.agreement_matrix(*jrel, jnp.asarray(verts), diam, pair_chunk=16, mesh=jmesh.make_mesh(n))
        # the unsharded parity test's bar (test_torch_modules.py)
        np.testing.assert_allclose(e1.numpy(), np.asarray(ej), atol=1e-4)
        np.testing.assert_array_equal(a1.numpy(), np.asarray(aj))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_register_halves_and_verification_sharded(n):
    rng = np.random.default_rng(10)
    cad = rng.normal(size=(800, 3)).astype(np.float32)
    upper = cad[:400] + rng.normal(size=(400, 3)).astype(np.float32) * 1e-3
    lower = cad[400:]
    kw = dict(diameter=4.0, icp_threshold=0.5, icp_iters=5)
    pose = (np.eye(3), np.zeros(3), np.eye(3), np.array([0.02, 0.0, -0.01]))
    o0 = treg.register_halves(upper, lower, *pose, cad, device="cpu", **kw)
    o1 = treg.register_halves(upper, lower, *pose, cad, mesh=cpu_mesh(n), **kw)
    for k in ("R", "t"):
        np.testing.assert_allclose(o1[k], o0[k], atol=1e-4)
    np.testing.assert_allclose(o1["chamfer"], o0["chamfer"], rtol=1e-5)
    assert o1["merged"].shape == (800, 3) and o1["correct"] == o0["correct"]
    if n == 1:
        assert all(np.array_equal(o0[k], o1[k]) for k in ("R", "t", "merged", "chamfer", "fitness"))
    V = 6
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(V)]).astype(np.float32)
    R = R * np.sign(np.linalg.det(R))[:, None, None]
    t = rng.normal(size=(V, 3)).astype(np.float32)
    Rp = (R + rng.normal(size=R.shape) * 0.01).astype(np.float32)
    b0, c0 = treg.verify_consecutive(cad[:300], R, t, Rp, t, device="cpu")
    b1, c1 = treg.verify_consecutive(cad[:300], R, t, Rp, t, mesh=cpu_mesh(n))
    assert b1 == b0 and c1 == c0  # exact K2 distances, means on home
    if n in (2, 4):
        oj = jreg.register_halves(upper, lower, *pose, cad, mesh=jmesh.make_mesh(n), **kw)
        for k in ("R", "t"):
            np.testing.assert_allclose(o1[k], oj[k], atol=1e-4)
        np.testing.assert_allclose(o1["chamfer"], oj["chamfer"], rtol=1e-4)
        bj, cj = jreg.verify_consecutive(cad[:300], R, t, Rp, t, mesh=jmesh.make_mesh(n))
        assert b1 == bj
        np.testing.assert_allclose(c1, cj, rtol=1e-4)


# -------------------------------------------------------------- inference


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_run_sequence_sharded(inference_state, slice_state, n):  # noqa: F811
    """The serving slice's 4 images (ideal query maps, the reference's baked
    keys) split over the mesh.  With the reference's RANSAC draws handed in,
    the poses are the unsharded run's; with the port's own generator too
    (its draws are made on home for the whole batch, in the order the
    unsharded run makes them)."""
    inf, st = inference_state, slice_state
    verts, feats = st["jout"][0], _unit(st["jout"][1])
    args = (inf["tnet"], inf["imgs"], inf["masks"], inf["Ks"], verts, feats)
    cfg = InferenceConfig()
    R0, t0 = tinf.run_sequence(*args, cfg=cfg, batch=4, device="cpu", mesh=None)
    R1, t1 = tinf.run_sequence(*args, cfg=cfg, batch=4, device="cpu", mesh=cpu_mesh(n))
    np.testing.assert_allclose(R1, R0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t1, t0, rtol=1e-4, atol=1e-4)
    if n == 1:
        assert np.array_equal(R0, R1) and np.array_equal(t0, t1)
    # the reference's draws: the sharded run is the unsharded parity run's
    # (test_torch_slice.py), and the reference's sharded run is its own
    # unsharded one
    if n in (2, 4):
        Rj, tj = jinf.run_sequence(inf["jnet"], jnp.asarray(inf["qmaps"]), inf["imgs"], inf["masks"], inf["Ks"], verts,
                                   feats, cfg=JInferenceConfig(), batch=4, mesh=jmesh.make_mesh(n))
        np.testing.assert_allclose(Rj, inf["Rj"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tj, inf["tj"], rtol=1e-4, atol=1e-4)
        keys = jax.random.split(jax.random.PRNGKey(1), 4)
        _, conf_mask, _, _ = tinf.correspondences(inf["tnet"], torch.from_numpy(inf["imgs"]),
                                                  torch.from_numpy(inf["masks"]), torch.from_numpy(inf["Ks"]),
                                                  _t(feats))
        samples = np.stack([np.asarray(jax.random.categorical(
            jax.random.split(keys[i], 2)[0], jnp.log(jnp.maximum(jnp.asarray(conf_mask[i].numpy(), jnp.float32),
                                                                  1e-12)), shape=(cfg.ransac_iters, 4)))
            for i in range(4)])
        Rs, ts = tinf.run_sequence(*args, cfg=cfg, batch=4, samples=samples, device="cpu", mesh=cpu_mesh(n))
        np.testing.assert_allclose(Rs, inf["Rt"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ts, inf["tt"], rtol=1e-4, atol=1e-4)
        # the slice test's bars against the reference
        np.testing.assert_allclose(Rs, Rj, atol=1e-3)
        np.testing.assert_allclose(ts, tj, atol=1e-3, rtol=1e-3)
