"""The port's mesh scene against the JAX package's, on the CPU: the
icosphere and blob mesh (bit for bit), the triangle rasterizer (flat and
textured), the scene on the reference's pose draws, and the scene cache
(each package reads the other's ``.npz``).

A rasterized pixel may differ only at its cause, checked in f64 on the
reference's own screen triangles: a pixel centre on a triangle's edge (the
inside test ``w >= 0`` within 1e-4 of its sign) flips the silhouette or the
winning triangle.  Everywhere else rgb and depth agree to 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import mesh_scene as jms
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import scene_cache as jcache
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import synthetic as jsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.geometry import cameras as jcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import rasterize as jras
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene as tms
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import scene_cache as tcache
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic as tsyn
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras as tcam
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import rasterize as tras

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def A(x):
    return np.asarray(x)


@pytest.mark.parametrize("subdivisions", [0, 1, 2, 3])
def test_icosphere_and_blob_match_reference_bit_for_bit(subdivisions):
    for got, want in zip(tms.icosphere(subdivisions), jms.icosphere(subdivisions)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(tms.blob_mesh(subdivisions), jms.blob_mesh(subdivisions)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert tms.icosphere(subdivisions)[1].shape[0] == 20 * 4 ** subdivisions


def test_procedural_albedo_matches_reference():
    p = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32) * 0.5
    np.testing.assert_allclose(tms.procedural_albedo(T(p)).numpy(), A(jms.procedural_albedo(jnp.asarray(p))),
                               atol=1e-5)


def _on_edge(verts, faces, cam_j, S, pix):
    """Per flat pixel of ``pix``: does its centre lie within 1e-4 of a screen
    triangle's edge (a barycentric of one triangle near 0, the others not
    below -1e-4), in f64 on the reference's projection?"""
    xy, z = jcam.project_points(cam_j, jnp.asarray(verts))
    v2 = A(jcam.ndc_to_pixel(xy, S)).astype(np.float64)[faces]          # (T, 3, 2)
    p = np.stack([pix % S + 0.5, pix // S + 0.5], -1).astype(np.float64)  # (n, 2)
    a, b, c = v2[:, 0], v2[:, 1], v2[:, 2]
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])

    def edge(p0, p1):
        return ((p1[:, 0] - p0[:, 0])[None] * (p[:, 1, None] - p0[None, :, 1])
                - (p1[:, 1] - p0[:, 1])[None] * (p[:, 0, None] - p0[None, :, 0])) / area[None]

    w = np.stack([edge(b, c), edge(c, a), edge(a, b)], -1)              # (n, T, 3)
    return ((np.abs(w).min(-1) < 1e-4) & (w.min(-1) > -1e-4)).any(-1)


def _compare_renders(got, want, verts, faces, cams_j, S):
    """rgb / sil / depth of a batch of views: a pixel differs (sil, or rgb /
    depth beyond 1e-4) only on a triangle edge; at most 1 % of pixels."""
    rgb_t, sil_t, dep_t = (x.numpy() for x in got)
    rgb_j, sil_j, dep_j = (A(x) for x in want)
    assert sil_j.mean() > 0.05
    for v in range(sil_j.shape[0]):
        both = (sil_t[v] > 0) & (sil_j[v] > 0)
        dd = np.abs(np.where(both, dep_t[v], 0.0) - np.where(both, dep_j[v], 0.0))
        bad = (sil_t[v] != sil_j[v]) | (np.abs(rgb_t[v] - rgb_j[v]).max(-1) > 1e-4) | (dd > 1e-4 * dep_j[v].min())
        assert bad.mean() <= 0.01
        assert np.array_equal(np.isinf(dep_t[v]), sil_t[v] == 0)
        pix = np.flatnonzero(bad.reshape(-1))
        if len(pix):
            assert _on_edge(verts, faces, cams_j[v], S, pix).all(), (v, pix)


@pytest.mark.parametrize("textured", [False, True], ids=["flat", "textured"])
def test_render_mesh_matches_reference(textured):
    """Three views of the blob at 40 px, one camera at a time (the
    reference's call) and the batch at once (the port's scene path), with a
    light off the camera for one of them."""
    S = 40
    verts, faces, colors, normals = jms.blob_mesh(3)
    key = jax.random.PRNGKey(6)
    R, t = jsyn.random_bop_poses(3, key)
    K = np.broadcast_to(np.float32([[2.1 * S, 0, S / 2], [0, 2.1 * S, S / 2], [0, 0, 1]]), (3, 3, 3)).copy()
    cams_j = jcam.camera_from_bop(R, t, jnp.asarray(K), S)
    cams_t = tcam.camera_from_bop(T(R), T(t), T(K), S)
    fn_j = jms.procedural_albedo if textured else None
    fn_t = tms.procedural_albedo if textured else None
    mesh_j = tuple(map(jnp.asarray, (verts, faces, colors, normals)))
    mesh_t = (T(verts), torch.from_numpy(faces), T(colors), T(normals))
    want = [jras.render_mesh(*mesh_j, cams_j[v], S, albedo_fn=fn_j) for v in range(3)]
    want = [np.stack(x) for x in zip(*want)]
    _compare_renders(tras.render_mesh(*mesh_t, cams_t, S, albedo_fn=fn_t, px_chunk=512), want, verts, faces,
                     cams_j, S)
    one = tras.render_mesh(*mesh_t, cams_t[1], S, albedo_fn=fn_t)
    assert one[0].shape == (S, S, 3) and one[1].shape == (S, S)
    light = np.float32([2.0, -1.0, 3.0])
    got = tras.render_mesh(*mesh_t, cams_t[2], S, light_pos=T(light), albedo_fn=fn_t)
    ref = jras.render_mesh(*mesh_j, cams_j[2], S, light_pos=jnp.asarray(light), albedo_fn=fn_j)
    _compare_renders(tuple(x[None] for x in got), [A(x)[None] for x in ref], verts, faces, [cams_j[2]], S)


def _reference_uniforms(key, n):
    """The three uniform draws of the reference's random_bop_poses(n, key)."""
    return np.stack([A(jax.random.uniform(k, (n,))) for k in jax.random.split(key, 3)])


def test_make_mesh_scene_matches_reference(monkeypatch):
    """Four views at 36 px on the reference's pose draws (poses to 2e-6 / 1e-5:
    the uniforms' scaling rounds once in either order), renders as above;
    K, verts, faces and diameter equal; the port renders its views two at a
    time and the result does not depend on it."""
    key = jax.random.PRNGKey(2)
    want = jms.make_mesh_scene(n_views=4, image_size=36, key=key)
    u = _reference_uniforms(key, 4)
    monkeypatch.setattr(tms, "VIEW_BATCH", 2)
    got = tms.make_mesh_scene(n_views=4, image_size=36, uniforms=u, device="cpu")
    np.testing.assert_allclose(got.R_bop.numpy(), A(want.R_bop), atol=2e-6)
    np.testing.assert_allclose(got.t_bop.numpy(), A(want.t_bop), atol=1e-5)
    np.testing.assert_array_equal(got.K.numpy(), A(want.K))
    np.testing.assert_array_equal(got.verts, want.verts)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.diameter == want.diameter
    cams_j = jcam.camera_from_bop(jnp.asarray(want.R_bop), jnp.asarray(want.t_bop), jnp.asarray(want.K), 36)
    _compare_renders((got.images, got.sils, got.depths), (want.images, want.sils, want.depths), want.verts,
                     want.faces, cams_j, 36)
    monkeypatch.setattr(tms, "VIEW_BATCH", 4)
    whole = tms.make_mesh_scene(n_views=4, image_size=36, uniforms=u, device="cpu")
    for a, b in zip(whole[:6], got[:6]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


FIELDS = ("images", "sils", "R_bop", "t_bop", "K")


@pytest.mark.parametrize("kind", ["analytic", "mesh", "mesh_tex"])
def test_scene_cache_reads_across_packages(tmp_path, kind):
    """Each package's cache file (same name, same ``.npz`` layout) reads in
    the other bit for bit; a scene the port generates is its own
    ``make_scene`` / ``make_mesh_scene`` (subdivisions 4) of a generator
    seeded with the seed, and a second call reads it back.  The port's
    default directory is its own, inside the reference's."""
    seed, n, S = 3, 2, 24
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    made = tcache.load_scene_cached(seed, n, S, str(port_dir), kind=kind, device="cpu")
    name = ("scene" if kind == "analytic" else f"scene-{kind}") + f"_{seed}_{n}_{S}.npz"
    assert sorted(p.name for p in port_dir.iterdir()) == [name]
    g = torch.Generator().manual_seed(seed)
    if kind == "analytic":
        direct = tsyn.make_scene(n, S, generator=g, device="cpu")
    else:
        direct = tms.make_mesh_scene(n, S, generator=g, subdivisions=4, textured=kind == "mesh_tex", device="cpu")
    again = tcache.load_scene_cached(seed, n, S, str(port_dir), kind=kind, device="cpu")
    read_by_ref = jcache.load_scene_cached(seed, n, S, str(port_dir), kind=kind)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(made, f).numpy(), getattr(direct, f).numpy())
        np.testing.assert_array_equal(getattr(again, f).numpy(), getattr(made, f).numpy())
        np.testing.assert_array_equal(A(getattr(read_by_ref, f)), getattr(made, f).numpy())
    assert made.diameter == direct.diameter == again.diameter == read_by_ref.diameter
    written_by_ref = jcache.load_scene_cached(seed, n, S, str(ref_dir), kind=kind)
    read_by_port = tcache.load_scene_cached(seed, n, S, str(ref_dir), kind=kind, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(read_by_port, f).numpy(), A(getattr(written_by_ref, f)))
    assert read_by_port.diameter == written_by_ref.diameter
    with pytest.raises(ValueError, match="unknown scene kind"):
        tcache.load_scene_cached(seed, n, S, str(port_dir), kind="cow", device="cpu")
    # without a cache_dir each package reads only its own scenes
    assert os.path.dirname(tcache._DEFAULT_CACHE) == jcache._DEFAULT_CACHE
