"""What the port keeps its own copy of, held to the JAX package's original:
the config dataclasses, the on-disk artifact format, marching tetrahedra;
and the device its entry points take when the caller names none."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu import config as jconfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import mcubes as jmcubes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import artifacts as jart
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import config as tconfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import synthetic
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import mcubes as tmcubes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts as tart
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import registration
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint, nerf_trainer

torch.set_num_threads(1)

CONFIGS = ["FieldConfig", "RenderConfig", "NerfTrainConfig", "FeatConfig", "InferenceConfig", "RegistrationConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_reference(name):
    ours, theirs = getattr(tconfig, name), getattr(jconfig, name)
    assert ours is not theirs
    assert ours.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen

    def spec(cls):
        return [(f.name, str(f.type), f.default, f.default_factory) for f in dataclasses.fields(cls)]

    assert spec(ours) == spec(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    changed = tconfig.replace(ours(), **{dataclasses.fields(ours)[0].name: 3})
    assert dataclasses.asdict(changed) == dataclasses.asdict(jconfig.replace(theirs(), **{
        dataclasses.fields(theirs)[0].name: 3}))


def _write_bake(art, exp, rng):
    pose = art.pose_dir(exp, 1)
    arrays = {"vert1_scaled.npy": rng.normal(size=(10, 3)).astype(np.float32),
              "feat1_scaled.npy": rng.normal(size=(10, 12)).astype(np.float32),
              "normals_scaled.npy": rng.normal(size=(10, 3)).astype(np.float32),
              "n_keys.npy": np.asarray([7])}
    for name, arr in arrays.items():
        art.save_array(pose, name, arr)
    return arrays


@pytest.mark.parametrize("writer,reader", [(tart, jart), (jart, tart)], ids=["port-to-jax", "jax-to-port"])
def test_artifacts_read_across_packages(tmp_path, writer, reader):
    exp = str(tmp_path / "0_synth_obj_1")
    arrays = _write_bake(writer, exp, np.random.default_rng(5))
    assert reader.pose_dir(exp, 1) == writer.pose_dir(exp, 1)
    for trim, n in ((True, 7), (False, 10)):
        verts, feats, normals, n_real = reader.load_keys(reader.pose_dir(exp, 1), trim=trim)
        assert n_real == 7
        np.testing.assert_array_equal(verts, arrays["vert1_scaled.npy"][:n])
        np.testing.assert_array_equal(feats, arrays["feat1_scaled.npy"][:n])
        np.testing.assert_array_equal(normals, arrays["normals_scaled.npy"][:n])
    np.testing.assert_array_equal(reader.load_array(reader.pose_dir(exp, 1), "n_keys.npy"), [7])


def _planted_grid(R=24):
    """Two overlapping balls on an R^3 grid: a surface with saddles."""
    t = np.linspace(-1.0, 1.0, R, dtype=np.float32)
    x, y, z = np.meshgrid(t, t, t, indexing="ij")
    d1 = np.sqrt((x - 0.2) ** 2 + y ** 2 + z ** 2)
    d2 = np.sqrt((x + 0.3) ** 2 + (y - 0.1) ** 2 + z ** 2)
    return (1.0 / (1.0 + np.exp(20.0 * (np.minimum(d1 - 0.45, d2 - 0.35))))).astype(np.float32)


def _tri_set(verts, tris):
    return sorted(tuple(sorted(map(tuple, np.round(verts[t], 5)))) for t in tris)


@pytest.mark.parametrize("native", [True, False])
def test_marching_tetrahedra_matches_reference(native):
    grid = _planted_grid()
    tv, tt = tmcubes.marching_tetrahedra(grid, 0.5, native=native)
    jv, jt = jmcubes.marching_tetrahedra(grid, 0.5, native=native)
    assert tv.shape[0] > 100 and tt.shape[0] > 100
    assert tv.shape == jv.shape and tt.shape == jt.shape
    np.testing.assert_array_equal(np.unique(tv, axis=0), np.unique(jv, axis=0))
    assert _tri_set(tv, tt) == _tri_set(jv, jt)
    np.testing.assert_array_equal(tmcubes.index_to_world(tv, 24, exact=True),
                                  jmcubes.index_to_world(jv, 24, exact=True))
    np.testing.assert_array_equal(tmcubes.index_to_world(tv, 24), jmcubes.index_to_world(jv, 24))
    np.testing.assert_allclose(tmcubes.vertex_normals(tv, tt), jmcubes.vertex_normals(jv, jt), atol=1e-6)


# every public entry point that takes a device, called without one
ENTRY_POINTS = {
    "init_state": lambda: nerf_trainer.init_state(tconfig.FieldConfig(), tconfig.NerfTrainConfig()),
    "train_nerf_fused": lambda: nerf_trainer.train_nerf_fused(None, None, None, None, None, tconfig.FieldConfig()),
    "train_nerf": lambda: nerf_trainer.train_nerf(None, None, None, None, None, tconfig.FieldConfig()),
    "register_halves": lambda: registration.register_halves(None, None, None, None, None, None, None, diameter=1.0),
    "verify_consecutive": lambda: registration.verify_consecutive(None, None, None, None, None),
    "density_grid": lambda: renderer.density_grid(lambda p: p[..., :1], grid_res=4),
    "analytic_surface_points": lambda: synthetic.analytic_surface_points(4),
    "random_bop_poses": lambda: synthetic.random_bop_poses(2),
    "make_scene": lambda: synthetic.make_scene(2, 8),
    "checkpoint.load": lambda: checkpoint.load("never-read"),
    "checkpoint.load_state": lambda: checkpoint.load_state("never-read", tconfig.FieldConfig()),
    "train_state_from_jax": lambda: convert.train_state_from_jax(None, tconfig.FieldConfig()),
    "depth_edges": lambda: cameras.depth_edges(2.0, 6.0, 4),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    """Without a device an entry point runs on the card; on a host with no
    GPU it raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_entry_points_default_device_is_none():
    fns = [nerf_trainer.init_state, nerf_trainer.train_nerf_fused, nerf_trainer.train_nerf,
           registration.register_halves, registration.verify_consecutive, renderer.density_grid,
           synthetic.analytic_surface_points, synthetic.random_bop_poses, synthetic.make_scene, checkpoint.load,
           checkpoint.load_state, convert.train_state_from_jax, cameras.depth_edges]
    assert len(fns) == len(ENTRY_POINTS)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default is None, fn.__qualname__
    assert synthetic.make_scene(2, 8, device="cpu").images.device.type == "cpu"
