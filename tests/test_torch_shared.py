"""What the port keeps its own copy of, held to the JAX package's original:
the config dataclasses, the on-disk artifact format, marching tetrahedra,
the BOP loader and the CAD wrapper; and the device its entry points take
when the caller names none."""

import dataclasses
import functools
import inspect
import json
import os

import numpy as np
import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu import config as jconfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.ops import mcubes as jmcubes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.pipeline import artifacts as jart
from imagesequenceregistrationfor6dposeestimationlabeling_tpu.train import pose_trainer as jpt
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import config as tconfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import convert
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene, scene_cache, synthetic
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry import cameras
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import mcubes as tmcubes
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import artifacts as tart
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import generate_cors, inference, registration
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.render import renderer
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train import checkpoint, nerf_trainer, pose_trainer

torch.set_num_threads(1)

CONFIGS = ["FieldConfig", "RenderConfig", "NerfTrainConfig", "PoseTrainConfig", "CorsConfig", "FeatConfig",
           "InferenceConfig", "RegistrationConfig"]


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


def _write_cors(art, exp, rng, n_views=3, S=16):
    """A correspondence directory: the surface arrays and ragged per-view rays."""
    cors = art.cors_dir(exp, 1)
    arrays = {name: rng.normal(size=(n, 3)).astype(np.float32)
              for name, n in (("a1.npy", 40), ("subvert1.npy", 12), ("subnormal1.npy", 12))}
    for name, arr in arrays.items():
        art.save_array(cors, name, arr)
    views = []
    for i in range(n_views):
        n, nb = 5 + 3 * i, 2 + i
        v = (rng.uniform(-1, 1, (n, 2)), rng.normal(size=(n, 3)), rng.uniform(-1, 1, (nb, 2)), rng.normal(size=(nb, 3)))
        v = tuple(x.astype(np.float32) for x in v)
        art.save_view_rays(cors, S, i, *v)
        views.append(v)
    return cors, arrays, views


@pytest.mark.parametrize("writer,reader", [(tart, jart), (jart, tart)], ids=["port-to-jax", "jax-to-port"])
def test_cors_artifacts_read_across_packages(tmp_path, writer, reader):
    """The surface arrays and per-view rays one package writes, the other
    reads back bit for bit, and both pose trainers' ray banks read them
    alike (tests/test_torch_cors.py hands the port's a1 to the
    reference's build_negatives)."""
    exp = str(tmp_path / "0_synth_obj_1")
    cors, arrays, views = _write_cors(writer, exp, np.random.default_rng(6))
    assert reader.cors_dir(exp, 1) == cors and reader.nerf_dir(exp, 1) == writer.nerf_dir(exp, 1)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(reader.load_array(cors, name), arr)
    for i, want in enumerate(views):
        assert reader.has_view_rays(cors, 16, i)
        for got, w in zip(reader.load_view_rays(cors, 16, i), want):
            np.testing.assert_array_equal(got, w)
    assert not reader.has_view_rays(cors, 16, len(views))
    ref = jpt.load_ray_bank(cors, 16, len(views), bucket=8)
    port = pose_trainer.load_ray_bank(cors, 16, len(views), bucket=8, device="cpu")
    assert ref.pos_vec.shape == (3, 16, 3) and ref.back_vec.shape == (3, 8, 3)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)))
    fixed = pose_trainer.load_ray_bank(cors, 16, len(views), max_rays=6, device="cpu")
    assert fixed.pos_vec.shape == (3, 6, 3) and bool(fixed.valid[2].all())


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
    "checkpoint.load_pose_state": lambda: checkpoint.load_pose_state("never-read", tconfig.FieldConfig()),
    "AnalyticField": lambda: synthetic.AnalyticField(),
    "train_state_from_jax": lambda: convert.train_state_from_jax(None, tconfig.FieldConfig()),
    "depth_edges": lambda: cameras.depth_edges(2.0, 6.0, 4),
    "generate_cors": lambda: generate_cors.generate_cors(None, None, None, None, None, "never-written", 1),
    "build_negatives": lambda: pose_trainer.build_negatives(None, None, None, None, None, None,
                                                            tconfig.PoseTrainConfig()),
    "load_ray_bank": lambda: pose_trainer.load_ray_bank("never-read", 224, 1),
    "init_pose_state": lambda: pose_trainer.init_pose_state(None, tconfig.PoseTrainConfig()),
    "train_pose": lambda: pose_trainer.train_pose(None, None, None, None, None),
    "pose_state_from_jax": lambda: convert.pose_state_from_jax(None, tconfig.FieldConfig(), None),
    "make_mesh_scene": lambda: mesh_scene.make_mesh_scene(2, 8),
    "load_scene_cached": lambda: scene_cache.load_scene_cached(0, 2, 8, cache_dir="never-written"),
    "run_sequence_surfemb": lambda: inference.run_sequence_surfemb(None, None, None, None, None, None, 1.0),
    "surfemb_crop": lambda: inference.surfemb_crop(None, None, None),
    "estimate_pose_full_frame": lambda: inference.estimate_pose_full_frame(None, None, None, None, None, None),
    "surfemb_crop_M": lambda: cameras.surfemb_crop_M(0, 0, 4, 4),
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
           checkpoint.load_state, checkpoint.load_pose_state, synthetic.AnalyticField, convert.train_state_from_jax, cameras.depth_edges, generate_cors.generate_cors,
           pose_trainer.build_negatives, pose_trainer.load_ray_bank, pose_trainer.init_pose_state,
           pose_trainer.train_pose, convert.pose_state_from_jax, mesh_scene.make_mesh_scene,
           scene_cache.load_scene_cached, inference.run_sequence_surfemb, inference.surfemb_crop,
           inference.estimate_pose_full_frame, cameras.surfemb_crop_M]
    assert len(fns) == len(ENTRY_POINTS)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default is None, fn.__qualname__
    assert synthetic.make_scene(2, 8, device="cpu").images.device.type == "cpu"


# ------------------------------------------------- the BOP loader's copy


@pytest.fixture(scope="module")
def bop_tree(tmp_path_factory):
    """A BOP-style dataset ``ruapc`` of object 1: three 96 x 96 frames of a
    lit rectangle (noise outside the mask), their masks and visibility
    masks, GT and cameras, a binary little-endian PLY with extra vertex
    properties and faces, and an ascii one for object 2."""
    from PIL import Image

    root = tmp_path_factory.mktemp("bop")
    ds = root / "ruapc"
    obj = ds / "train" / "000001"
    for sub in ("rgb", "mask", "mask_visib"):
        (obj / sub).mkdir(parents=True)
    rng = np.random.default_rng(3)
    cams, gts = {}, {}
    for i in range(3):
        rgb = rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)
        mask = np.zeros((96, 96), np.uint8)
        mask[20 + i: 61 + i, 15 + 2 * i: 70] = 255
        Image.fromarray(rgb).save(obj / "rgb" / f"{i:06d}.png")
        for sub in ("mask", "mask_visib"):
            Image.fromarray(mask).save(obj / sub / f"{i:06d}_000000.png")
        cams[str(i)] = {"cam_K": [250.0, 0.0, 47.0, 0.0, 251.0, 49.0, 0.0, 0.0, 1.0]}
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        gts[str(i)] = [{"cam_R_m2c": list(R.reshape(-1)), "cam_t_m2c": [3.0 * i, -2.0, 420.0], "obj_id": 1}]
    (obj / "scene_camera.json").write_text(json.dumps(cams))
    (obj / "scene_gt.json").write_text(json.dumps(gts))
    models = ds / "models"
    models.mkdir()
    (models / "models_info.json").write_text(json.dumps({"1": {"diameter": 61.25}, "2": {"diameter": 10.0}}))
    verts = rng.normal(size=(700, 3)).astype(np.float32) * 20.0
    rec = np.zeros(700, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                         ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = verts.T
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 700\n"
            + "".join(f"property float {n}\n" for n in ("x", "y", "z", "nx", "ny", "nz"))
            + "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            + "element face 1\nproperty list uchar int vertex_indices\nend_header\n")
    face = bytes([3]) + np.arange(3, dtype="<i4").tobytes()
    (models / "obj_000001.ply").write_bytes(head.encode() + rec.tobytes() + face)
    (models / "obj_000002.ply").write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                                           "property float y\nproperty float z\nend_header\n0 0 0\n1 0.5 0\n0 1 2\n")
    return str(root), verts


def test_bop_loader_copy_matches_reference(bop_tree):
    """The port's own copy of the BOP loader and the CAD wrapper give the
    reference's arrays, bit for bit, on one fabricated dataset."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.data import bop as jbop
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu.utils import objmesh as jobj
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import bop as tbop
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import objmesh as tobj

    root, verts = bop_tree
    ds = os.path.join(root, "ruapc")
    for dataset in ("ruapc", "tless"):
        for uh in (0, 1):
            np.testing.assert_array_equal(tbop.half_sequence_ids(dataset, uh), jbop.half_sequence_ids(dataset, uh))
    for a, b in zip(tbop.load_bop_samples(ds, 1, [0, 2, 1], max_b=40),
                    jbop.load_bop_samples(ds, 1, [0, 2, 1], max_b=40)):
        np.testing.assert_array_equal(a, b)
    ft, fj = tbop.load_bop_full_frames(ds, 1, [1, 2]), jbop.load_bop_full_frames(ds, 1, [1, 2])
    for a, b in zip(ft, fj):
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            np.testing.assert_array_equal(x, y)
    assert tbop.load_diameter(ds, 1) == jbop.load_diameter(ds, 1) == 61.25
    for objid, cap in ((1, 0), (1, 300), (2, 0)):
        ply = os.path.join(ds, "models", f"obj_{objid:06d}.ply")
        np.testing.assert_array_equal(tbop.read_ply_vertices(ply, cap), jbop.read_ply_vertices(ply, cap))
    np.testing.assert_array_equal(tbop.load_cad_points(ds, 1), verts)
    for objid in (1, 2):
        a, b = tobj.load_obj(os.path.join(ds, "models"), objid), jobj.load_obj(os.path.join(ds, "models"), objid)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.normalize(verts[:5]), b.normalize(verts[:5]))


def test_cli_trains_a_nerf_on_a_bop_tree(bop_tree, monkeypatch):
    """The port's ``train-nerf --steps 2`` reads the BOP tree through its
    ``load_data`` (the same arrays as the reference CLI's loader) and writes
    its checkpoints."""
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu import cli as jcli
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch import cli as tcli

    root, _ = bop_tree
    argv = ["--objid", "1", "--dataset", "ruapc", "--UH", "1", "--bop-root", root, "--root", os.path.join(root, "exp"),
            "--fsamps", "3", "--image-size", "24", "--field-preset", "small", "--viz-every", "0", "--log-every", "0"]
    args_j = jcli.build_parser().parse_args(["train-nerf", *argv])
    args_t = tcli.build_parser().parse_args(["train-nerf", *argv, "--device", "cpu"])
    for a, b in zip(tcli.load_data(args_t, 24), jcli.load_data(args_j, 24)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(nerf_trainer, "extract_point_cloud", functools.partial(nerf_trainer.extract_point_cloud,
                                                                               grid_res=16))
    tcli.main(["train-nerf", *argv, "--device", "cpu", "--steps", "2"])
    state = checkpoint.load_state(os.path.join(tart.nerf_dir(tcli.exp_dir(args_t), 1), checkpoint.STATE),
                                  tcli.field_config(args_t), device="cpu")
    assert state.step == 2 and state.opt.count == 2
