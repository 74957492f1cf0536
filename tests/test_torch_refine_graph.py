"""The refiner's BFGS without host reads (``pipeline/pose_refine.py``): the
line search's alpha picked by a gather on the device, the objective a
function of its inputs, and the eager path on the CPU counted as such.
The CUDA graph itself is held to the eager body in ``test_torch_gpu.py``.
"""

import functools

import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.data import mesh_scene
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.geometry.rotations import rotvec_to_matrix
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.rasterize import render_object_coords
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.pipeline import pose_refine

TRIALS = 12
S = 32


@pytest.mark.parametrize("first", list(range(TRIALS)) + [None], ids=[f"first{k}" for k in range(TRIALS)] + ["none"])
def test_alpha_pick_is_the_indexed_pick(first):
    """Every pass pattern of the 12 trials whose first pass is ``first``
    (None: no trial passes): the gathered alpha equals the indexed one
    bit for bit, and is 0 where none passes."""
    alphas = 0.5 ** torch.arange(TRIALS, dtype=torch.float32)
    if first is None:
        patterns = [torch.zeros(TRIALS, dtype=torch.bool)]
    else:
        rest = TRIALS - first - 1
        patterns = []
        for bits in range(2 ** rest):
            ok = torch.zeros(TRIALS, dtype=torch.bool)
            ok[first] = True
            ok[first + 1:] = torch.tensor([(bits >> i) & 1 for i in range(rest)], dtype=torch.bool)
            patterns.append(ok)
    for ok in patterns:
        got = pose_refine.first_passing(ok, alphas)
        want = torch.where(ok.any(), alphas[torch.argmax(ok.to(torch.int8))], torch.zeros(()))
        assert got.shape == () and got.dtype == alphas.dtype
        assert torch.equal(got, want)
        assert float(got) == (0.0 if first is None else 0.5 ** first)


def _scene():
    """The blob's vertices with sharp keys, the ideal query map of an S px
    view of them, a start near the planted pose and a denominator subset."""
    verts = torch.as_tensor(mesh_scene.blob_mesh(3)[0])
    feats = 3.0 * torch.sin(verts @ torch.tensor([[4.0, -3.0, 2.5, 1.0] * 3] * 3) + torch.arange(12.0))
    R = rotvec_to_matrix(torch.tensor([0.3, -0.2, 0.4]))
    t = torch.tensor([0.05, -0.03, 4.0])
    K = torch.tensor([[2.1 * S, 0.0, S / 2 - 0.5], [0.0, 2.1 * S, S / 2 - 0.5], [0.0, 0.0, 1.0]])
    coords, mask = render_object_coords(verts, R, t, K, S)
    query = 3.0 * torch.sin(coords @ torch.tensor([[4.0, -3.0, 2.5, 1.0] * 3] * 3) + torch.arange(12.0))
    query = query * mask[..., None]
    R0 = rotvec_to_matrix(torch.tensor([0.03, -0.02, 0.02])) @ R
    t0 = t + torch.tensor([0.02, -0.02, 0.08])
    sel = torch.randperm(verts.shape[0], generator=torch.Generator().manual_seed(1))
    return R0, t0, query, K, verts, feats, sel


@pytest.mark.parametrize("translation_only", [False, True], ids=["bfgs", "bfgs-t"])
def test_cpu_refine_is_the_eager_body_and_counted_eager(monkeypatch, translation_only):
    """A CPU ``refine_pose`` is ``_bfgs`` over the module-level objective of
    ``refine_inputs``, bit for bit; it counts one eager call, captures and
    replays nothing, and reads nothing back in its steps."""
    monkeypatch.setattr(pose_refine, "REFINE_GRAPH_COUNT", dict.fromkeys(pose_refine.REFINE_GRAPH_COUNT, 0))
    monkeypatch.setattr(pose_refine, "REFINE_COUNT", dict.fromkeys(pose_refine.REFINE_COUNT, 0))
    R0, t0, query, K, verts, feats, sel = _scene()
    steps = 4
    R, t, f = pose_refine.refine_pose(R0, t0, query, K, verts, feats, n_steps=steps, sel=sel,
                                      translation_only=translation_only, n_denom=200)
    assert pose_refine.REFINE_GRAPH_COUNT == {"captures": 0, "replays": 0, "eager": 1}
    assert pose_refine.REFINE_COUNT == {"bfgs_steps": steps, "value_and_grad": steps + 1, "trial_batches": steps,
                                        "host_reads": 0}
    inputs = pose_refine.refine_inputs(R0, t0, query, K, verts, feats, n_denom=200, sel=sel)
    obj = functools.partial(pose_refine.objective, translation_only=translation_only)
    x, fx = pose_refine._bfgs(lambda p: obj(p, *inputs), torch.zeros(6), steps, 12, 0.3)
    R_e, t_e = pose_refine.pose(x, R0, t0, inputs[8], translation_only)
    assert torch.equal(R, R_e) and torch.equal(t, t_e) and torch.equal(f, fx)
    assert float((t - t0).abs().max()) > 0
    if translation_only:
        assert torch.equal(R, R0)


def test_cpu_descent_is_counted_eager(monkeypatch):
    """Gradient descent (``lr > 0``) runs eagerly everywhere: one eager
    call, a value and gradient a step."""
    monkeypatch.setattr(pose_refine, "REFINE_GRAPH_COUNT", dict.fromkeys(pose_refine.REFINE_GRAPH_COUNT, 0))
    monkeypatch.setattr(pose_refine, "REFINE_COUNT", dict.fromkeys(pose_refine.REFINE_COUNT, 0))
    R0, t0, query, K, verts, feats, sel = _scene()
    pose_refine.refine_pose(R0, t0, query, K, verts, feats, n_steps=3, lr=1e-3, sel=sel, n_denom=200)
    assert pose_refine.REFINE_GRAPH_COUNT == {"captures": 0, "replays": 0, "eager": 1}
    assert pose_refine.REFINE_COUNT == {"bfgs_steps": 0, "value_and_grad": 3, "trial_batches": 0, "host_reads": 0}
