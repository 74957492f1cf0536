"""Checkpoints of NeRF and descriptor training (counterpart of
train/checkpoint.py).

The reference writes orbax directories; the port writes one ``torch.save``
file per checkpoint holding state dicts, tensors and integers only, read
back with ``torch.load(weights_only=True)``.  A save goes to a temporary
file beside its target and is then renamed over it, so a reader finds the
old checkpoint or the new one, never half of one.  The names are the
reference's overwrite-latest ones (``LATEST``, ``LATEST_FINE``, ``STATE``).
``save_state`` keeps what an exact resume of NeRF training needs: both
fields' parameters, the Adam moments and count, and the step;
``save_pose_state`` the same of descriptor training (the field, the CNN,
both groups' moments).  Descriptor training writes its field as
``LATEST`` and its CNN as ``ENCODER`` beside its own ``STATE``.  The port
reads no orbax; a state of the reference enters through
``convert.train_state_from_jax`` / ``convert.pose_state_from_jax``.
"""

from __future__ import annotations

import copy
import os

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train.nerf_trainer import (
    AdamState,
    NerfTrainState,
    trainable,
)
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train.pose_trainer import (
    PoseAdamState,
    PoseTrainState,
    head_params,
)

LATEST, LATEST_FINE, STATE, ENCODER = "nerflatest", "nerflatestFine", "trainstate", "encoderRGBlatest"


def _write(path: str, obj):
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _cpu(tensors):
    return [t.detach().cpu() for t in tensors]


def save(path: str, tree: dict, step: int = 0):
    """Overwrite-save a state dict (name -> tensor) and its step at ``path``."""
    _write(path, {"tree": dict(zip(tree, _cpu(tree.values()))), "step": int(step)})


def load(path: str, device=None):
    """(state dict, step) as ``save`` wrote them, on ``device`` (the card
    unless named)."""
    obj = torch.load(path, map_location=resolve_device(device), weights_only=True)
    return obj["tree"], int(obj["step"])


def exists(path: str) -> bool:
    return os.path.isfile(os.path.abspath(path))


def save_state(path: str, state):
    """Save a whole ``NerfTrainState``: both fields' state
    dicts, the Adam moments and count, and the step."""
    _write(path, {"coarse": state.coarse.state_dict(), "fine": state.fine.state_dict(), "mu": _cpu(state.opt.mu),
                  "nu": _cpu(state.opt.nu), "count": int(state.opt.count), "step": int(state.step)})


def _check_moments(path: str, obj: dict, params: dict):
    for name, ps in params.items():
        if [t.shape for t in obj[name]] != [p.shape for p in ps]:
            raise ValueError(f"{path}: Adam {name} does not match the trained parameters of this config")


def load_state(path: str, cfg: FieldConfig, device=None):
    """The ``NerfTrainState`` that ``save_state`` wrote, its fields of
    config ``cfg``, on ``device`` (the card unless named)."""
    device = resolve_device(device)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    pair = []
    for which in ("coarse", "fine"):
        f = NerfField(cfg)
        f.load_state_dict(obj[which])
        pair.append(f.to(device))
    trained = [p for f in pair for _, p in trainable(f)]
    _check_moments(path, obj, {"mu": trained, "nu": trained})
    opt = AdamState(int(obj["count"]), [t.to(device) for t in obj["mu"]], [t.to(device) for t in obj["nu"]])
    return NerfTrainState(pair[0], pair[1], opt, int(obj["step"]))


def save_latest(directory: str, state):
    """The reference's checkpoint hook: overwrite the latest coarse and fine
    parameters and the whole train state in ``directory``."""
    save(os.path.join(directory, LATEST), state.coarse.state_dict(), state.step)
    save(os.path.join(directory, LATEST_FINE), state.fine.state_dict(), state.step)
    save_state(os.path.join(directory, STATE), state)


def save_pose_state(path: str, state):
    """Save a whole ``PoseTrainState``: the field's and the CNN's state
    dicts, both groups' Adam moments, the count and the step."""
    opt = state.opt
    _write(path, {"field": state.field.state_dict(), "cnn": state.cnn.state_dict(), "count": int(opt.count),
                  "head_mu": _cpu(opt.head_mu), "head_nu": _cpu(opt.head_nu), "cnn_mu": _cpu(opt.cnn_mu),
                  "cnn_nu": _cpu(opt.cnn_nu), "step": int(state.step)})


def load_pose_state(path: str, cfg: FieldConfig, cnn: ResNetUNet | None = None, device=None):
    """The ``PoseTrainState`` that ``save_pose_state`` wrote, its field of
    config ``cfg`` and its CNN of ``cnn``'s architecture (default: a
    full-width ResNetUNet), on ``device`` (the card unless named)."""
    device = resolve_device(device)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    field = NerfField(cfg)
    field.load_state_dict(obj["field"])
    net = copy.deepcopy(cnn) if cnn is not None else ResNetUNet()
    net.load_state_dict(obj["cnn"])
    field, net = field.to(device), net.to(device)
    head, conv = head_params(field), list(net.parameters())
    _check_moments(path, obj, {"head_mu": head, "head_nu": head, "cnn_mu": conv, "cnn_nu": conv})
    moments = {k: [t.to(device) for t in obj[k]] for k in ("head_mu", "head_nu", "cnn_mu", "cnn_nu")}
    return PoseTrainState(field, net, PoseAdamState(int(obj["count"]), **moments), int(obj["step"]))


def save_pose_latest(directory: str, state):
    """Descriptor training's checkpoint hook: overwrite the latest field
    (``LATEST``), CNN (``ENCODER``) and the whole state in ``directory``."""
    save(os.path.join(directory, LATEST), state.field.state_dict(), state.step)
    save(os.path.join(directory, ENCODER), state.cnn.state_dict(), state.step)
    save_pose_state(os.path.join(directory, STATE), state)
