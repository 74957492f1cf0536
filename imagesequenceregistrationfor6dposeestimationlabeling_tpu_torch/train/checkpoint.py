"""Checkpoints of NeRF training (counterpart of train/checkpoint.py).

The reference writes orbax directories; the port writes one ``torch.save``
file per checkpoint holding state dicts, tensors and integers only, read
back with ``torch.load(weights_only=True)``.  A save goes to a temporary
file beside its target and is then renamed over it, so a reader finds the
old checkpoint or the new one, never half of one.  The names are the
reference's overwrite-latest ones (``LATEST``, ``LATEST_FINE``, ``STATE``).
``save_state`` keeps what an exact resume needs: both fields' parameters,
the Adam moments and count, and the step.  The port reads no orbax; a
state of the reference enters through ``convert.train_state_from_jax``.
"""

from __future__ import annotations

import os

import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train.nerf_trainer import (
    AdamState,
    NerfTrainState,
    trainable,
)

LATEST, LATEST_FINE, STATE = "nerflatest", "nerflatestFine", "trainstate"


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


def load(path: str, device="cpu"):
    """(state dict, step) as ``save`` wrote them."""
    obj = torch.load(path, map_location=device, weights_only=True)
    return obj["tree"], int(obj["step"])


def exists(path: str) -> bool:
    return os.path.isfile(os.path.abspath(path))


def save_state(path: str, state):
    """Save a whole ``NerfTrainState``: both fields' state
    dicts, the Adam moments and count, and the step."""
    _write(path, {"coarse": state.coarse.state_dict(), "fine": state.fine.state_dict(), "mu": _cpu(state.opt.mu),
                  "nu": _cpu(state.opt.nu), "count": int(state.opt.count), "step": int(state.step)})


def load_state(path: str, cfg: FieldConfig, device="cpu"):
    """The ``NerfTrainState`` that ``save_state`` wrote, its fields of
    config ``cfg``, on ``device``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    pair = []
    for which in ("coarse", "fine"):
        f = NerfField(cfg)
        f.load_state_dict(obj[which])
        pair.append(f.to(device))
    shapes = [p.shape for f in pair for _, p in trainable(f)]
    for name in ("mu", "nu"):
        if [t.shape for t in obj[name]] != shapes:
            raise ValueError(f"{path}: Adam {name} does not match the trained parameters of this field config")
    opt = AdamState(int(obj["count"]), [t.to(device) for t in obj["mu"]], [t.to(device) for t in obj["nu"]])
    return NerfTrainState(pair[0], pair[1], opt, int(obj["step"]))


def save_latest(directory: str, state):
    """The reference's checkpoint hook: overwrite the latest coarse and fine
    parameters and the whole train state in ``directory``."""
    save(os.path.join(directory, LATEST), state.coarse.state_dict(), state.step)
    save(os.path.join(directory, LATEST_FINE), state.fine.state_dict(), state.step)
    save_state(os.path.join(directory, STATE), state)
