"""Parameters across frameworks, and the planted test field.

``params_from_jax`` maps the reference's flax parameter trees (as numpy
arrays) onto this package's ``NerfField`` and ``ResNetUNet`` state dicts:

* a flax Dense kernel is (in, out); a torch Linear weight is (out, in);
* ``color1``'s kernel rows are ``[h | dir-sin | dir-cos]``, which the
  transpose keeps as the weight's columns (``DirSplitDense`` slices them);
* a flax Conv kernel is HWIO; a torch Conv2d weight is OIHW;
* a flax GroupNorm ``scale`` is the torch GroupNorm ``weight``.

``train_state_from_jax`` carries a NeRF training state (params, Adam
moments, counts) across the same way.

``planted_field_params`` builds a full NerfField tree in the flax layout
with numpy alone, so the reference (through JAX) and the port (without
JAX) can share one fixture that has a surface.
"""

from __future__ import annotations

import numpy as np
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.device import resolve as resolve_device


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(prefix: str, node) -> dict:
    return {f"{prefix}.weight": _t(np.asarray(node["kernel"]).T), f"{prefix}.bias": _t(node["bias"])}


def _conv(prefix: str, node) -> dict:
    out = {f"{prefix}.weight": _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))}
    if "bias" in node:
        out[f"{prefix}.bias"] = _t(node["bias"])
    return out


def _gn(prefix: str, node) -> dict:
    return {f"{prefix}.weight": _t(node["scale"]), f"{prefix}.bias": _t(node["bias"])}


def _field_state(p) -> dict:
    sd = {}
    for name in ("trunk1", "trunk2", "density_layer", "color1", "color2"):
        sd.update(_dense(name, p[name]))
    fl = p["feature_layer"]
    n_layers = sum(k.startswith("SirenLayer_") for k in fl)
    for i in range(n_layers):
        sd.update(_dense(f"feature_layer.layers.{i}", fl[f"SirenLayer_{i}"]["Dense_0"]))
    sd.update(_dense("feature_layer.out", fl["Dense_0"]))
    return sd


def _unet_state(p) -> dict:
    sd = {}
    sd.update(_conv("stem", p["Conv_0"]))
    sd.update(_gn("stem_norm", p["GroupNorm_0"]))
    n_blocks = sum(k.startswith("BasicBlock_") for k in p)
    for b in range(n_blocks):
        blk = p[f"BasicBlock_{b}"]
        sd.update(_conv(f"blocks.{b}.conv1", blk["Conv_0"]))
        sd.update(_gn(f"blocks.{b}.norm1", blk["GroupNorm_0"]))
        sd.update(_conv(f"blocks.{b}.conv2", blk["Conv_1"]))
        sd.update(_gn(f"blocks.{b}.norm2", blk["GroupNorm_1"]))
        if "Conv_2" in blk:
            sd.update(_conv(f"blocks.{b}.down", blk["Conv_2"]))
            sd.update(_gn(f"blocks.{b}.down_norm", blk["GroupNorm_2"]))
    n_convs = sum(k.startswith("Conv_") for k in p)
    n_dec = n_convs - 3  # stem, head conv and output conv are the others
    for i in range(n_dec):
        sd.update(_conv(f"dec_convs.{i}", p[f"Conv_{i + 1}"]))
        sd.update(_gn(f"dec_norms.{i}", p[f"GroupNorm_{i + 1}"]))
    sd.update(_conv("head_conv", p[f"Conv_{n_dec + 1}"]))
    sd.update(_gn("head_norm", p[f"GroupNorm_{n_dec + 1}"]))
    sd.update(_conv("out", p[f"Conv_{n_dec + 2}"]))
    return sd


def params_from_jax(tree) -> dict:
    """torch state dict for a flax NerfField or ResNetUNet parameter tree
    (nested dicts of numpy arrays, with or without the ``params`` level)."""
    p = tree["params"] if "params" in tree else tree
    if "trunk1" in p:
        return _field_state(p)
    if "Conv_0" in p:
        return _unet_state(p)
    raise ValueError(f"unrecognized parameter tree with keys {sorted(p)[:8]}")


def train_state_from_jax(state, cfg: FieldConfig, device=None):
    """The port's per-half ``NerfTrainState`` from the reference's (its
    leaves as numpy), on ``device`` (the card unless named): coarse and
    fine params, the Adam moments of the trained parameters (the frozen
    feature head has none), the optimizer count and the step, so a resumed
    run computes what the reference's would.  ``state.opt_state`` is
    optax's ``multi_transform`` state, read by attribute:
    ``inner_states["train"].inner_state`` = (ScaleByAdamState,
    ScaleByScheduleState)."""
    device = resolve_device(device)
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import (
        NON_FEATURE_MODULES,
        NerfField,
    )
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.train.nerf_trainer import (
        AdamState,
        NerfTrainState,
        trainable,
    )

    adam, sched = state.opt_state.inner_states["train"].inner_state
    count = int(np.asarray(adam.count))
    if int(np.asarray(sched.count)) != count:
        raise ValueError(f"Adam count {count} and schedule count {int(np.asarray(sched.count))} disagree")
    pair, mu, nu = [], [], []
    for i, params in enumerate((state.params_coarse, state.params_fine)):
        f = NerfField(cfg)
        f.load_state_dict(params_from_jax(params))
        pair.append(f.to(device))
        for moments, out in ((adam.mu[i], mu), (adam.nu[i], nu)):
            sd = {}
            for name in NON_FEATURE_MODULES:
                sd.update(_dense(name, moments["params"][name]))
            out.extend(sd[name].to(device) for name, _ in trainable(f))
    return NerfTrainState(pair[0], pair[1], AdamState(count, mu, nu), int(np.asarray(state.step)))


# ------------------------------------------------------------- planted field

# The planted unit reads cos(1.6 x_d) (frequency index 4, omega0 * 2^4):
# S(x) = sum_d cos(1.6 x_d) falls monotonically in every |x_d| < 1.96, so
# its level sets are closed shells with no copies inside the rays' depth
# range.  S = 2.697 on the axes and 2.686 on the diagonals at radius 0.5.
_PLANT_FREQ = 4
_PLANT_A, _PLANT_C = 4.0, 2.6       # trunk1 unit: softplus(A (S - C))
_PLANT_B2 = -0.2                    # trunk2 unit: softplus(h1 + B2)
_PLANT_WD, _PLANT_BD = 10.0, -1.335  # density: softplus(WD h2 + BD)


def _trunc_normal(rng, shape, fan_in):
    """flax lecun_normal: truncated standard normal on [-2, 2], variance 1/fan_in."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return (out * (np.sqrt(1.0 / fan_in) / 0.87962566103423978)).astype(np.float32)


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def planted_field_params(cfg: FieldConfig = FieldConfig(), seed: int = 0) -> dict:
    """A NerfField parameter tree in the flax layout (numpy float32) whose
    density is a closed blob of radius ~0.5 around the origin.

    Every weight is drawn from ``seed`` with the reference's initializer
    distributions; then trunk unit 0 is routed by hand from the cos
    columns at frequency 1.6 into trunk-2 unit 0 and the density head,
    whose other inputs are zeroed.  Color and feature heads stay random.
    Needs ``n_harmonic_functions > 4``."""
    H, nh = cfg.n_harmonic_functions, cfg.n_hidden
    if H <= _PLANT_FREQ or not cfg.siren:
        raise ValueError("planted field needs n_harmonic_functions > 4 and a SIREN feature head")
    rng = np.random.default_rng(seed)
    emb = 6 * H
    z = lambda n: np.zeros((n,), np.float32)  # noqa: E731

    def dense(i, o):
        return {"kernel": _trunc_normal(rng, (i, o), i), "bias": z(o)}

    p = {
        "trunk1": dense(emb, nh),
        "trunk2": dense(nh, nh),
        "density_layer": dense(nh, 1),
        "color1": dense(nh + emb, nh),
        "color2": dense(nh, 3),
    }
    siren = {}
    dims = [3, nh, nh, nh]
    for i in range(3):
        bound = 1.0 / dims[i] if i == 0 else np.sqrt(6.0 / dims[i]) / 30.0
        siren[f"SirenLayer_{i}"] = {"Dense_0": {"kernel": _uniform(rng, (dims[i], nh), bound),
                                                "bias": _uniform(rng, (nh,), bound)}}
    bound = np.sqrt(6.0 / nh) / 30.0
    siren["Dense_0"] = {"kernel": _uniform(rng, (nh, cfg.feature_dim), bound),
                        "bias": _uniform(rng, (cfg.feature_dim,), bound)}
    p["feature_layer"] = siren

    t1 = p["trunk1"]
    t1["kernel"][:, 0] = 0.0
    for d in range(3):
        t1["kernel"][3 * H + d * H + _PLANT_FREQ, 0] = _PLANT_A
    t1["bias"][0] = -_PLANT_A * _PLANT_C
    t2 = p["trunk2"]
    t2["kernel"][:, 0] = 0.0
    t2["kernel"][0, 0] = 1.0
    t2["bias"][0] = _PLANT_B2
    dl = p["density_layer"]
    dl["kernel"][:] = 0.0
    dl["kernel"][0, 0] = _PLANT_WD
    dl["bias"][0] = _PLANT_BD
    return {"params": p}
