"""Random weights made on the device from the seed, in a few large calls,
as state dicts that the program's modules load and the references read.

Dense kernels: normal with variance 1 / fan-in; biases zero but the
density bias, which is the configuration's; the SIREN head: SIREN's
uniform scheme (first layer +-1 / fan-in, the others +-sqrt(6 / fan-in) /
30, biases alike).  Convolutions: normal with variance 1 / fan-in, no
bias but the output layer's (zero); GroupNorm scales one, shifts zero.
"""

from __future__ import annotations

import math

import torch


def _fill_normal(gen, shapes: dict, device) -> dict:
    """One normal draw split into tensors of ``shapes`` {name: (shape,
    fan_in)}, each scaled to variance 1 / fan_in."""
    sizes = [math.prod(s) for s, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, (shape, fan_in)), chunk in zip(shapes.items(), torch.split(flat, sizes)):
        out[name] = (chunk / math.sqrt(fan_in)).reshape(shape)
    return out


def field_params(gen: torch.Generator, fc: dict, density_gain: float = 1.0) -> dict:
    """One field's state dict for the configuration's ``field`` group; the
    density head's kernel drawn ``density_gain`` times the spread."""
    dev = gen.device
    nh, emb, fd = fc["n_hidden"], 6 * fc["n_harmonic_functions"], fc["feature_dim"]
    kernels = {"trunk1.weight": ((nh, emb), emb), "trunk2.weight": ((nh, nh), nh),
               "density_layer.weight": ((1, nh), nh), "color1.weight": ((nh, nh + emb), nh + emb),
               "color2.weight": ((3, nh), nh)}
    if not fc["siren"]:
        kernels.update({"feat1.weight": ((nh, emb), emb), "feat2.weight": ((fd, nh), nh)})
    p = _fill_normal(gen, kernels, dev)
    p["density_layer.weight"] = p["density_layer.weight"] * density_gain
    for name, n in (("trunk1", nh), ("trunk2", nh), ("color1", nh), ("color2", 3)) + (
            () if fc["siren"] else (("feat1", nh), ("feat2", fd))):
        p[name + ".bias"] = torch.zeros(n, device=dev)
    p["density_layer.bias"] = torch.full((1,), float(fc["density_bias"]), device=dev)
    if fc["siren"]:
        dims = [(nh, 3), (nh, nh), (nh, nh), (fd, nh)]
        names = ["feature_layer.layers.0", "feature_layer.layers.1", "feature_layer.layers.2", "feature_layer.out"]
        sizes = [o * i + o for o, i in dims]
        flat = torch.rand(sum(sizes), generator=gen, device=dev) * 2.0 - 1.0
        for k, ((o, i), name, chunk) in enumerate(zip(dims, names, torch.split(flat, sizes))):
            bound = 1.0 / i if k == 0 else math.sqrt(6.0 / i) / 30.0
            p[name + ".weight"] = chunk[: o * i].reshape(o, i) * bound
            p[name + ".bias"] = chunk[o * i:] * bound
    return p


def unet_shapes(uc: dict) -> dict:
    """{name: shape} of the ResNet-UNet's state dict for the
    configuration's ``unet`` group, in the module's order."""
    shapes = {"stem.weight": (64, 3, 7, 7), "stem_norm.weight": (64,), "stem_norm.bias": (64,)}
    cin, b = 64, 0
    for i, (n, w) in enumerate(zip(uc["stage_sizes"], uc["widths"])):
        for j in range(n):
            pre = f"blocks.{b}."
            shapes.update({pre + "conv1.weight": (w, cin, 3, 3), pre + "norm1.weight": (w,), pre + "norm1.bias": (w,),
                           pre + "conv2.weight": (w, w, 3, 3), pre + "norm2.weight": (w,), pre + "norm2.bias": (w,)})
            if cin != w or (j == 0 and i > 0):
                shapes.update({pre + "down.weight": (w, cin, 1, 1), pre + "down_norm.weight": (w,),
                               pre + "down_norm.bias": (w,)})
            cin, b = w, b + 1
    dw = uc["decoder_width"]
    skips = [64] + list(uc["widths"][:-1])
    dec_in = [uc["widths"][-1]] + [2 * dw] * (len(skips) - 1)
    for k, (a, s) in enumerate(zip(dec_in, reversed(skips))):
        shapes[f"dec_convs.{k}.weight"] = (2 * dw, a + s, 3, 3)
    for k in range(len(skips)):
        shapes[f"dec_norms.{k}.weight"] = (2 * dw,)
        shapes[f"dec_norms.{k}.bias"] = (2 * dw,)
    shapes.update({"head_conv.weight": (dw, 2 * dw, 3, 3), "head_norm.weight": (dw,), "head_norm.bias": (dw,),
                   "out.weight": (uc["n_class"], dw, 1, 1), "out.bias": (uc["n_class"],)})
    return shapes


def unet_params(gen: torch.Generator, uc: dict) -> dict:
    dev = gen.device
    shapes = unet_shapes(uc)
    convs = {k: (s, math.prod(s[1:])) for k, s in shapes.items() if len(s) == 4}
    p = _fill_normal(gen, convs, dev)
    for k, s in shapes.items():
        if len(s) == 1:
            p[k] = torch.ones(s, device=dev) if "norm" in k and k.endswith(".weight") else torch.zeros(s, device=dev)
    return {k: p[k] for k in shapes}
