"""The rounding points of the plain references.

A configuration states the precision of its products (``compute_dtype``)
and of the activations it stores (``act_dtype``).  The references compute
in float32 and round a value where the configuration says it is held in a
narrower type: ``Precision.round`` rounds its forward value to that type
and, as autograd does through a cast, the cotangent to bfloat16.

``Precision("bfloat16")`` is the stated precision.  ``Precision("fp8")``
is the control: the same computation with every such value rounded to
float8 e4m3 instead (saturated at its largest finite value), the nearest
precision below bfloat16.  Its cotangents stay bfloat16, so the control
differs from the reference only in the forward precision.
"""

from __future__ import annotations

import torch

_TYPES = {"bfloat16": torch.bfloat16, "fp8": torch.float8_e4m3fn, "float32": None}
_FP8_MAX = 448.0


def _round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype is None:
        return x
    if dtype == torch.float8_e4m3fn:
        x = x.clamp(-_FP8_MAX, _FP8_MAX)
    return x.to(dtype).to(torch.float32)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        return _round_to(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.bfloat16), None


class Precision:
    """Rounding to ``name`` ("bfloat16", "fp8" or "float32", which keeps
    every value) for the forward, bfloat16 cotangents for the backward."""

    def __init__(self, name: str):
        if name not in _TYPES:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = _TYPES[name]

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        return _Round.apply(x, self.dtype)

    def __repr__(self):
        return f"Precision({self.name!r})"


def narrower(name: str) -> str:
    """The control's precision for a stated one: fp8 below bfloat16."""
    if name != "bfloat16":
        raise ValueError(f"no control precision below {name!r} here")
    return "fp8"


def no_tf32():
    """Plain float32 products and convolutions (no TF32) for a reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
