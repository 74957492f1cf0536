"""The device the port's entry points run on when the caller names none,
and the f32 matmul precision the port computes with."""

from __future__ import annotations

import contextlib

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None, every entry point's default,
    means the card (``cuda``).  The CPU runs only when the caller asks for
    it: with no CUDA device, None raises instead of falling back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless device='cpu' is passed")
    return torch.device("cuda")


def of_module(module: torch.nn.Module, device=None) -> torch.device:
    """``resolve(device)`` for an entry point that runs ``module`` where its
    parameters are: raises if they are elsewhere (nothing is moved)."""
    dev = resolve(device)
    have = next(module.parameters()).device
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"the module's parameters are on {have}, the run asks for {dev}")
    return have


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls and convolutions in f32, not TF32, inside the block (the
    reference computes them at full f32 precision)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
