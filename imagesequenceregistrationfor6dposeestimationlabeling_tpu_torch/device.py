"""The device the port's entry points run on when the caller names none,
the f32 matmul precision the port computes with, and cuDNN's deterministic
algorithms for steps that must be bit-reproducible."""

from __future__ import annotations

import contextlib

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None, every entry point's default,
    means the card (``cuda``).  The CPU runs only when the caller asks for
    it: with no CUDA device, None (or "cuda") raises instead of falling
    back."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless device='cpu' is passed")
    return torch.device("cuda" if device is None else device)


def sync(dev: torch.device):
    """Wait for the card's queued work (a host timer's stage boundary)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def of_module(module: torch.nn.Module, device=None) -> torch.device:
    """``resolve(device)`` for an entry point that runs ``module`` where its
    parameters are: raises if they are elsewhere (nothing is moved)."""
    dev = resolve(device)
    have = next(module.parameters()).device
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"the module's parameters are on {have}, the run asks for {dev}")
    return have


def _cudnn_flags(**kw):
    """``torch.backends.cudnn.flags`` with every flag not in ``kw`` kept as
    it is (the function's own defaults would reset them)."""
    cudnn = torch.backends.cudnn
    now = dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
               allow_tf32=cudnn.allow_tf32)
    return cudnn.flags(**{**now, **kw})


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls and convolutions in f32, not TF32, inside the block (the
    reference computes them at full f32 precision)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _cudnn_flags(allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def deterministic_cudnn():
    """Inside the block cuDNN runs only algorithms whose sums have a fixed
    order (and picks them without benchmarking), so a convolution's forward
    and backward are bit-reproducible.  The process-wide
    ``torch.use_deterministic_algorithms`` is left alone."""
    return _cudnn_flags(deterministic=True, benchmark=False)
