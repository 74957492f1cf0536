"""The device the port's entry points run on when the caller names none."""

from __future__ import annotations

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
