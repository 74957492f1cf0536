"""Profiling and observability (counterpart of utils/profiling.py):
torch.profiler traces, the program's spans and per-step timers."""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler``: CPU activity, and the
    card's too when CUDA is available.  Yields the profiler (its
    ``key_averages()`` hold the block's ops and kernels); on exit the
    block's Chrome trace (chrome://tracing, Perfetto) is written into
    ``log_dir`` as ``<host>.<pid>.<ms>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    name = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


# the namespace of the program's spans: the NeRF step, the descriptor step,
# pose estimation, RANSAC-PnP, SurfEmb's pose estimator and the launches of
# the hand-written kernels
SPAN_PREFIXES = ("nerf.", "pose.", "infer.", "pnp.", "surf.", "kernel.")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range of the program for the profiler's trace: a
    ``torch.profiler.record_function`` while the profiler records (its
    host range shares the clock of the card's kernels, copies and fills),
    else one shared no-op context, so an untraced run pays one check."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class StepTimer:
    """Wall-clock per-step timing with warmup-aware summaries.  With a CUDA
    ``device`` each step waits for the card's queued work on entry and on
    exit, so a step's time covers its kernels and not only their launch."""

    def __init__(self, skip_first: int = 2, device=None):
        self.times = []
        self.skip_first = skip_first
        self.device = None if device is None else torch.device(device)
        self._t = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t)

    @property
    def steady(self):
        return self.times[self.skip_first :] if len(self.times) > self.skip_first else self.times

    def steps_per_sec(self) -> float:
        s = self.steady
        return len(s) / max(sum(s), 1e-9)

    def mean_ms(self) -> float:
        s = self.steady
        return 1000.0 * sum(s) / max(len(s), 1)
