"""Profiling and observability (counterpart of utils/profiling.py):
torch.profiler traces, per-step timers and a CSV metrics logger."""

from __future__ import annotations

import contextlib
import csv
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


class MetricsLogger:
    """Append-only CSV logger: a header row ``step, <fields>`` when the file
    is new, then one row a ``log`` call (a missing field left empty)."""

    def __init__(self, path: str, fields):
        self.path = path
        self.fields = list(fields)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(["step"] + self.fields)

    def log(self, step: int, **values):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([step] + [values.get(k, "") for k in self.fields])
