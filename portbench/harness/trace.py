"""The device trace of a traced stretch and what the benchmark reads from
it: the device's busy seconds, device time by kernel, and the idle gaps
by what the host was doing.

``torch.profiler`` records the host's operators, the benchmark's own
spans (``record_function``, named ``<layer>.<call>``) and the card's
kernels, copies and fills on one clock.  The Chrome trace it exports is
read back once the stretch has ended; the file goes to the temporary
directory and is deleted.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch

WINDOW_SPAN = "bench.window"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def span(on: bool, name: str):
    """A benchmark span around a call into a layer: a profiler range when
    tracing, nothing otherwise."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def base_name(name: str) -> str:
    """A kernel's function name without namespace, template or arguments:
    ``void ns::k<1>(Args)`` -> ``k``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


class Profile:
    """Profile a block; ``read()`` afterwards reduces its trace."""

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top_level(spans):
    """The spans not inside an earlier one (host operators nest)."""
    out = []
    for s in sorted(spans, key=lambda s: (s[0], -s[1])):
        if not out or s[0] >= out[-1][1]:
            out.append(s)
    return out


def _containing(sorted_spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return sorted_spans[i] if i >= 0 and sorted_spans[i][1] > t else None


def reduce(events: list, prefixes=()) -> dict:
    """busy_s, window_s, device seconds by kernel name, and idle seconds by
    (benchmark span, host operator) within the benchmark's window span.
    ``prefixes``: the names of the benchmark's own spans start so."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev, by_kernel = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        k = base_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        by_kernel[k] = by_kernel.get(k, 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    ops = _top_level([(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                      if e.get("ph") == "X" and e.get("cat") == "cpu_op"])
    op_starts = [s[0] for s in ops]
    spans = sorted([(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] != WINDOW_SPAN
                    and e["name"].startswith(tuple(prefixes))])
    idle = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[0] <= mid < s[1]]
        where = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "outside spans"
        op = _containing(ops, op_starts, mid)
        label = f"{where} / {op[2] if op else 'python'}"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6, "kernels": by_kernel, "idle": idle}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
