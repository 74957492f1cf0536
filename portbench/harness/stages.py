"""The program's stages in a traced stretch, read from the same Chrome trace
as ``trace.reduce``: for each span whose name starts with one of the
given prefixes (the program's namespace is ``utils/profiling.py``
``SPAN_PREFIXES``), the device time it launched, the idle time it left and
its launches.

- ``busy_s``: the device time of the kernels, copies and fills whose
  launch (the ``cuda_runtime`` / ``cuda_driver`` event of the same
  ``correlation``) lies inside the span, clipped to the window span;
- ``idle_s``: the idle gaps of the window (as ``trace.reduce`` finds
  them) whose midpoint lies inside the span, so a span holds its
  children's gaps;
- ``launches``: the launch events inside the span, a launch being a
  runtime or driver call that put a kernel, copy or fill on the card.

Times are by span name: the instances of a name count once where they
overlap.  ``ms_a_step`` is what a per-stage metric reads.
"""

from __future__ import annotations

import bisect

from portbench.harness import trace as trace_lib

_LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


class _Cover:
    """The union of a name's host ranges, for 'is t inside' queries."""

    def __init__(self, ranges):
        self.ranges = trace_lib._union(ranges)
        self.starts = [a for a, _ in self.ranges]

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ranges[i][1]


def reduce(events: list, prefixes) -> dict:
    """{"stages": {span name: {"count", "busy_s", "idle_s", "launches"}},
    "launches": the window's launch events} for the spans whose names
    start with ``prefixes``."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == trace_lib.WINDOW_SPAN]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    xs = [e for e in events if e.get("ph") == "X"]
    launched_at = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                   if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev, launches = [], set()
    for e in xs:
        if e.get("cat") not in trace_lib._DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr in launched_at:
            launches.add(corr)
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b > a:
            dev.append((a, b, launched_at.get(corr)))
    busy = trace_lib._union([(a, b) for a, b, _ in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    ranges = {}
    for e in xs:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name != trace_lib.WINDOW_SPAN and name.startswith(tuple(prefixes)):
            ranges.setdefault(name, []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    calls = [launched_at[c] for c in launches if w0 <= launched_at[c] < w1]
    stages = {}
    for name, rs in sorted(ranges.items()):
        inside = _Cover(rs)
        stages[name] = {
            "count": len(rs),
            "busy_s": sum(b - a for a, b, t in dev if t is not None and t in inside) * 1e-6,
            "idle_s": sum(b - a for a, b in gaps if 0.5 * (a + b) in inside) * 1e-6,
            "launches": sum(t in inside for t in calls),
        }
    return {"stages": stages, "launches": len(calls)}


def ms_a_step(ctx: dict, span: str):
    """A stage's device timeline a step, in ms: 1e3 x (busy_s + idle_s) /
    steps; None when the trace holds no such span."""
    rec = ctx.get("stages", {}).get(span)
    if rec is None or not ctx["steps"]:
        return None
    return 1e3 * (rec["busy_s"] + rec["idle_s"]) / ctx["steps"]


def table(stages: dict, steps: int) -> list:
    """The stage table's lines: per span, its instances, ms busy, ms idle
    and launches, each a step."""
    out = [f"{'stage':<24} {'count':>6} {'busy ms':>9} {'idle ms':>9} {'launches':>9}  (a step)"]
    for name, r in stages.items():
        out.append(f"{name:<24} {r['count'] / steps:>6.1f} {1e3 * r['busy_s'] / steps:>9.3f} "
                   f"{1e3 * r['idle_s'] / steps:>9.3f} {r['launches'] / steps:>9.1f}")
    return out
