"""Marks on the host clock through a run's set-up, so that a run can say
where its ``setup_s`` went (printed on standard error, not in the
result)."""

from __future__ import annotations

import time

MARKS: list = []


def mark(name: str) -> None:
    """The set-up phase ``name`` ends now."""
    MARKS.append((name, time.perf_counter()))


def phases(t0: float) -> list:
    """[(phase, seconds)] from ``t0`` through the marks in order."""
    out, last = [], t0
    for name, t in MARKS:
        out.append((name, t - last))
        last = t
    return out
