"""The numbers a training cell's check compares, and the check lines.

Norms are taken leaf by leaf: the gap between the program's norm of a
leaf and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger (some grads are all but zero); the worst
leaf is the number.
"""

from __future__ import annotations

import math

import torch


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def worst_leaf_gap(got: dict, want: dict, keys=None) -> tuple:
    """(worst relative gap of leaf norms, its leaf) over ``keys`` (all of
    ``want``'s by default)."""
    g, w = norms(got), norms(want)
    keys = list(w) if keys is None else list(keys)
    med = sorted(w.values())[len(w) // 2]
    worst, at = 0.0, None
    for k in keys:
        gap = abs(g[k] - w[k]) / max(w[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, at = gap, k
    return worst, at


def moved_leaves(ref_grads: dict, frac: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding: its
    norm at least ``frac`` of the median leaf's.  The others move under
    Adam by round-off alone and are left out of the change."""
    n = norms(ref_grads)
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= frac * med]


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst relative gap of two tensors of scalars (e.g. per-step losses)."""
    g, w = got.double().flatten(), want.double().flatten()
    return float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())


def depth_gap(got, want) -> float:
    """The widest mean absolute gap, over steps and halves, between two
    sides' fine depths (scene units); inf where a side has none of the
    other's shape."""
    worst = 0.0
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            if g is None or g.shape != w.shape:
                return math.inf
            worst = max(worst, float((g.double() - w.double()).abs().mean()))
    return worst


def training_checks(prog: dict, ref: dict, limits: dict) -> list:
    """[(name, value, limit)] of a training cell: each checked step's loss,
    the first gradient by the worst leaf, and the parameters' change over
    the checked steps by the worst moved leaf."""
    moved = moved_leaves(ref["grads"])
    change_p = {k: prog["params"][k] - ref["init"][k] for k in moved}
    change_r = {k: ref["params"][k] - ref["init"][k] for k in moved}
    grad_gap, _ = worst_leaf_gap(prog["grads"], ref["grads"])
    change_gap, _ = worst_leaf_gap(change_p, change_r)
    return [("loss", rel_gap(prog["losses"], ref["losses"]), limits["loss"]),
            ("grad", grad_gap, limits["grad"]),
            ("change", change_gap, limits["change"])]


def training_detail(prog: dict, ref: dict, n: int = 6) -> dict:
    """What lies behind a training cell's numbers: each step's loss gap per
    half, and the leaves with the widest grad and change gaps, with their
    reference norms and the median leaf's."""
    def leaves(got, want, keys):
        g, w = norms(got), norms(want)
        med = sorted(w.values())[len(w) // 2]
        rows = sorted(((abs(g[k] - w[k]) / max(w[k], med, 1e-30), str(k), w[k]) for k in keys), reverse=True)
        return {"median_norm": med, "worst": rows[:n], "median_gap": rows[len(rows) // 2][0]}

    moved = moved_leaves(ref["grads"])
    steps = ((prog["losses"].double() - ref["losses"].double()).abs() / ref["losses"].double().abs()).tolist()
    change_p = {k: prog["params"][k] - ref["init"][k] for k in moved}
    change_r = {k: ref["params"][k] - ref["init"][k] for k in moved}
    return {"loss_steps": steps, "grad": leaves(prog["grads"], ref["grads"], list(ref["grads"])),
            "change": leaves(change_p, change_r, moved), "left_out": len(ref["grads"]) - len(moved)}


def training_calibration(compare_to, drv, mode: str, limits: dict, detail: bool) -> dict:
    """A training cell's readings for the calibration: the program's (or,
    for "control", the reference computed a precision lower put in its
    place) against the reference; each number by name."""
    if mode == "control":
        drv.release()
        got = drv.reference("fp8")
    else:
        got = drv.readings()
        drv.release()
    ref = drv.reference("bfloat16", got)
    out = {n: v for n, v, _ in compare_to(got, ref, limits)}
    if detail:
        out["detail"] = training_detail(got, ref)
    return out
