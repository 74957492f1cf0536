"""Readings that the check's limits are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... [--control-seeds ...] [--fault-seeds ...]

For each seed: the program's numbers against the plain reference (what a
run's check compares, without the window: a training cell's readings need
none); for each control seed: the control, which is the reference computed
a precision lower (fp8 in place of bf16) put in the program's place,
against the reference; for each fault seed: the program with a fault
planted in its timed path (the driver's ``FAULTS``), against the
reference.  One JSON line a reading.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, mode: str, device, detail: bool = False) -> dict:
    """One seed's readings in ``mode``: "program", "control" or a fault of
    the driver's ``FAULTS``.  A driver whose check reads answers of the
    window (``CHECK_WINDOW_S``) runs a short window first, with its
    ``CALIBRATION_PARAMS`` in the traffic's place (a larger share of the
    requests checked, so that a seed compares about as many as a run)."""
    import torch

    mod, drv = cell.driver(seed, device)
    drv.tr = {**drv.tr, **getattr(mod, "CALIBRATION_PARAMS", {})}
    undo = mod.FAULTS[mode]() if mode in getattr(mod, "FAULTS", {}) else None
    try:
        t = time.perf_counter()
        drv.setup()
        setup_s = time.perf_counter() - t
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < getattr(mod, "CHECK_WINDOW_S", 0.0):
            drv.step()
        out = mod.calibration(drv, mode, cell.traffic["limits"], detail)
    finally:
        if undo is not None:
            undo()
    del drv
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "mode": mode, "setup_s": setup_s, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--detail", action="store_true", help="print what lies behind each number too")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.harness import runner
    from portbench.run import cache_dirs

    cache_dirs()
    cell = runner.Cell(args.workload)
    mod, _ = cell.driver(0, "cpu")
    plan = [(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
    plan += [(s, f) for f in getattr(mod, "FAULTS", {}) for s in args.fault_seeds]
    for seed, mode in plan:
        print(json.dumps(readings(cell, seed, mode, args.device, detail=args.detail)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
