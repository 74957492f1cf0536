#!/usr/bin/env python3
"""Where a benchmark cell's step goes, stage by stage: one traced run of
the cell (``portbench/harness/runner.py``, as ``portbench/run.py
--trace 1`` makes it), its Chrome trace read by the program's spans
(``portbench/harness/stages.py``).

    python3 tools/stage_table.py --workload <cell> --seed <n> [--seconds 51]

Prints the stage table on standard error, then one JSON line: the run's
result as the benchmark prints it (``result``), the stages and the
window's launches, the idle gaps labelled by the innermost span of the
benchmark's or the program's namespace, and the per-stage numbers a
metric would read (``stage_ms``: ms a step of the cell's top-level
stages; ``launches_a_step``; ``*_span_roofline_pct``: the kernel's least
time, as its ``*_roofline_pct`` reckons it, over the device time launched
inside its launch span; ``coverage``: the top-level stages' device
timeline over the benchmark's step span's).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import run as bench_run  # noqa: E402  (its import starts set-up's clock)

# per driver: the benchmark's step span, the program's top-level stages in
# it, and the rooflines read again over a launch span (each where its span
# is in the trace: K4's bf16 or float32-activation variant)
NERF = ("nerf.train_step", ["nerf.rays", "nerf.field", "nerf.adam"],
        (("k4_roofline_pct", "kernel.bundle_loss"), ("k4_act32_roofline_pct", "kernel.bundle_loss_act32")))
CELLS = {
    "nerf_train": NERF,
    "nerf_train_act32": NERF,  # nerf_train's window, its check with a probe step more
    # a replayed step's loss and gradient run inside pose.replay, the eager
    # and captured steps' in the three stages before it
    "pose_train": ("pose.train_step", ["pose.augment", "pose.forward", "pose.backward", "pose.replay", "pose.adam"],
                   ()),
    "serve": ("serve.estimate_poses", ["infer.unet", "infer.k3", "infer.filter", "infer.draw", "infer.ransac"],
              (("k3_roofline_pct", "kernel.corr_argmax"),)),
    # one image through SurfEmb's estimator; K2 in the refiner's set-up
    "surf_eval": ("surf_eval.estimate", ["surf.unet", "surf.distribution", "surf.sample", "surf.p3p", "surf.score",
                                         "surf.refine"], (("k2_roofline_pct", "kernel.nn_min"),)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    bench_run.cache_dirs()
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils.profiling import SPAN_PREFIXES
    from portbench.harness import runner, stages
    from portbench.harness import trace as trace_lib

    cell = runner.Cell(args.workload)
    if not torch.cuda.is_available():
        print("stage_table: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    seen = {}
    reduce = trace_lib.reduce

    def keep(events, prefixes=()):
        seen.update(events=events, prefixes=tuple(prefixes))
        return reduce(events, prefixes)

    trace_lib.reduce = keep
    try:
        out = runner.run(cell, args.seed, args.seconds, True, "cuda:0", bench_run.T0)
    finally:
        trace_lib.reduce = reduce
    prefixes = seen["prefixes"] + SPAN_PREFIXES
    st = stages.reduce(seen["events"], prefixes)
    steps = out["attempted"]
    ctx = {"steps": steps, "config": cell.config, "traffic": cell.traffic["params"], **st}
    step_span, top, roofs = CELLS[cell.traffic["driver"]]
    derived = {"stage_ms": {s: stages.ms_a_step(ctx, s) for s in top},
               "launches_a_step": st["launches"] / steps}
    whole = stages.ms_a_step(ctx, step_span)
    derived["coverage"] = sum(v or 0.0 for v in derived["stage_ms"].values()) / whole if whole else None
    for metric, span in roofs:
        rec = st["stages"].get(span)
        if rec is None:
            continue
        reader = runner.load_module(runner.metric_path(metric), "stage_table_" + metric)
        # the span's device time, under the first of the names the reader sums
        derived[metric.replace("_roofline", "_span_roofline")] = reader.read(
            {**ctx, "kernels": {reader.KERNELS[0]: rec["busy_s"]}})
    print(f"stages of {args.workload}, seed {args.seed}, {steps} steps:", file=sys.stderr)
    for line in stages.table(st["stages"], steps):
        print(line, file=sys.stderr)
    labels = trace_lib.top(reduce(seen["events"], prefixes)["idle"])
    print(json.dumps({"workload": args.workload, "seed": args.seed, "result": out, **st, "idle_gaps": labels,
                      **derived}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
