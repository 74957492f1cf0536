"""The port's benchmark: one run of one cell on the machine it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (process start to the first timed
step) builds the inputs and the program's state from the seed and warms
every shape the cell uses; the window then drives the cell's entry for
``--seconds`` (``--trace 1``: a traced stretch instead, whose per-layer
metrics are reported).  Once the window has closed the run compares what
the window's path produced with the plain reference and prints each
compared number beside its limit (last on standard error, and last in the
result), then the result as one JSON line, last on standard output.

A run needs as many CUDA cards as the cell asks for, and exits non-zero
without a result when they are missing, when the program cannot be
imported, or when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    build = os.path.join(ROOT, ".kernel_build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import clock, runner

    clock.mark("import torch")

    cell = runner.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print("setup: " + ", ".join(f"{n} {s:.3f} s" for n, s in clock.phases(T0)), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
