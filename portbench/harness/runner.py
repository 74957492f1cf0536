"""One run of one cell: set-up, the measured window (or the traced
stretch), the check of what the window produced, and the result line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is found by name from ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json`` (its ``driver`` names ``drivers/<driver>.py``,
its ``params`` the shapes, its ``limits`` the check's), and
``metrics/<metric>.py`` (or ``metrics/<metric up to its first dot>.py``)
with a ``read(ctx)`` for each per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

import torch

from portbench.harness import clock
from portbench.harness import trace as trace_lib

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "imagesequenceregistrationfor6dposeestimationlabeling_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic, driver
    and metrics, found by name."""

    def __init__(self, name: str, bench: dict | None = None, root: str = ROOT):
        bench = bench if bench is not None else read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, cells[name]
        self.chips = self.entry["chips"]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = read_json(os.path.join(root, conf["file"]))
        self.traffic = read_json(os.path.join(HERE, "traffic", self.entry["traffic"] + ".json"))
        self.driver_path = os.path.join(HERE, "drivers", self.traffic["driver"] + ".py")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        self.metric_paths = {m["name"]: metric_path(m["name"]) for m in self.per_layer}

    def driver(self, seed: int, device, trace: bool = False):
        mod = load_module(self.driver_path, "portbench_driver_" + self.traffic["driver"])
        return mod, mod.Driver(self.config, self.traffic["params"], seed, device, trace)


def metric_path(name: str) -> str:
    """A per-layer metric's reader: ``metrics/<name>.py``, or else the
    reader of the name's first part, ``metrics/<name up to its first
    dot>.py``, which serves a quantity split by cell family."""
    own = os.path.join(HERE, "metrics", name + ".py")
    return own if os.path.isfile(own) else os.path.join(HERE, "metrics", name.split(".")[0] + ".py")


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips))),
            "power_limit": power_limit()}


def power_limit() -> str | None:
    """The first card's power limit as ``nvidia-smi`` reads it."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run; returns the result dict (``checks`` last).  ``t0`` is the
    process's start on the host clock: set-up runs from there to the first
    timed step."""
    dev = torch.device(device)
    torch.zeros((), device=dev)
    sync(dev)
    clock.mark("device")
    mod, drv = cell.driver(seed, dev, trace)
    drv.setup()
    sync(dev)
    setup_s = time.perf_counter() - t0
    clock.mark("warm-up")
    work, steps, reduced = 0, 0, None
    if not trace:
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            work += drv.step()
            steps += 1
        sync(dev)
        window_s = time.perf_counter() - w0
    else:
        lead = time.perf_counter()
        while time.perf_counter() - lead < min(1.0, seconds / 4):
            drv.step()
        sync(dev)
        n = int(cell.traffic["params"].get("trace_steps", 20))
        with trace_lib.Profile() as prof:
            with torch.profiler.record_function(trace_lib.WINDOW_SPAN):
                w0 = time.perf_counter()
                for _ in range(n):
                    work += drv.step()
                    steps += 1
                sync(dev)
                window_s = time.perf_counter() - w0
        reduced = trace_lib.reduce(prof.events(), getattr(mod, "SPANS", ()))
    failed = drv.failed()
    device = device_info(dev, cell.chips)
    metrics = {}
    if not trace:
        e2e = drv.end_to_end(window_s, work)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name in units:
            if name == "setup_s":
                metrics[name] = {"value": setup_s, "unit": "s"}
            elif name in e2e:
                metrics[name] = {"value": e2e[name], "unit": units[name]}
    else:
        device.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        ctx = {"steps": steps, "work": work, "window_s": window_s, "busy_s": reduced["busy_s"],
               "trace_window_s": reduced["window_s"], "kernels": reduced["kernels"], "config": cell.config,
               "traffic": cell.traffic["params"]}
        for m in cell.per_layer:
            reader = load_module(cell.metric_paths[m["name"]], "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = drv.check(cell.traffic["limits"])
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) and failed == 0
    out = {"correct": correct, "attempted": steps, "failed": failed, "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = {"device_ops": trace_lib.top(reduced["kernels"]), "idle_gaps": trace_lib.top(reduced["idle"])}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out
