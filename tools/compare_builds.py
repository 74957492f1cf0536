#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch / CUDA port on one CUDA device: the
ptxas resource use of every kernel each tree builds (registers, stack
frame, spill stores and loads, from ``-Xptxas=-v``), then K4 (the
bundle-loss kernel) at the NeRF train step's shapes, K2 (nearest
neighbour) and K3 (dense correspondence) at the serving path's shapes,
their outputs bit for bit and their times, run in the order A, B, B, A.

    python3 tools/compare_builds.py OLD_ROOT NEW_ROOT

Each root is a checkout's top directory, for example an unpacked
``git archive`` of another commit.  Each tree builds its own kernels into
its own ``.kernel_build``.  Fails if a tree's kernel gives other bits on
its second run; prints whether the two trees' outputs are bit-identical.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile

PKG = "imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch"
# (embedding, rays, points) of K4's launches in a train step of both halves
K4_SHAPES = [("direct", 1200, 64), ("direct", 1200, 320), ("grouped", 1200, 64), ("grouped", 1200, 320)]
# K2 (queries, references): the serve's ICP launch and 50,000 x 50,000,
# masked; K3 (queries, keys), E = 12: the serve's launch, one crop and 8
# crops against 80,000 keys
K2_SHAPES = [(913, 14_018), (50_000, 50_000)]
K3_SHAPES = [(45_000, 1_024), (5_625, 80_000), (45_000, 80_000)]


def _cuda_build(root: str):
    """The ``ops/cuda_build`` module of the tree at ``root``."""
    spec = importlib.util.spec_from_file_location(f"cuda_build_{abs(hash(root))}",
                                                  os.path.join(root, PKG, "ops", "cuda_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_name(mangled: str) -> str:
    """The kernel's own identifier in an Itanium-mangled name: the last
    component of its (possibly nested) name."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while m := re.match(r"\d+", mangled[pos:]):
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
    return name


def ptxas_usage(root: str) -> dict:
    """{source file: {kernel: {registers, stack, spill_stores, spill_loads}}}
    of the tree's CUDA sources, compiled as its build compiles them."""
    from torch.utils.cpp_extension import COMMON_NVCC_FLAGS, include_paths

    cb = _cuda_build(root)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    incs = [f"-I{p}" for p in include_paths(device_type="cuda")]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for src in (s for s in cb.SOURCES if s.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *COMMON_NVCC_FLAGS, *cb.CUDA_FLAGS, "-Xptxas=-v", *incs, "-c", src, "-o", obj]
            procs[os.path.basename(src)] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True)
        usage = {}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
            kernels, entry = {}, None
            for line in out.splitlines():
                if m := re.search(r"Compiling entry function '([^']+)'", line):
                    entry = kernels.setdefault(_kernel_name(m.group(1)), {})
                elif entry is not None and (m := re.search(
                        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                    entry.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
                elif entry is not None and (m := re.search(r"Used (\d+) registers", line)):
                    entry["registers"] = int(m[1])
            usage[name] = kernels
    return usage


def _timed(fn, reps: int = 10) -> dict:
    """{ms: mean of ``reps`` calls of ``fn`` after one, timed with CUDA
    events; digest: sha256 of the first call's output tensors}."""
    import torch

    outs = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in outs:
        digest.update(t.cpu().numpy().tobytes())
    return {"ms": start.elapsed_time(end) / reps, "digest": digest.hexdigest()}


def tree_run(root: str) -> dict:
    """The tree at ``root``: K4 at ``K4_SHAPES`` on random full-width fields
    (density bias 0), K2 at ``K2_SHAPES`` and K3 at ``K3_SHAPES`` on random
    points and features, from fixed seeds: {shape: {ms, digest of every
    output}}."""
    sys.path.insert(0, root)
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import field_kernel as fk
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops import point_kernels as pk

    dev = torch.device("cuda", 0)
    out = {}
    for embed, R, P in K4_SHAPES:
        cfg = FieldConfig(act_dtype="bfloat16", embed_method=embed)
        fields = []
        for h in range(2):
            f = NerfField(cfg).reset_parameters(torch.Generator().manual_seed(R + P + h))
            torch.nn.init.zeros_(f.density_layer.bias)
            fields.append(f.to(dev))
        g = torch.Generator(device=dev).manual_seed(R + P)
        o = torch.randn((2, R, 3), generator=g, device=dev)
        o = 4.0 * o / o.norm(dim=-1, keepdim=True)
        d = -o / 4.0 + 0.1 * torch.randn((2, R, 3), generator=g, device=dev)
        lengths = torch.sort(2.0 + 4.0 * torch.rand((2, R, P), generator=g, device=dev), -1).values
        pts = (o[:, :, None] + d[:, :, None] * lengths[..., None]).contiguous()
        dn = (d / d.norm(dim=-1, keepdim=True)).contiguous()
        col = torch.rand((2, R, 3), generator=g, device=dev)
        sil = (torch.rand((2, R, 1), generator=g, device=dev) > 0.5).float()
        tgt = torch.cat([col, sil, torch.ones_like(sil), torch.zeros_like(col)], -1).contiguous()
        weights = tuple(torch.stack(b) for b in zip(*(fk.loss_weights(f) for f in fields)))
        fm = torch.from_numpy(fk.fmat_of(cfg)).to(dev)
        # a tree from before the float32-activation variant takes no act_dtype
        act = ("bfloat16",) if "act_dtype" in inspect.signature(fk.bundle_loss_cuda).parameters else ()
        args = (pts, dn, tgt, fm, weights, fk.ladder_of(cfg), cfg.softplus_beta, 0.1, 500.0 / R, True, *act)

        def k4():
            grads, loss, w = fk.bundle_loss_cuda(*args)
            return (*grads, loss, w)

        out[f"K4 {embed} 2 x {R} x {P}"] = _timed(k4)
    for n, m in K2_SHAPES:
        g = torch.Generator(device=dev).manual_seed(n + m)
        q, r = torch.randn((n, 3), generator=g, device=dev), torch.randn((m, 3), generator=g, device=dev)
        mask = torch.rand((m,), generator=g, device=dev) > 0.1
        out[f"K2 {n} x {m}"] = _timed(lambda: pk.nn_min_cuda(q, r, mask), reps=20)
    for n, m in K3_SHAPES:
        g = torch.Generator(device=dev).manual_seed(n + m)
        q, k = torch.randn((n, 12), generator=g, device=dev), torch.randn((m, 12), generator=g, device=dev)
        out[f"K3 {n} x {m} x 12"] = _timed(lambda: pk.correspondence_argmax_cuda(q, k), reps=20)
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        print(json.dumps(tree_run(os.path.abspath(sys.argv[2]))))
        return
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    roots = {"A": os.path.abspath(sys.argv[1]), "B": os.path.abspath(sys.argv[2])}
    for label, root in roots.items():
        print(f"ptxas resource use, {label} ({root}): {json.dumps(ptxas_usage(root))}", flush=True)
    runs = []
    for label in ("A", "B", "B", "A"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", roots[label]],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"kernel run of {label} failed:\n{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    same = True
    for shape in runs[0][1]:
        times = ", ".join(f"{label} {r[shape]['ms']:.3f}" for label, r in runs)
        equal = runs[0][1][shape]["digest"] == runs[1][1][shape]["digest"]
        print(f"{shape}: ms {times}; A and B bit-identical: {equal}", flush=True)
        for a, b in ((0, 3), (1, 2)):
            if runs[a][1][shape]["digest"] != runs[b][1][shape]["digest"]:
                same = False
    if not same:
        sys.exit("a tree's kernel gave other bits on its second run")


if __name__ == "__main__":
    main()
