"""k2_roofline_pct: K2's least time for the traced images' refiner key
lookups (each image's crop pixels against every key: the larger of 9
operations a pair at one operation a lane a clock and its bytes at 3.35
TB/s, ``harness/surf_counts.py``) over the device time of K2's kernels in
the trace, in %.  A kernel of another name is not counted: then nothing
is read."""

from portbench.harness import surf_counts

KERNELS = ("nn_min_kernel", "nn_min_merge_kernel")


def read(ctx):
    t = sum(ctx["kernels"].get(k, 0.0) for k in KERNELS)
    if t <= 0 or not ctx["steps"]:
        return None
    tr = ctx["traffic"]
    return 100.0 * surf_counts.k2_least_s(tr["image_size"] ** 2, tr["n_keys"]) * ctx["steps"] / t
