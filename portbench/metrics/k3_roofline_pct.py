"""k3_roofline_pct: K3's least time for the traced requests (each request's
queries against every key: the larger of 24 FLOPs a pair at 67 TFLOP/s,
one exponential a pair at the special-function rate and its bytes at 3.35
TB/s, counted from the cell's shapes) over the device time of K3's
kernels in the trace, in %.  A kernel of another name is not counted:
then nothing is read."""

from portbench.harness import counts

KERNELS = ("corr_argmax_kernel", "corr_argmax_merge_kernel")


def read(ctx):
    t = sum(ctx["kernels"].get(k, 0.0) for k in KERNELS)
    if t <= 0 or not ctx["steps"]:
        return None
    tr = ctx["traffic"]
    least = counts.k3_least_s(counts.serve_queries(tr), tr["n_keys"], ctx["config"]["field"]["feature_dim"])
    return 100.0 * least * ctx["steps"] / t
