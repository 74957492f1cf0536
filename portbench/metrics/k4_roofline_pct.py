"""k4_roofline_pct: K4's least time for the traced steps (a step's coarse
pass, with its EA weights, and fine pass over both halves: the larger of
its bf16 FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s, counted from
the cell's shapes) over the device time of K4's kernels in the trace, in %.
A kernel of another name is not counted: then nothing is read."""

from portbench.harness import counts

KERNELS = ("bundle_loss_kernel", "dw_kernel", "sum_slices")


def read(ctx):
    t = sum(ctx["kernels"].get(k, 0.0) for k in KERNELS)
    if t <= 0 or not ctx["steps"]:
        return None
    s = counts.nerf_shapes(ctx["traffic"])
    E, nh = counts.field_dims(ctx["config"]["field"])
    bc, oc = counts.k4_pass(s["H"], s["R"], s["Pc"], E, nh, True)
    bf, of = counts.k4_pass(s["H"], s["R"], s["Pf"], E, nh, False)
    least = counts.bound_s(bc + bf, oc + of, counts.BF16_FLOPS) * ctx["steps"]
    return 100.0 * least / t
