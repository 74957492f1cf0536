"""k4_act32_roofline_pct: K4's float32-activation variant (a field with
``act_dtype`` float32, ``bundle_loss_act32_kernel``) against K4's least
time, in %: the same least time as ``k4_roofline_pct`` reads (a step's
coarse pass, with its EA weights, and fine pass over both halves, from
``counts.k4_pass``: the function's work, which the activations' storage
does not change, so no workspace bytes), over the device time of the
variant's kernels in the trace.  Nothing is read where the variant did
not run, nor where the bf16 variant's ``bundle_loss_kernel`` ran too: the
two share ``dw_kernel`` and ``sum_slices``."""

from portbench.harness import counts

KERNELS = ("bundle_loss_act32_kernel", "dw_kernel", "sum_slices")


def read(ctx):
    k = ctx["kernels"]
    if k.get(KERNELS[0], 0.0) <= 0 or "bundle_loss_kernel" in k or not ctx["steps"]:
        return None
    t = sum(k.get(n, 0.0) for n in KERNELS)
    s = counts.nerf_shapes(ctx["traffic"])
    E, nh = counts.field_dims(ctx["config"]["field"])
    bc, oc = counts.k4_pass(s["H"], s["R"], s["Pc"], E, nh, True)
    bf, of = counts.k4_pass(s["H"], s["R"], s["Pf"], E, nh, False)
    least = counts.bound_s(bc + bf, oc + of, counts.BF16_FLOPS) * ctx["steps"]
    return 100.0 * least / t
