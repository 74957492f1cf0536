"""nerf_step_mfu: the forward and backward FLOPs of a NeRF step's field
passes (coarse and fine, both halves, counted from the cell's shapes) times
the traced steps, over the traced stretch's seconds times the card's bf16
peak, in %."""

from portbench.harness import counts


def read(ctx):
    if not ctx["steps"]:
        return None
    flops = counts.field_step_flops(ctx["config"]["field"], ctx["traffic"]) * ctx["steps"]
    return 100.0 * flops / (ctx["window_s"] * counts.BF16_FLOPS)
