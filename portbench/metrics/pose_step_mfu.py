"""pose_step_mfu: the forward and backward FLOPs of a descriptor step (the
ResNet-UNet on the batch, the key head at the positives and the negatives,
InfoNCE's query-negative products; counted from the cell's shapes) times
the traced steps, over the traced stretch's seconds times the card's bf16
peak, in %."""

from portbench.harness import counts


def read(ctx):
    if not ctx["steps"]:
        return None
    flops = counts.pose_step_flops(ctx["config"], ctx["traffic"]) * ctx["steps"]
    return 100.0 * flops / (ctx["window_s"] * counts.BF16_FLOPS)
