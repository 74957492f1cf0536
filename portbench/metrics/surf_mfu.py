"""surf_mfu: an image's FLOPs through SurfEmb's estimator (the ResNet-UNet,
the distribution's products, the scoring's projections, the refiner's
denominator and objective evaluations; counted from the cell's shapes,
``harness/surf_counts.py``) times the traced images, over the traced
stretch's seconds times the card's bf16 peak, in %."""

from portbench.harness import counts, surf_counts


def read(ctx):
    if not ctx["steps"]:
        return None
    flops = sum(surf_counts.image_flops(ctx["config"], ctx["traffic"]).values()) * ctx["steps"]
    return 100.0 * flops / (ctx["window_s"] * counts.BF16_FLOPS)
