"""infer_mfu: a request's forward FLOPs (the ResNet-UNet on its crops, the
similarity products of its queries against every key; counted from the
cell's shapes) times the traced requests, over the traced stretch's
seconds times the card's bf16 peak, in %."""

from portbench.harness import counts


def read(ctx):
    if not ctx["steps"]:
        return None
    flops = counts.serve_request_flops(ctx["config"], ctx["traffic"]) * ctx["steps"]
    return 100.0 * flops / (ctx["window_s"] * counts.BF16_FLOPS)
