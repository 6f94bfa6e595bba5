"""``mfu.unet_infer``: the whole step's share of the card's peak, the U-Net
forward's operations (``costs/unet.py``) for every frame the traced calls
completed, over the bfloat16 peak times the traced window's seconds. It
bounds what any one kernel's gain can show."""

from benchmark.costs.peaks import BF16_FLOPS
from benchmark.costs.unet import forward_flops, padded


def read(ctx, name):
    unet = ctx.config.get("unet")
    if (unet is None or ctx.trace is None or not ctx.trace.kernels
            or ctx.trace.window_s <= 0):
        return None
    flops = forward_flops(padded(ctx.traffic["width"]),
                          padded(ctx.traffic["height"]), unet["depth"],
                          unet["base_filters"], unet["in_channels"])
    return (100.0 * flops * ctx.traced_frames
            / (BF16_FLOPS * ctx.trace.window_s))
