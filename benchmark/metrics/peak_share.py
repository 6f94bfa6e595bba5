"""``peak_share.unet``: the U-Net forward's operations (``costs/unet.py`` at
the padded frame the program feeds it) for every frame of the traced run's
window, over the bfloat16 peak times the ``unet`` stage span's seconds."""

from benchmark.costs.peaks import BF16_FLOPS
from benchmark.costs.unet import forward_flops, padded


def read(ctx, name):
    stage = name.split(".", 1)[1]
    unet = ctx.config.get("unet")
    if unet is None or not ctx.timings or not ctx.timings.get(stage):
        return None
    flops = forward_flops(padded(ctx.traffic["width"]),
                          padded(ctx.traffic["height"]), unet["depth"],
                          unet["base_filters"], unet["in_channels"])
    return 100.0 * flops * ctx.frames / (BF16_FLOPS * ctx.timings[stage])
