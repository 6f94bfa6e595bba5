"""The floods' least time over their device time in the traced calls: every
frame of those calls flooded once (Bellman-Ford, two component minima,
settle mask and settle for the watershed; no Bellman-Ford for the U-Net's
binary boundary maps; bytes by ``costs/flood.py``) over the summed time of
the flood kernels in the trace (the diffusions, the union-find scan's four
kernels, the settle mask and the settle)."""

import re

from benchmark.costs.flood import least_seconds

KERNELS = re.compile(r"\b(diffusion|cc_tiles|cc_seams|cc_fold|cc_result|"
                     r"settle_mask|settle)_kernel\b")


def read(ctx, name):
    if ctx.trace is None or not ctx.traced_frames:
        return None
    spent = ctx.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    kind = "binary" if ctx.config["segmenter"] == "unet" else "watershed"
    pixels = ctx.traced_frames * ctx.traffic["height"] * ctx.traffic["width"]
    return 100.0 * least_seconds(kind, pixels) / spent
