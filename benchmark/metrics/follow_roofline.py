"""``follow_roofline``: the flow following's least time over its device
time in the traced calls. The least time (``costs/follow.py``) is that of
the traced frames' pixels and of their followed pixels, taken as the
window's followed pixels a frame (``_device.COUNTS["follow_px"]``) times
the traced frames (the two movies alternate, in the traced calls as in the
window), for the configuration's ``niter`` steps; the device time is the
summed time of the kernels named ``follow_kernel`` in the trace. Nothing
where the program has no such counter or kernel."""

import re

from benchmark.costs.follow import least_follow_seconds

KERNELS = re.compile(r"\bfollow_kernel\b")


def read(ctx, name):
    from tissue_image_processing_tpu_torch import _device

    counts = getattr(_device, "COUNTS", {})
    if (ctx.trace is None or not ctx.traced_frames or not ctx.frames
            or not counts.get("follow_px")):
        return None
    spent = ctx.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    pixels = ctx.traced_frames * ctx.traffic["height"] * ctx.traffic["width"]
    followed = counts["follow_px"] / ctx.frames * ctx.traced_frames
    steps = int(ctx.config["niter"])
    return 100.0 * least_follow_seconds(pixels, followed, steps) / spent
