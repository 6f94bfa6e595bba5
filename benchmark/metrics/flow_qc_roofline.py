"""``flow_qc_roofline``: the flow check's diffusion, least time over its
device time in the traced calls. The least time (``costs/flow_qc.py``) is
that of the traced frames' pixels and of their mask pixel updates, taken as
the window's mask pixels x iterations a frame
(``_device.COUNTS["qc_px_iters"]``) times the traced frames (the two movies
alternate, in the traced calls as in the window); the device time is the
summed time of the kernels named ``flow_diffuse_kernel`` or
``flow_diffuse_global_kernel`` in the trace. Nothing where the program has
no such counter or kernel."""

import re

from benchmark.costs.flow_qc import least_flow_qc_seconds

KERNELS = re.compile(r"\bflow_diffuse(_global)?_kernel\b")


def read(ctx, name):
    from tissue_image_processing_tpu_torch import _device

    counts = getattr(_device, "COUNTS", {})
    if (ctx.trace is None or not ctx.traced_frames or not ctx.frames
            or not counts.get("qc_px_iters")):
        return None
    spent = ctx.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    pixels = ctx.traced_frames * ctx.traffic["height"] * ctx.traffic["width"]
    px_iters = counts["qc_px_iters"] / ctx.frames * ctx.traced_frames
    return 100.0 * least_flow_qc_seconds(pixels, px_iters) / spent
