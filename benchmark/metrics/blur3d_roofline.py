"""The blurs' least time over their device time in the traced calls: the
least time of every blur the program launched there (its own launch counter
by volume and taps, ``_device.BLUR_LAUNCHES``; cost by ``costs/blur3d.py``)
over the summed time of the kernels named ``blur_*`` in the trace."""

import re

from benchmark.costs.blur3d import least_total_seconds

KERNELS = re.compile(r"\bblur_\w*kernel\b")


def read(ctx, name):
    if ctx.trace is None or not ctx.blur_launches:
        return None
    spent = ctx.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_total_seconds(ctx.blur_launches.items()) / spent
