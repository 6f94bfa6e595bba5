"""``qc_iters``: the flow check's diffusion iterations over the window
(``_device.COUNTS["qc_iters"]``, added by ``ops/flows.py:masks_to_flows``:
2 x the largest mask's (ly + lx), each a pass over the frame in float64), a
frame of the window; nothing where the program has no such counter. Read
as ``auction_rounds`` is."""

from benchmark.metrics.auction_rounds import read  # noqa: F401
