"""``follow_px``: the pixels Cellpose's flow following moved over the
window (``_device.COUNTS["follow_px"]``, added by ``ops/flows.py:follow``),
a frame of the window; nothing where the program has no such counter.
Read as ``auction_rounds`` is."""

from benchmark.metrics.auction_rounds import read  # noqa: F401
