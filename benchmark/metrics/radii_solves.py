"""``radii_solves``: the adaptive radii's connected-component solves over
the window (``_device.COUNTS["radii_solves"]``, added by
``core/tracking.py:adaptive_effective_ranges`` on the host: one for each
frame linked to the one before, and one more each time a subnet is solved
again at a shrunken radius), a frame of the window. Read as
``auction_rounds`` is: the counter of the metric's name over the frames."""

from benchmark.metrics.auction_rounds import read  # noqa: F401
