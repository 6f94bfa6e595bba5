"""``auction_rounds``: the tracker's auction rounds over the window
(``_device.COUNTS["auction_rounds"]``, added by
``core/tracking.py:auction_assignment``: each round waits for the host to
read its flag), a frame of the window; nothing where the program has no
such counter."""


def read(ctx, name):
    from tissue_image_processing_tpu_torch import _device

    counts = getattr(_device, "COUNTS", {})
    if name not in counts or not ctx.frames:
        return None
    return counts[name] / ctx.frames
