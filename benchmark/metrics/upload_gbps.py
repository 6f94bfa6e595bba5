"""``upload_gbps``: the movie's host bytes the program uploaded over the
window (``_device.COUNTS["upload_bytes"]``, added by
``core/pipeline.py:_upload``, as given: uint16 for a raw movie) over the
seconds of its ``upload`` stage span, in GB/s."""


def read(ctx, name):
    from tissue_image_processing_tpu_torch import _device

    counts = getattr(_device, "COUNTS", {})
    seconds = (ctx.timings or {}).get("upload")
    if "upload_bytes" not in counts or not seconds:
        return None
    return counts["upload_bytes"] * 1e-9 / seconds
