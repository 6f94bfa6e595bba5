"""``peak_share.cpnet``: the Cellpose network's operations for every tile
the window ran (``_device.COUNTS["cp_tiles"]``; ``costs/cellpose.py``, 31.0
GFLOP a 224^2 tile) over the bfloat16 peak times the ``cpnet`` stage
span's seconds (the forward alone); nothing where the program has no such
span or counter."""

from benchmark.costs.cellpose import tile_flops
from benchmark.costs.peaks import BF16_FLOPS


def read(ctx, name):
    from tissue_image_processing_tpu_torch import _device

    tiles = getattr(_device, "COUNTS", {}).get("cp_tiles")
    seconds = (ctx.timings or {}).get("cpnet")
    if not tiles or not seconds:
        return None
    flops = tile_flops(int(ctx.config["tile"]))
    return 100.0 * flops * tiles / (BF16_FLOPS * seconds)
