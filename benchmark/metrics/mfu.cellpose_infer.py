"""``mfu.cellpose_infer``: the whole step's share of the card's peak, the
Cellpose network's operations for every frame the traced calls completed
(the tiles a frame and the operations a tile of ``costs/cellpose.py``),
over the bfloat16 peak times the traced window's seconds. It bounds what
any one kernel's gain can show."""

from benchmark.costs.cellpose import tile_flops, tiles_a_frame
from benchmark.costs.peaks import BF16_FLOPS


def read(ctx, name):
    cfg = ctx.config
    if (cfg.get("segmenter") != "cellpose" or ctx.trace is None
            or not ctx.trace.kernels or ctx.trace.window_s <= 0):
        return None
    tiles = tiles_a_frame(ctx.traffic["height"], ctx.traffic["width"],
                          cfg["diameter"], cfg["diam_mean"], cfg["tile"],
                          cfg["tile_overlap"])
    flops = tile_flops(int(cfg["tile"])) * tiles
    return (100.0 * flops * ctx.traced_frames
            / (BF16_FLOPS * ctx.trace.window_s))
