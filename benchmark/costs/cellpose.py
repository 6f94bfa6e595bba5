"""Operations of Cellpose v2's ``CPnet`` forward (``nbase`` [2, 32, 64, 128,
256], 3 x 3 convs) on one tile, counted from the layer shapes: two
operations a multiply-add. Each down level has a 1 x 1 projection and four
3 x 3 convs; each up level a 1 x 1 projection, four 3 x 3 convs and three
style ``Linear`` layers; the output is a 1 x 1 conv to 3 channels.
BatchNorm, ReLU, pooling, upsampling, the additions and the style's mean
are left out (under 0.5% of the total). And the tiles a frame that the
eval path cuts, from the frame's shape alone."""

import math

NBASE = (2, 32, 64, 128, 256)


def _conv(hw: int, cin: int, cout: int, taps: int) -> float:
    return 2.0 * hw * cin * cout * taps


def tile_flops(side: int = 224, nbase=NBASE, nout: int = 3) -> float:
    """Operations of one (side, side) tile's forward."""
    total = 0.0
    levels = len(nbase) - 1
    for n in range(levels):
        hw = (side >> n) ** 2
        cin, cout = nbase[n], nbase[n + 1]
        total += _conv(hw, cin, cout, 1) + _conv(hw, cin, cout, 9)
        total += 3 * _conv(hw, cout, cout, 9)
    up = list(nbase[1:]) + [nbase[-1]]
    style = nbase[-1]
    for n in range(levels):
        hw = (side >> n) ** 2
        cin, cout = up[n + 1], up[n]
        total += _conv(hw, cin, cout, 1) + _conv(hw, cin, cout, 9)
        total += 3 * _conv(hw, cout, cout, 9) + 3 * 2.0 * style * cout
    return total + _conv(side * side, up[0], nout, 1)


def tiles_a_frame(height: int, width: int, diameter: float,
                  diam_mean: float = 30.0, tile: int = 224,
                  overlap: float = 0.1) -> int:
    """Tiles of a (height, width) frame: resized by diam_mean / diameter,
    padded to a multiple of 16, ceil((1 + 2 overlap) L / tile) starts a
    side (one where L <= tile)."""
    r = float(diam_mean) / float(diameter)
    n = 1
    for L in (height, width):
        L = L if r == 1.0 else int(L * r)
        L = int(16 * math.ceil(L / 16))
        n *= 1 if L <= tile else int(math.ceil((1 + 2 * overlap) * L / tile))
    return n
