"""Least time of a watershed flood, counted a pixel of the frames flooded
(the separator rows that a stacked flood adds are the program's layout and
are not counted). Inputs read once and results written once:

- Bellman-Ford flood levels: image (4 B) and seeds (4 B) in, levels (4 B)
  out;
- each connected-component minimum (two a flood, by relaxation or by
  union-find): mask (1 B) and initial values (4 B) in, minima (4 B) out;
- settle mask: levels (4 B) in, mask (4 B) out;
- settle: mask (4 B) and seeds (4 B) in, labels (4 B) and stamps (4 B) out.

A binary flood (the U-Net's boundary maps) floods at the image's own
levels: no Bellman-Ford phase. Every phase is bound by bytes: its few
comparisons a pixel fall far below the card's rate."""

from benchmark.costs.peaks import HBM_BYTES_PER_S

BYTES_A_PIXEL = {"watershed": 12 + 2 * 9 + 8 + 16, "binary": 2 * 9 + 8 + 16}


def least_seconds(kind: str, pixels: float) -> float:
    """Least time of flooding ``pixels`` frame pixels in floods of
    ``kind`` ("watershed" or "binary")."""
    return BYTES_A_PIXEL[kind] * pixels / HBM_BYTES_PER_S
