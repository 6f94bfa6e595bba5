"""The box preparation of the flow check's diffusion kernel
(``ops/flow_diffuse_cuda.py``: ``box_plan``, ``neighbour_bits``) on the
CPU, and the flow check's counters and roofline reader. On each label map
(Voronoi cells, masks on the frame's edges and corners, masks enclosing
masks, non-convex and split masks, one-pixel masks, a box over the shared
memory of a block): the size classes and boxes cover every mask pixel
exactly once, the neighbour bits equal the plain loop's weights, and the
centres are v2's. The kernel itself is held to the plain loop in
``test_torch_flow_diffuse_cuda.py``, on the same maps."""

import numpy as np
import pytest
import torch

from benchmark.reference import cellpose as ref
from test_torch_cellpose import _rings
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops import flows as fl
from tissue_image_processing_tpu_torch.ops.flow_diffuse_cuda import (
    box_plan, neighbour_bits, shared_px)

# one intra-op thread: the test workers share the cores
torch.set_num_threads(1)

# padded box pixels a block holds on an H100 (227 KB of shared memory)
H100_SHARED_PX = shared_px(232448)


def _consecutive(a: np.ndarray) -> np.ndarray:
    """Labels renumbered 1..N (0 stays 0), as get_masks gives them."""
    _, inv = np.unique(a, return_inverse=True)
    inv = inv.reshape(a.shape).astype(np.int32)
    return inv if (a == 0).any() else inv + 1


def _voronoi(side=200, cell=50, seed=3):
    """Cells of ~``cell`` px across around jittered seeds; membranes of one
    pixel between half of them, the others touching."""
    rng = np.random.default_rng(seed)
    g = np.arange(cell // 2, side, cell)
    sy, sx = [v.reshape(-1) + rng.integers(-cell // 3, cell // 3 + 1, v.size)
              for v in np.meshgrid(g, g, indexing="ij")]
    yy, xx = np.mgrid[:side, :side]
    d = (yy[..., None] - sy) ** 2 + (xx[..., None] - sx) ** 2
    lab = d.argmin(-1).astype(np.int32) + 1
    edge = np.zeros_like(lab, bool)
    edge[:-1] |= lab[:-1] != lab[1:]
    edge[:, :-1] |= lab[:, :-1] != lab[:, 1:]
    lab[edge & (lab % 2 == 0)] = 0
    return _consecutive(lab)


def _edges():
    """Masks on the frame's four edges and corners, one the whole top row."""
    a = np.zeros((60, 70), np.int32)
    a[0, :] = 1
    a[1:12, 0:10] = 2
    a[2:14, 58:70] = 3
    a[48:60, 0:9] = 4
    a[52:60, 62:70] = 5
    a[20:40, 64:70] = 6
    a[59, 20:50] = 7
    a[25:35, 30:40] = 8
    return a


def _non_convex():
    """An L, a U, a spiral, a mask in two parts, a diagonal-only chain, a
    mask touching another without a membrane."""
    a = np.zeros((64, 64), np.int32)
    a[2:20, 2:6] = 1
    a[16:20, 2:18] = 1                       # L
    a[2:20, 24:28] = 2
    a[2:20, 36:40] = 2
    a[16:20, 24:40] = 2                      # U
    spiral = [(30, 2, 30, 30), (30, 30, 60, 30), (60, 30, 60, 6),
              (60, 6, 40, 6), (40, 6, 40, 20)]
    for y0, x0, y1, x1 in spiral:
        a[min(y0, y1):max(y0, y1) + 1, min(x0, x1):max(x0, x1) + 1] = 3
    a[2:8, 46:52] = 4
    a[12:18, 56:62] = 4                      # two parts, one label
    for k in range(12):
        a[30 + k, 40 + k] = 5                # connected by corners only
    a[44:52, 44:52] = 6
    a[44:52, 52:60] = 7                      # 6 and 7 touch
    return a


def _pixels():
    """One-pixel masks, a two-pixel one, a corner pixel."""
    a = np.zeros((24, 24), np.int32)
    for k, (y, x) in enumerate([(0, 0), (5, 5), (5, 7), (12, 3), (23, 23),
                                (17, 11)], 1):
        a[y, x] = k
    a[9, 15:17] = 7
    return a


def _big():
    """A thick diagonal band whose padded box (132 x 132 px) is over an
    H100 block's shared memory, with ordinary masks beside it."""
    a = np.zeros((150, 150), np.int32)
    yy, xx = np.mgrid[:150, :150]
    a[(np.abs(yy - xx) < 6) & (yy < 130) & (xx < 130)] = 1
    a[100:140, 5:40] = 2
    a[5:30, 110:145] = 3
    a[140:150, 140:150] = 4
    return a


MAPS = {"voronoi": _voronoi, "edges": _edges,
        "rings_a": lambda: _consecutive(_rings()[0]),
        "rings_b": lambda: _consecutive(_rings()[1]),
        "non_convex": _non_convex, "pixels": _pixels, "big": _big}


def label_map(name: str) -> torch.Tensor:
    return torch.from_numpy(MAPS[name]())


def _inputs(m):
    N = int(m.max())
    return (N, *fl._geometry(m, N))


@pytest.mark.parametrize("name", list(MAPS))
def test_classes_and_boxes_cover_every_mask_pixel_once(name):
    m = label_map(name)
    Y, X = m.shape
    N, boxes, centre = _inputs(m)
    a = m.numpy()
    top = (max(Y, X) - 1).bit_length()
    # the sorts' boxes are the scatter reductions' of the hole filling
    for got, want in zip(boxes, fl._label_boxes(m, N)):
        assert torch.equal(got[1:], want[1:])
    for limit_px in (H100_SHARED_PX, 64):
        table, cls, stats = box_plan((Y, X), boxes, centre, limit_px)
        rows = table.numpy()
        assert sorted(rows[:, 0]) == list(range(1, N + 1))
        got = cls.numpy()[rows[:, 0] - 1]
        assert (np.diff(got) >= 0).all()            # grouped by class
        cover = np.zeros_like(a)
        for (L, y0, x0, h, w, _, _), c in zip(rows, got):
            box = a[y0:y0 + h, x0:x0 + w]
            cover[y0:y0 + h, x0:x0 + w] += box == L
            assert (box == L).sum() == (a == L).sum()
            side, px = max(h, w), (h + 2) * (w + 2)
            if c == top + 1:
                assert px > limit_px
            else:
                assert px <= limit_px and c <= top
                assert side <= 1 << c and (c == 0 or side > 1 << (c - 1))
        assert np.array_equal(cover, (a > 0).astype(a.dtype))
        per_class = np.bincount(got, minlength=top + 2)[:top + 2]
        largest = [max([(h + 2) * (w + 2) for (_, _, _, h, w, _, _), c
                        in zip(rows, got) if c == k], default=0)
                   for k in range(top + 1)]
        assert stats.tolist() == per_class.tolist() + largest
    if name == "big":
        assert stats[top + 1] > 0          # 64 px: most masks go global
        _, _, s = box_plan((Y, X), boxes, centre, H100_SHARED_PX)
        assert s[top + 1] == 1


@pytest.mark.parametrize("name", list(MAPS))
def test_neighbour_bits_equal_the_plain_weights(name):
    m = label_map(name)
    Y, X = m.shape
    padded = torch.nn.functional.pad(m.to(torch.int64), (1, 1, 1, 1))
    inner = padded[1:-1, 1:-1]
    weights = torch.stack([
        (padded[1 + dy:Y + 1 + dy, 1 + dx:X + 1 + dx] == inner) & (inner > 0)
        for dy, dx in fl.NEIGHBOURS[1:]])
    bits = neighbour_bits(m)
    assert bits.dtype == torch.uint8
    for k in range(8):
        assert torch.equal((bits >> k) & 1, weights[k].to(torch.uint8))


@pytest.mark.parametrize("name", list(MAPS))
def test_centres_are_v2s(name):
    m = label_map(name)
    N, boxes, centre = _inputs(m)
    table, _, _ = box_plan(m.shape, boxes, centre, H100_SHARED_PX)
    rows = table.numpy()
    rows = rows[np.argsort(rows[:, 0])]
    want = ref._centres(m.numpy()) - 1
    assert np.array_equal(rows[:, 5:7], want)
    a = m.numpy()
    assert (a[rows[:, 5], rows[:, 6]] == rows[:, 0]).all()


def test_plain_path_counts_iterations_and_pixel_updates():
    m = label_map("edges")
    _device.reset_launches()
    T, n_iter = fl.diffusion(m, int(m.max()))
    assert T.shape == (62, 72) and T.dtype == torch.float64
    assert _device.COUNTS["qc_iters"] == n_iter
    assert _device.COUNTS["qc_px_iters"] == int((m > 0).sum()) * n_iter
    assert (T[1:-1, 1:-1][m == 0] == 0).all()


def test_flow_qc_roofline_reader():
    from types import SimpleNamespace

    from benchmark.costs import flow_qc
    from benchmark.run import reader
    from benchmark.tests.helpers import ROOT
    from benchmark.trace import Trace

    ns = 10 ** 9
    tr = Trace(kernels=[("(anonymous namespace)::flow_diffuse_kernel(int "
                         "const*)", 0, ns),
                        ("flow_diffuse_global_kernel", ns, 2 * ns),
                        ("follow_kernel", 2 * ns, 3 * ns)],
               window=(0, 4 * ns))
    ctx = SimpleNamespace(traffic={"height": 2000, "width": 2000}, trace=tr,
                          traced_frames=16, frames=40)
    old = _device.COUNTS
    _device.COUNTS = {"qc_px_iters": 40 * 4_000_000 * 400}
    try:
        got = reader(ROOT, "flow_qc_roofline")(ctx, "flow_qc_roofline")
        ops = 9 * 16 * 4e6 * 400
        assert flow_qc.UNFUSED_FP64_OPS == 17e12
        assert got == pytest.approx(100 * ops / 17e12 / 2.0)
        assert flow_qc.least_flow_qc_seconds(16 * 4e6, 0) == pytest.approx(
            12 * 16 * 4e6 / 3.35e12)
        _device.COUNTS = {}
        assert reader(ROOT, "flow_qc_roofline")(ctx, "x") is None
        _device.COUNTS = {"qc_px_iters": 1}
        ctx.trace = Trace(kernels=[("follow_kernel", 0, ns)],
                          window=(0, ns))
        assert reader(ROOT, "flow_qc_roofline")(ctx, "x") is None
    finally:
        _device.COUNTS = old
