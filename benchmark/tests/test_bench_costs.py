"""The cost counts against hand counts at small shapes, and the readers'
arithmetic on made-up contexts."""

import math
import types

import pytest

from benchmark.costs import blur3d, flood, peaks, unet
from benchmark.run import reader
from benchmark.tests.helpers import ROOT
from benchmark.trace import Trace


def test_blur_cost_by_hand():
    # (2, 4, 8) float32 volume, taps (3, 5, 5): 64 voxels read and written
    nbytes, ops = blur3d.launch_cost(2, 4, 8, 3, 5, 5)
    assert nbytes == 64 * 4 * 2
    assert ops == 64 * 2 * 13
    want = 2 * max(512 / peaks.HBM_BYTES_PER_S, 1664 / peaks.FP32_FLOPS)
    assert blur3d.least_total_seconds([((2, 4, 8, 3, 5, 5), 2)]) == want


def test_the_production_blurs_are_bound_by_bytes():
    # PERF's row 3i: (40, 2000, 2000) at 0.3821 ms, bound by bytes
    for taps in ((5, 9, 9), (9, 17, 17)):
        t = blur3d.least_total_seconds([((40, 2000, 2000, *taps), 1)])
        assert t == pytest.approx(0.3821e-3, rel=1e-3)


def test_flood_cost_by_hand():
    assert flood.BYTES_A_PIXEL == {"watershed": 54, "binary": 42}
    assert flood.least_seconds("watershed", 100) == 5400 / peaks.HBM_BYTES_PER_S


def _conv(hw, cin, cout, k=9):
    return 2 * hw * cin * cout * k


def test_unet_flops_by_hand_at_a_small_shape():
    # depth 1, 4 filters, 8 x 8, 2 channels in, 2 classes
    want = (_conv(64, 2, 4) + _conv(64, 4, 4)          # down block
            + _conv(16, 4, 8) + _conv(16, 8, 8)        # bottleneck
            + _conv(16, 8, 4)                          # transposed conv
            + _conv(64, 8, 4) + _conv(64, 4, 4)        # up block
            + _conv(64, 4, 2, k=1))                    # head
    assert unet.forward_flops(8, 8, depth=1, base_filters=4) == want


def test_unet_flops_match_perf_md_at_1024():
    # PERF.md: 4.95 TFLOP a 1024^2 frame at depth 3 / 128 filters
    assert unet.forward_flops(1024, 1024) / 1e12 == pytest.approx(4.95,
                                                                 abs=0.005)
    assert unet.forward_flops(2048, 2048) == 4 * unet.forward_flops(1024, 1024)
    assert [unet.padded(n) for n in (2000, 2048, 1)] == [2048, 2048, 1]
    with pytest.raises(ValueError):
        unet.forward_flops(100, 100)


def _ctx(**kw):
    base = dict(config={"segmenter": "watershed"},
                traffic={"height": 10, "width": 10}, setup_s=1.0,
                window_s=2.0, frames=8, peak_bytes=2 ** 31,
                timings={"track": 0.4}, trace=None, traced_frames=0,
                blur_launches={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_end_to_end_readers():
    ctx = _ctx()
    assert reader(ROOT, "frames_per_s")(ctx, "frames_per_s") == 4.0
    assert reader(ROOT, "peak_mem_gib")(ctx, "peak_mem_gib") == 2.0
    assert reader(ROOT, "setup_s")(ctx, "setup_s") == 1.0
    assert reader(ROOT, "stage_ms.track")(ctx, "stage_ms.track") == 50.0
    assert reader(ROOT, "stage_ms.project")(ctx, "stage_ms.project") is None


def test_roofline_readers():
    ns = 1_000_000_000
    tr = Trace(kernels=[("void blur_walk_kernel<5, 2>(float const*)", 0, ns),
                        ("settle_kernel(int const*)", ns, 2 * ns),
                        ("cc_tiles_kernel", 2 * ns, 3 * ns),
                        ("void at::native::elementwise", 3 * ns, 4 * ns)],
               window=(0, 5 * ns))
    key = (40, 2000, 2000, 5, 9, 9)
    ctx = _ctx(trace=tr, blur_launches={key: 1000}, traced_frames=1000)
    got = reader(ROOT, "blur3d_roofline")(ctx, "blur3d_roofline")
    assert got == pytest.approx(100 * blur3d.least_total_seconds(
        [(key, 1000)]) / 1.0)
    got = reader(ROOT, "flood_roofline")(ctx, "flood_roofline")
    assert got == pytest.approx(100 * flood.least_seconds("watershed",
                                                          1000 * 100) / 2.0)
    idle = reader(ROOT, "device_idle")(ctx, "device_idle")
    assert idle == pytest.approx(20.0)
    assert reader(ROOT, "blur3d_roofline")(_ctx(trace=tr), "x") is None


def test_unet_readers():
    cfg = {"segmenter": "unet", "unet": {"depth": 3, "base_filters": 128,
                                         "in_channels": 2}}
    ns = 1_000_000_000
    tr = Trace(kernels=[("k", 0, ns)], window=(0, 4 * ns))
    ctx = _ctx(config=cfg, traffic={"height": 2000, "width": 2000},
               timings={"unet": 2.0}, frames=8, trace=tr, traced_frames=4)
    f = unet.forward_flops(2048, 2048)
    got = reader(ROOT, "peak_share.unet")(ctx, "peak_share.unet")
    assert got == pytest.approx(100 * 8 * f / (peaks.BF16_FLOPS * 2.0))
    got = reader(ROOT, "mfu.unet_infer")(ctx, "mfu.unet_infer")
    assert got == pytest.approx(100 * 4 * f / (peaks.BF16_FLOPS * 4.0))
    assert not math.isnan(got)
