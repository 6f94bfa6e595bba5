"""PyTorch port vs the JAX package: cell tables, contacts, drift and tracking.

On the same labels the cell tables (including the compacted-adjacency
overflow flag and the exact-scatter path), the perimeter map, the contact
matrices (exact and run-length forms, with the overflow flag) and the
second-order adjacency are bit-identical, as are the type bitmask helpers,
``CellTable.empty`` and the pandas bridge. The auction, ``track_movie`` and
the nearest-pixel tracker are exact on the same inputs, including a resume
from a JAX-produced carry converted with ``utils/state.py``; drifts are
quantised to 1/64 px so running sums are exact in any summation order. Phase
correlation, the drift chain, the stage-prior refinement and the local drift
field agree to 1e-4 px. The port alone: the auction's rounds and the
adaptive radii's solves are counted, and counts from two threads all land.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_cell_labels
from oracles import radii_tables
from tissue_image_processing_tpu.core import cell_table as jct
from tissue_image_processing_tpu.core import tracking as jtr
from tissue_image_processing_tpu.ops import drift as jdr
from tissue_image_processing_tpu.ops import neighbors as jnb
from tissue_image_processing_tpu.ops.drift import (
    phase_cross_correlation as j_pcc)
from tissue_image_processing_tpu.ops.regionprops import (
    perimeter_map as j_perimeter_map)
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.core import cell_table as tct
from tissue_image_processing_tpu_torch.core import tracking as ttr
from tissue_image_processing_tpu_torch.ops.drift import (
    phase_cross_correlation as t_pcc)
from tissue_image_processing_tpu_torch.ops import drift as tdr
from tissue_image_processing_tpu_torch.ops import neighbors as tnb
from tissue_image_processing_tpu_torch.ops.neighbors import adjacency_overflow
from tissue_image_processing_tpu_torch.ops.regionprops import perimeter_map
from tissue_image_processing_tpu_torch.utils.state import (
    cell_table_from_numpy, tracking_state_from_numpy)

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "tracking_movie.npz")


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_tables_equal(got, want):
    for name, arr in _leaves(want).items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), arr,
                                      err_msg=name)


def _stripes(h=32, w=64):
    """Alternating 1-px labels: far more vote runs per row than a small k."""
    lab = (np.arange(w)[None, :] % 7 + 1 + 7 * (np.arange(h)[:, None] // 4))
    return lab.astype(np.int32)


@pytest.mark.parametrize("labels,cap,k", [
    (make_cell_labels(128, 128, n_seeds=40, seed=3), 64, 192),
    (make_cell_labels(96, 160, n_seeds=25, seed=7), 32, 192),   # > cap labels
    (_stripes(), 64, 4),                                        # overflow
    # labels far above the capacity: their votes fall past the table and are
    # dropped, as by the JAX scatter
    (make_cell_labels(128, 128, n_seeds=60, seed=5), 16, 192),
])
def test_frame_cellinfo_checked_exact(labels, cap, k):
    want, want_over = jct.frame_cellinfo_checked(jnp.asarray(labels),
                                                 capacity=cap,
                                                 neighbor_compact_k=k)
    got, got_over = tct.frame_cellinfo_checked(torch.from_numpy(labels),
                                               capacity=cap,
                                               neighbor_compact_k=k)
    _assert_tables_equal(got, want)
    assert bool(got_over) == bool(want_over)
    assert bool(adjacency_overflow(torch.from_numpy(labels), cap, k)) == bool(
        want_over)


def test_frame_cellinfo_exact_scatter_path():
    labels = _stripes()
    want = jct.frame_cellinfo(jnp.asarray(labels), capacity=64)
    got = tct.frame_cellinfo(torch.from_numpy(labels), capacity=64)
    _assert_tables_equal(got, want)


def test_cell_table_from_numpy_roundtrip():
    labels = make_cell_labels(64, 64, n_seeds=12, seed=1)
    want = jct.frame_cellinfo(jnp.asarray(labels), capacity=32)
    got = cell_table_from_numpy(_leaves(want), device="cpu")
    _assert_tables_equal(got, want)
    np.testing.assert_array_equal(got.valid_mask().numpy(),
                                  np.asarray(want.valid_mask()))


def test_auction_assignment_exact():
    rng = np.random.default_rng(5)
    M, K = 60, 90
    ben = (rng.random((M, K)) * 100).astype(np.float32)
    ben[rng.random((M, K)) < 0.7] = -np.inf
    pm = rng.random(M) < 0.9
    om = rng.random(K) < 0.85
    want = np.asarray(jtr.auction_assignment(jnp.asarray(ben), jnp.asarray(pm),
                                             jnp.asarray(om), eps=1e-2))
    got = ttr.auction_assignment(torch.from_numpy(ben), torch.from_numpy(pm),
                                 torch.from_numpy(om), eps=1e-2).numpy()
    np.testing.assert_array_equal(got, want)


def test_auction_counts_its_rounds():
    """Two persons whose best objects differ: both win in the first round,
    and the second finds no bidder."""
    ben = torch.tensor([[5.0, 1.0], [1.0, 5.0]])
    every = torch.ones(2, dtype=torch.bool)
    _device.reset_launches()
    got = ttr.auction_assignment(ben, every, every)
    assert got.tolist() == [0, 1]
    assert _device.COUNTS["auction_rounds"] == 2


@pytest.mark.parametrize("per_cell", [True, False])
def test_adaptive_ranges_count_their_solves(per_cell):
    """Three frames of five cells (fewer than ``subnet_limit``), each 2 px
    from a cell of the frame before: one solve a linked frame, none
    shrunk."""
    T, N = 3, 8
    base = np.array([[10, 10], [10, 60], [60, 10], [60, 60], [35, 35]],
                    np.float32)
    cy = np.zeros((T, N), np.float32)
    cx = np.zeros((T, N), np.float32)
    mask = np.zeros((T, N), bool)
    for t in range(T):
        cy[t, :5], cx[t, :5], mask[t, :5] = base[:, 0] + 2 * t, base[:, 1], True
    area = np.full((T, N), 100.0, np.float32)
    _device.reset_launches()
    ttr.adaptive_effective_ranges(cy, cx, area, mask, per_cell=per_cell)
    assert _device.COUNTS["radii_solves"] == 2


def test_reset_launches_zeroes_counts():
    _device.count("upload_bytes", 7)
    _device.reset_launches()
    assert not _device.COUNTS


def test_counts_from_two_threads_all_land():
    n = 20000
    start = threading.Barrier(2)

    def work():
        start.wait(timeout=30)
        for _ in range(n):
            _device.count("threads", 1)
    _device.reset_launches()
    threads = [threading.Thread(target=work) for _ in range(2)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert _device.COUNTS["threads"] == 2 * n
    _device.reset_launches()


def _tracking_inputs(T=24):
    f = np.load(FIX)
    cy = f["cy"][:T].astype(np.float32)
    cx = f["cx"][:T].astype(np.float32)
    area = f["area"][:T].astype(np.float32)
    mask = f["mask"][:T]
    drifts = (np.round(f["drift"][:T] * 64) / 64).astype(np.float32)
    ranges = jtr.adaptive_effective_ranges(cy, cx, area, mask, drifts=drifts,
                                           per_cell=True).astype(np.float32)
    return cy, cx, area, mask, drifts, ranges


def test_adaptive_ranges_match_jax():
    cy, cx, area, mask, drifts, want = _tracking_inputs()
    got = ttr.adaptive_effective_ranges(cy, cx, area, mask, drifts=drifts,
                                        per_cell=True).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def _pack(frames, drift=(0.0, 0.0)):
    """(T, N) tables of ``frames`` (lists of (y, x, area) cells), each cell
    on every other row so that empty rows lie between them, and a constant
    drift a frame."""
    T = len(frames)
    N = 2 * max(len(f) for f in frames) + 3
    cy, cx, area = (np.zeros((T, N), np.float32) for _ in range(3))
    mask = np.zeros((T, N), bool)
    for t, cells in enumerate(frames):
        for k, (y, x, a) in enumerate(cells):
            cy[t, 2 * k + 1], cx[t, 2 * k + 1] = y, x
            area[t, 2 * k + 1], mask[t, 2 * k + 1] = a, True
    drifts = np.tile(np.asarray(drift, np.float32), (T, 1))
    return cy, cx, area, mask, drifts


def _grid(n, y0, x0, step, cols, area=100.0):
    return [(y0 + step * (k // cols), x0 + step * (k % cols), area)
            for k in range(n)]


def _radii_case(name):
    """Tables of one case for the sweep-against-recursion test."""
    if name.startswith("fixture"):
        return _tracking_inputs()[:5]
    if name.startswith("dense_"):
        # the card test's tables: the benchmark's cell density, where the
        # root subnet splits only ~17-20 levels down
        capacity = int(name[len("dense_"):])
        return radii_tables(capacity, 4, {4096: 2700, 8192: 3900}[capacity],
                            capacity)
    if name == "tie":
        # 15 + 15 cells joined only through X, exactly r_1 = 95 from both
        # track piles: 31 cells at r_0, 15 and 15 at r_1; Y lies exactly
        # r_0 = 100 from the first pile and links to nothing
        prev = [(0.0, 0.0, 100.0)] * 15 + [(114.0, 152.0, 100.0)] * 15
        cur = ([(0.1 * k, 0.0, 100.0) for k in range(15)]
               + [(114.0 + 0.1 * k, 152.0, 100.0) for k in range(15)]
               + [(57.0, 76.0, 100.0), (-60.0, -80.0, 100.0)])
        return _pack([prev, cur])
    if name == "limit":
        # subnets of exactly subnet_limit and subnet_limit + 1 cells
        cur = _grid(30, 0.0, 0.0, 20.0, 6) + _grid(31, 0.0, 1000.0, 20.0, 6)
        prev = [(y + 1.0, x + 1.0, a) for y, x, a in cur]
        return _pack([prev, cur])
    if name == "floor":
        # too dense to split above adaptive_stop
        cur = _grid(40, 0.0, 0.0, 0.5, 8)
        prev = [(y + 0.2, x, a + 3.0) for y, x, a in cur]
        return _pack([prev, cur], drift=(0.25, -0.5))
    if name == "empty":
        cells = _grid(40, 0.0, 0.0, 15.0, 8)
        moved = [(y + 2.0, x - 1.0, a + 5.0) for y, x, a in cells]
        return _pack([cells, [], cells, moved, []], drift=(0.5, 0.25))
    if name == "isolated":
        # one linked pair; every other cell 250 px from any track
        prev = _grid(9, 0.0, 0.0, 500.0, 3)
        cur = [(y + 250.0, x + 250.0, a) for y, x, a in prev]
        return _pack([prev, cur + [(3.0, 4.0, 120.0)]])
    raise ValueError(name)


@pytest.mark.parametrize("case", ["fixture", "fixture_chunked", "tie",
                                  "limit", "floor", "empty", "isolated",
                                  "dense_4096", "dense_8192"])
def test_adaptive_radii_sweep_equals_recursion(case):
    """The plain form of the level sweep, and the port's host recursion,
    give the JAX package's per-cell radii bit for bit, and the sweep counts
    the recursion's solves; chunked calls with the carry give the whole
    movie's."""
    cy, cx, area, mask, drifts = _radii_case(case)
    want = jtr.adaptive_effective_ranges(cy, cx, area, mask, drifts=drifts,
                                         per_cell=True).astype(np.float32)
    _device.reset_launches()
    recursion = ttr.adaptive_effective_ranges(cy, cx, area, mask,
                                              drifts=drifts, per_cell=True)
    solves = _device.COUNTS["radii_solves"]
    np.testing.assert_array_equal(recursion.astype(np.float32), want)
    _device.reset_launches()
    t = torch.from_numpy
    if case.endswith("_chunked"):
        h = 10
        first, carry = ttr.adaptive_radii(
            t(cy[:h]), t(cx[:h]), t(area[:h]), t(mask[:h]), drifts=drifts[:h],
            return_carry=True)
        rest = ttr.adaptive_radii(t(cy[h:]), t(cx[h:]), t(area[h:]),
                                  t(mask[h:]), drifts=drifts[h:], carry=carry)
        got = torch.cat([first, rest])
    else:
        got = ttr.adaptive_radii(t(cy), t(cx), t(area), t(mask),
                                 drifts=drifts)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert _device.COUNTS["radii_solves"] == solves


def test_track_movie_exact_and_resumes_from_jax_carry():
    cy, cx, area, mask, drifts, ranges = _tracking_inputs()
    T, N = cy.shape
    valid = np.ones(T, bool)
    valid[7] = False
    kw = dict(search_range=100.0, memory=3, capacity=2 * N)
    j = lambda a: jnp.asarray(a)
    t = torch.from_numpy
    want = np.asarray(jtr.track_movie(j(cy), j(cx), j(area), j(mask),
                                      drifts=j(drifts), frame_valid=j(valid),
                                      search_ranges=j(ranges), **kw))
    got = ttr.track_movie(t(cy), t(cx), t(area), t(mask), drifts=t(drifts),
                          frame_valid=t(valid), search_ranges=t(ranges), **kw)
    np.testing.assert_array_equal(got.numpy(), want)

    # first half in JAX, carry converted, second half in the port
    h = T // 2
    _, jstate, jcum = jtr.track_movie(
        j(cy[:h]), j(cx[:h]), j(area[:h]), j(mask[:h]), drifts=j(drifts[:h]),
        frame_valid=j(valid[:h]), search_ranges=j(ranges[:h]),
        return_state=True, **kw)
    state = tracking_state_from_numpy(_leaves(jstate), device="cpu")
    ids2 = ttr.track_movie(t(cy[h:]), t(cx[h:]), t(area[h:]), t(mask[h:]),
                           drifts=t(drifts[h:]), frame_valid=t(valid[h:]),
                           search_ranges=t(ranges[h:]), init_state=state,
                           cum_drift_init=torch.from_numpy(np.array(jcum)),
                           **kw)
    np.testing.assert_array_equal(ids2.numpy(), want[h:])


@pytest.mark.parametrize("upsample_factor", [1, 100])
@pytest.mark.parametrize("normalization", ["phase", None])
def test_phase_correlation_and_drift_chain(normalization, upsample_factor):
    rng = np.random.default_rng(8)
    base = rng.random((96, 128)).astype(np.float32)
    from scipy import ndimage as ndi
    base = ndi.gaussian_filter(base, 2.0)
    frames = np.stack([ndi.shift(base, (0.37 * i, -0.61 * i), mode="wrap")
                       for i in range(4)]).astype(np.float32)
    want = np.asarray(j_pcc(jnp.asarray(frames[0]), jnp.asarray(frames[2]),
                            upsample_factor=upsample_factor,
                            normalization=normalization))
    got = t_pcc(torch.from_numpy(frames[0]), torch.from_numpy(frames[2]),
                upsample_factor=upsample_factor,
                normalization=normalization).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    want = np.asarray(jtr.compute_drift_chain(jnp.asarray(frames)))
    got = ttr.compute_drift_chain(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


LABELS = {"cells": make_cell_labels(128, 128, n_seeds=40, seed=3),
          "stripes": _stripes()}


@pytest.mark.parametrize("name", sorted(LABELS))
def test_perimeter_map_exact(name):
    lab = LABELS[name]
    want = np.asarray(j_perimeter_map(jnp.asarray(lab)))
    got = perimeter_map(torch.from_numpy(lab))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,cap,k", [
    ("cells", 64, None), ("cells", 64, 192), ("cells", 32, 192),  # > cap
    ("stripes", 64, None), ("stripes", 64, 4),                    # overflow
])
def test_contact_length_matrix_exact(name, cap, k):
    lab = LABELS[name]
    if k is None:
        want = np.asarray(jnb.contact_length_matrix(jnp.asarray(lab), cap))
        got = tnb.contact_length_matrix(torch.from_numpy(lab), cap)
    else:
        want, want_over = jnb.contact_length_matrix_checked(
            jnp.asarray(lab), cap, compact_k=k)
        got, got_over = tnb.contact_length_matrix_checked(
            torch.from_numpy(lab), cap, compact_k=k)
        assert bool(got_over) == bool(want_over)
        want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_second_order_adjacency_exact():
    rng = np.random.default_rng(4)
    adj = np.asarray(jnb.adjacency_matrix(jnp.asarray(LABELS["cells"]), 64))
    mid, ok = rng.random(65) < 0.7, rng.random(65) < 0.8
    want = np.asarray(jnb.second_order_adjacency(
        jnp.asarray(adj), jnp.asarray(mid), jnp.asarray(ok)))
    got = tnb.second_order_adjacency(torch.from_numpy(adj.copy()),
                                     torch.from_numpy(mid), torch.from_numpy(ok))
    np.testing.assert_array_equal(got.numpy(), want)


def _shifted_frames():
    """Four smooth 160 x 192 frames, each shifted by ~(9.4, -7.6) px from
    the one before (wrapping)."""
    from scipy import ndimage as ndi
    base = ndi.gaussian_filter(
        np.random.default_rng(8).random((160, 192)).astype(np.float32), 2.0)
    return np.stack([ndi.shift(base, (9.37 * i, -7.61 * i), mode="wrap")
                     for i in range(4)]).astype(np.float32)


def test_calculate_and_refine_drift():
    frames = _shifted_frames()
    for sub_pixel in (True, False):
        want = np.asarray(jdr.calculate_drift(jnp.asarray(frames[0]),
                                              jnp.asarray(frames[1]), sub_pixel))
        got = tdr.calculate_drift(torch.from_numpy(frames[0]),
                                  torch.from_numpy(frames[1]), sub_pixel)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # stage priors: none, small, negative, and one past the frame (the crop
    # keeps a shape_quantum overlap)
    for dy, dx in ((0.0, 0.0), (9.4, -7.6), (-3.2, 2.9), (150.0, 0.0)):
        want = jdr.refine_drift(frames[0], frames[1], dy, dx)
        got = tdr.refine_drift(frames[0], frames[1], dy, dx, device="cpu")
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=1e-4)
    stage = np.array([[0, 0], [9.4, -7.6], [9.1, -7.2], [10.2, -8.3]])
    want = jdr.drift_chain_with_stage_priors(frames, stage)
    got = tdr.drift_chain_with_stage_priors(frames, stage, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_local_drift_field():
    from scipy import ndimage as ndi
    first = ndi.gaussian_filter(
        np.random.default_rng(9).random((256, 224)).astype(np.float32), 2.0)
    second = ndi.shift(first, (1.3, -2.2), mode="wrap").astype(np.float32)
    want = jtr.local_drift_field(jnp.asarray(first), jnp.asarray(second),
                                 window_size=96, step_size=48)
    got = ttr.local_drift_field(torch.from_numpy(first),
                                torch.from_numpy(second),
                                window_size=96, step_size=48)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_track_movie_nearest_pixel_exact():
    T = 5
    labs = np.stack([make_cell_labels(96, 96, n_seeds=30, seed=s % 2)
                     for s in range(T)])
    tabs = [tct.frame_cellinfo(torch.from_numpy(l), capacity=40) for l in labs]
    cy = np.stack([t.cy.numpy() for t in tabs])
    cx = np.stack([t.cx.numpy() for t in tabs])
    mask = np.stack([t.exists().numpy() for t in tabs])
    drifts = np.random.default_rng(10).normal(0, 1.0, (T, 2))
    valid = np.ones(T, bool)
    valid[2] = False
    want = jtr.track_movie_nearest_pixel(labs, cy, cx, mask, drifts=drifts,
                                         frame_valid=valid)
    got = ttr.track_movie_nearest_pixel(labs, cy, cx, mask, drifts=drifts,
                                        frame_valid=valid)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # the TV-L1 flow branch (ops/optical_flow.py) in place of the drifts
    images = labs.astype(np.float32)
    want = jtr.track_movie_nearest_pixel(labs, cy, cx, mask, frame_valid=valid,
                                         images=images, use_flow=True)
    got = ttr.track_movie_nearest_pixel(labs, cy, cx, mask, frame_valid=valid,
                                        images=images, use_flow=True,
                                        device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("type_index", [0, 3, 7, -1, ((1, 2), (0,)), ((), (4,))])
def test_type_bitmask_exact(type_index):
    rng = np.random.default_rng(11)
    ct = rng.integers(0, 256, 300).astype(np.uint8)
    ct[:5] = jct.INVALID_TYPE_INDEX
    want = np.asarray(jct.is_positive_for_type(jnp.asarray(ct), type_index))
    got = tct.is_positive_for_type(torch.from_numpy(ct), type_index)
    np.testing.assert_array_equal(got.numpy(), want)
    if isinstance(type_index, int) and type_index >= 0:
        positive = rng.random(300) < 0.5
        for pos_j, pos_t in ((jnp.asarray(positive), torch.from_numpy(positive)),
                             (True, True), (False, False)):
            want = np.asarray(jct.change_type(jnp.asarray(ct), type_index, pos_j))
            got = tct.change_type(torch.from_numpy(ct), type_index, pos_t)
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), want)


def test_cell_table_empty_capacity_exists():
    _assert_tables_equal(tct.CellTable.empty(10, 5, device="cpu"),
                         jct.CellTable.empty(10, 5))
    lab = make_cell_labels(96, 96, n_seeds=30, seed=2)
    want = jct.frame_cellinfo(jnp.asarray(lab), capacity=48)
    got = tct.frame_cellinfo(torch.from_numpy(lab), capacity=48)
    assert got.capacity == want.capacity == 48
    np.testing.assert_array_equal(got.exists().numpy(), np.asarray(want.exists()))
    assert tct.CELL_INFO_COLUMNS == jct.CELL_INFO_COLUMNS


@pytest.mark.parametrize("capacity", [None, 40, 60])
def test_cell_table_pandas_bridge(capacity):
    pd = pytest.importorskip("pandas")
    lab = make_cell_labels(96, 96, n_seeds=30, seed=2)
    want_table = jct.frame_cellinfo(jnp.asarray(lab), capacity=48)
    df = want_table.to_pandas()
    pd.testing.assert_frame_equal(
        tct.frame_cellinfo(torch.from_numpy(lab), capacity=48).to_pandas(), df)
    want = jct.CellTable.from_pandas(df, capacity=capacity, max_neighbors=8)
    got = tct.CellTable.from_pandas(df, capacity=capacity, max_neighbors=8,
                                    device="cpu")
    for name, arr in _leaves(want).items():
        assert getattr(got, name).numpy().dtype == arr.dtype, name
    _assert_tables_equal(got, want)
