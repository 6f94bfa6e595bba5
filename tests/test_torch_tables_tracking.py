"""PyTorch port vs the JAX package: cell tables, drift and tracking.

On the same labels the cell tables (including the compacted-adjacency
overflow flag and the exact-scatter path) are bit-identical. The auction and
``track_movie`` are exact on the same inputs, including a resume from a
JAX-produced carry converted with ``utils/state.py``; drifts are quantised
to 1/64 px so running sums are exact in any summation order. Phase
correlation and the drift chain agree to 1e-4 px.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_cell_labels
from tissue_image_processing_tpu.core import cell_table as jct
from tissue_image_processing_tpu.core import tracking as jtr
from tissue_image_processing_tpu.ops.drift import (
    phase_cross_correlation as j_pcc)
from tissue_image_processing_tpu_torch.core import cell_table as tct
from tissue_image_processing_tpu_torch.core import tracking as ttr
from tissue_image_processing_tpu_torch.ops.drift import (
    phase_cross_correlation as t_pcc)
from tissue_image_processing_tpu_torch.ops.neighbors import adjacency_overflow
from tissue_image_processing_tpu_torch.utils.state import (
    cell_table_from_numpy, tracking_state_from_numpy)

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


def test_phase_correlation_and_drift_chain():
    rng = np.random.default_rng(8)
    base = rng.random((96, 128)).astype(np.float32)
    from scipy import ndimage as ndi
    base = ndi.gaussian_filter(base, 2.0)
    frames = np.stack([ndi.shift(base, (0.37 * i, -0.61 * i), mode="wrap")
                       for i in range(4)]).astype(np.float32)
    want = np.asarray(j_pcc(jnp.asarray(frames[0]), jnp.asarray(frames[2]),
                            upsample_factor=100))
    got = t_pcc(torch.from_numpy(frames[0]), torch.from_numpy(frames[2]),
                upsample_factor=100).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    want = np.asarray(jtr.compute_drift_chain(jnp.asarray(frames)))
    got = ttr.compute_drift_chain(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
