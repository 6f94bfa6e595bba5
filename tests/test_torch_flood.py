"""PyTorch port vs the JAX package: the watershed flood, exactly.

On the SAME float input every piece is bit-exact: regional minima, the
Bellman-Ford flood levels, the connected-component diffusion, the settle
(labels and arrival stamps), ``watershed`` and the row-stacked
``watershed_batch``. The plain PyTorch versions (what CPU tensors run, and
the yardstick of the CUDA kernels) are held against the JAX Pallas kernels
run in interpret mode — as the JAX package's own tests run them on the CPU —
and the whole flood against the JAX XLA sweep path.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage as ndi

from conftest import make_cell_image
from tissue_image_processing_tpu_torch.ops import flood_cuda
from tissue_image_processing_tpu_torch.ops import watershed as tws

jws = importlib.import_module("tissue_image_processing_tpu.ops.watershed")
jfp = importlib.import_module("tissue_image_processing_tpu.ops.flood_pallas")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas flood kernels in interpret mode."""
    orig = jfp.pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jfp.pl, "pallas_call", interp_call)


def _blurred(h=128, w=128, n_seeds=15, seed=9):
    img = make_cell_image(h, w, n_seeds=n_seeds, seed=seed)
    seg = np.where(img < 0.2 * img.max(), 0, img)
    return ndi.gaussian_filter(seg.astype(np.float32), 3.0).astype(np.float32)


def _checkerboard(h=64, w=64):
    """Every other pixel a separate 4-connected minimum: dense ranks up to
    H*W/2 (past the TPU's packed 21-bit label field at large sizes)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy + xx) % 2).astype(np.float32)
    return base + np.float32(0.01) * np.sin(yy * 0.37 + xx * 0.11).astype(np.float32)


IMAGES = {"cells": _blurred, "checkerboard": _checkerboard,
          "cells_small": lambda: _blurred(96, 64, n_seeds=8, seed=3)}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_regional_minima_exact(name):
    img = IMAGES[name]()
    want = np.asarray(jws.regional_minima_labels(jnp.asarray(img),
                                                 use_pallas=False))
    got = tws.regional_minima_labels(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_watershed_exact(name):
    img = IMAGES[name]()
    want = np.asarray(jws.watershed(jnp.asarray(img), use_pallas=False))
    got = tws.watershed(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


def test_watershed_without_lines_exact():
    img = _blurred(64, 96, n_seeds=6, seed=1)
    want = np.asarray(jws.watershed(jnp.asarray(img), watershed_line=False,
                                    use_pallas=False))
    got = tws.watershed(torch.from_numpy(img), watershed_line=False).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [1, 2, 3])
def test_watershed_batch_exact(B):
    imgs = np.stack([_blurred(80, 96, n_seeds=10, seed=s) for s in range(B)])
    want = np.asarray(jws.watershed_batch(jnp.asarray(imgs)))
    got = tws.watershed_batch(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_segmentation_batch_matches_jax():
    """Threshold + blur + stacked flood end to end: labels agree except
    where blur round-off flips a plateau tie (the blur is not bit-exact)."""
    imgs = np.stack([make_cell_image(96, 96, n_seeds=12, seed=s)
                     for s in (4, 5)])
    want = np.asarray(jws.watershed_segmentation_batch(
        jnp.asarray(imgs), 0.2, 3.0, 31))
    got = tws.watershed_segmentation_batch(torch.from_numpy(imgs), 0.2, 3.0,
                                           31).numpy()
    assert (got == want).mean() >= 0.995


def test_bf_flood_plain_matches_pallas(interpret_pallas):
    img = _blurred()
    seeds = tws.regional_minima_labels(torch.from_numpy(img))
    want = np.asarray(jfp.bf_flood_pallas.__wrapped__(
        jnp.asarray(img), jnp.asarray(seeds.numpy())))
    got = flood_cuda.bf_flood_plain(torch.from_numpy(img), seeds).numpy()
    np.testing.assert_array_equal(got, want)


def test_cc_diffusion_plain_matches_pallas(interpret_pallas):
    img = _blurred()
    cand, init = tws.minima_candidates(torch.from_numpy(img))
    want = np.asarray(jfp.cc_diffusion_pallas.__wrapped__(
        jnp.asarray(cand.numpy()), init=jnp.asarray(init.numpy())))
    got = flood_cuda.cc_diffusion_plain(cand, init).numpy()
    np.testing.assert_array_equal(got, want)


def test_settle_plain_matches_pallas(interpret_pallas):
    """Labels and arrival stamps; never-settled pixels carry each side's
    own sentinel (2^29 in the Pallas kernels, 2^30 - 1 here)."""
    img = _blurred()
    seeds = tws.regional_minima_labels(torch.from_numpy(img))
    lam = flood_cuda.bf_flood_plain(torch.from_numpy(img), seeds)
    want_l, want_t = jfp.settle_pallas_loop.__wrapped__(
        jnp.asarray(lam.numpy()), jnp.asarray(seeds.numpy()))
    got_l, got_t = flood_cuda.settle_plain(lam, seeds)
    want_l, want_t = np.asarray(want_l), np.asarray(want_t)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    settled = want_l != 0
    np.testing.assert_array_equal(got_t.numpy()[settled], want_t[settled])
    assert (got_t.numpy()[~settled] == flood_cuda.BIG_T).all()


def test_settle_mask_plain_matches_jax():
    lam = _blurred(64, 64, n_seeds=5, seed=2)
    lam[10:20, 5] = np.inf
    want = np.asarray(jfp._settle_mask(jnp.asarray(lam)))
    got = flood_cuda.settle_mask_plain(torch.from_numpy(lam)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("call", [
    lambda img, small: flood_cuda.bf_flood(img, small),
    lambda img, small: flood_cuda.cc_diffusion(img > 0.5, small.to(torch.int32)),
    lambda img, small: flood_cuda.settle(img, small),
], ids=["bf_flood", "cc_diffusion", "settle"])
def test_flood_wrappers_reject_mismatched_shapes(call):
    img = torch.from_numpy(_blurred(64, 64, n_seeds=5, seed=2))
    small = torch.ones(32, 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        call(img, small)


@pytest.mark.cuda
def test_cuda_kernels_raise_on_wrong_dtype(cuda_device):
    with pytest.raises(ValueError):
        flood_cuda.cc_diffusion(torch.ones(64, 64, device=cuda_device))


@pytest.mark.cuda
def test_flood_kernels_match_plain(cuda_device):
    img = torch.from_numpy(np.stack([_blurred(), _blurred(seed=4)]))
    stacked = tws.stack_frames(img).to(cuda_device)
    cand, init = tws.minima_candidates(stacked)
    assert torch.equal(flood_cuda.cc_diffusion(cand, init),
                       flood_cuda.cc_diffusion_plain(cand, init))
    seeds = tws.regional_minima_labels(stacked)
    lam = flood_cuda.bf_flood(stacked, seeds)
    assert torch.equal(lam, flood_cuda.bf_flood_plain(stacked, seeds))
    assert torch.equal(flood_cuda.settle_mask(lam),
                       flood_cuda.settle_mask_plain(lam))
    got_l, got_t = flood_cuda.settle(lam, seeds)
    want_l, want_t = flood_cuda.settle_plain(lam, seeds)
    assert torch.equal(got_l, want_l) and torch.equal(got_t, want_t)
