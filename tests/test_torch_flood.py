"""PyTorch port vs the JAX package: the watershed flood, exactly.

On the SAME float input every piece is bit-exact: regional minima, the
Bellman-Ford flood levels, the connected-component diffusion, the settle
(labels and arrival stamps), ``watershed`` and the row-stacked
``watershed_batch``, each also on its ``binary=True, minima_scan=True`` route
(the U-Net post-process's boundary maps), and the segmented-scan component
minimum. The plain PyTorch versions (what CPU tensors run, and
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


def _scan_masks():
    """The masks of the JAX package's scan test (a percolation mask, a binary
    sea, open one-pixel rings) and a one-pixel serpentine, whose single
    component needs an iteration for every few turns."""
    rng = np.random.default_rng(5)
    perc = rng.random((128, 128)) < 0.5
    sea = np.ones((128, 128), bool)
    sea[20:40, :100] = False
    sea[60:110, 30:31] = False
    spiral = np.zeros((128, 128), bool)
    lo, hi = 0, 127
    while lo < hi - 8:
        spiral[lo, lo:hi] = True
        spiral[lo:hi, hi] = True
        spiral[hi, lo + 4:hi] = True
        spiral[lo + 4:hi, lo] = True
        lo, hi = lo + 4, hi - 4
    serpentine = np.zeros((96, 80), bool)
    serpentine[::2] = True
    serpentine[1::4, -1] = True
    serpentine[3::4, 0] = True
    return {"percolation": perc, "sea": sea, "spiral": spiral,
            "serpentine": serpentine}


SCAN_MASKS = _scan_masks()


def _scan_init(shape, poisoned=False):
    """An init below H*W, as the contract of both forms wants; ``poisoned``
    pushes a tenth of the pixels to idx - n as the minima search does."""
    rng = np.random.default_rng(7)
    n = shape[0] * shape[1]
    init = rng.integers(0, n, shape).astype(np.int32)
    if poisoned:
        init = np.where(rng.random(shape) < 0.1, init - n, init).astype(np.int32)
    return init


@pytest.mark.parametrize("name", sorted(SCAN_MASKS))
@pytest.mark.parametrize("poisoned", [False, True], ids=["index", "poisoned"])
def test_cc_scan_plain_matches_sweeps(name, poisoned):
    mask = torch.from_numpy(SCAN_MASKS[name])
    init = torch.from_numpy(_scan_init(mask.shape, poisoned))
    want = flood_cuda.cc_diffusion_plain(mask, init)
    got, iterations = flood_cuda.cc_scan_plain(mask, init,
                                               return_iterations=True)
    assert torch.equal(got, want)
    assert torch.equal(flood_cuda.cc_diffusion(mask, init, scan=True), want)
    if name == "serpentine":  # 48 turns: a scan cannot do it in a few passes
        assert iterations > 8


def test_cc_scan_default_init_is_first_raster_pixel():
    mask = torch.from_numpy(SCAN_MASKS["sea"])
    got = flood_cuda.cc_scan(mask)
    assert torch.equal(got, flood_cuda.cc_diffusion_plain(mask))
    assert int(got[0, 0]) == 0 and int(got[25, 5]) == -1


@pytest.mark.parametrize("name", ["percolation", "sea", "spiral"])
def test_cc_scan_plain_matches_pallas(interpret_pallas, name):
    mask = SCAN_MASKS[name]
    init = _scan_init(mask.shape)
    want = np.asarray(jfp.cc_diffusion_pallas.__wrapped__(
        jnp.asarray(mask), init=jnp.asarray(init), scan=True))
    got = flood_cuda.cc_scan_plain(torch.from_numpy(mask),
                                   torch.from_numpy(init)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cc_connectivity_matches_jax_packing():
    mask = SCAN_MASKS["percolation"]
    m = mask.astype(np.int32)
    conn_h = np.pad(m[:, 1:] & m[:, :-1], ((0, 0), (1, 0)))
    conn_v = np.pad(m[1:] & m[:-1], ((1, 0), (0, 0)))
    got = flood_cuda.cc_connectivity(torch.from_numpy(mask))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), conn_h | (conn_v << 1))


def _boundary_maps(B=3, h=96, w=80, seed=11):
    """{0, 1} boundary maps like the U-Net post-process makes: rims of
    random square cells, dilated."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, h, w), np.float32)
    for b in range(B):
        hc = np.zeros((h, w), bool)
        for y, x in rng.integers(6, min(h, w) - 22, (7, 2)):
            hc[y:y + 14, x:x + 14] = True
        rim = hc & ~ndi.binary_erosion(hc, np.ones((7, 7)), border_value=1)
        out[b] = ndi.binary_dilation(rim, np.ones((5, 5)))
    return out


def test_binary_minima_exact():
    img = _boundary_maps(1)[0]
    want = np.asarray(jws.regional_minima_labels(
        jnp.asarray(img), use_pallas=False, binary=True))
    for scan in (False, True):
        got = tws.regional_minima_labels(torch.from_numpy(img), scan=scan,
                                         binary=True).numpy()
        np.testing.assert_array_equal(got, want)
    # on a {0, c} map the binary route finds the general route's minima
    np.testing.assert_array_equal(
        tws.regional_minima_labels(torch.from_numpy(img)).numpy(), want)


def test_binary_minima_pallas_scan_exact(interpret_pallas):
    img = _boundary_maps(1, 64, 128)[0]
    want = np.asarray(jws.regional_minima_labels.__wrapped__(
        jnp.asarray(img), use_pallas=True, scan=True, binary=True))
    got = tws.regional_minima_labels(torch.from_numpy(img), scan=True,
                                     binary=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lines", [True, False], ids=["lines", "filled"])
def test_binary_watershed_exact(lines):
    img = _boundary_maps(1)[0]
    want = np.asarray(jws.watershed(jnp.asarray(img), watershed_line=lines,
                                    minima_scan=True, binary=True))
    got = tws.watershed(torch.from_numpy(img), watershed_line=lines,
                        minima_scan=True, binary=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 5


def test_binary_watershed_with_markers_runs_the_flood():
    """User markers on a binary map still need the Bellman-Ford levels."""
    img = _boundary_maps(1)[0]
    markers = np.zeros(img.shape, np.int32)
    markers[2, 2], markers[50, 40] = 1, 2
    want = np.asarray(jws.watershed(jnp.asarray(img), jnp.asarray(markers),
                                    binary=True))
    got = tws.watershed(torch.from_numpy(img), torch.from_numpy(markers),
                        binary=True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("zero_free", [None, 1], ids=["plain", "zero_free_frame"])
def test_binary_watershed_batch_exact(zero_free):
    """The stacked binary flood against JAX and against the per-frame flood;
    a frame with no zero at all (all boundary) is one regional minimum and
    must not disturb its neighbours in the stack."""
    imgs = _boundary_maps(3)
    if zero_free is not None:
        imgs[zero_free] = 1.0
    want = np.asarray(jws.watershed_batch(jnp.asarray(imgs), binary=True,
                                          minima_scan=True))
    got = tws.watershed_batch(torch.from_numpy(imgs), binary=True,
                              minima_scan=True).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        one = tws.watershed(torch.from_numpy(imgs[b]), binary=True,
                            minima_scan=True).numpy()
        np.testing.assert_array_equal(got[b], one)
    if zero_free is not None:
        assert (got[zero_free] == 1).all()


@pytest.mark.parametrize("call", [
    lambda img, small: flood_cuda.bf_flood(img, small),
    lambda img, small: flood_cuda.cc_diffusion(img > 0.5, small.to(torch.int32)),
    lambda img, small: flood_cuda.settle(img, small),
    lambda img, small: flood_cuda.cc_scan(img > 0.5, small.to(torch.int32)),
], ids=["bf_flood", "cc_diffusion", "settle", "cc_scan"])
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCAN_MASKS))
def test_cc_scan_kernel_matches_plain(cuda_device, name):
    mask = torch.from_numpy(SCAN_MASKS[name]).to(cuda_device)
    for poisoned in (False, True):
        init = torch.from_numpy(_scan_init(mask.shape, poisoned)).to(cuda_device)
        got = flood_cuda.cc_scan(mask, init)
        assert torch.equal(got, flood_cuda.cc_scan_plain(mask, init))
        assert torch.equal(got, flood_cuda.cc_diffusion(mask, init))


@pytest.mark.cuda
def test_cc_scan_kernel_raises_on_wrong_dtype(cuda_device):
    with pytest.raises(ValueError):
        flood_cuda.cc_scan(torch.ones(64, 64, device=cuda_device))


@pytest.mark.cuda
def test_binary_watershed_batch_on_card_matches_cpu(cuda_device):
    imgs = torch.from_numpy(_boundary_maps(3))
    want = tws.watershed_batch(imgs, binary=True, minima_scan=True)
    got = tws.watershed_batch(imgs.to(cuda_device), binary=True,
                              minima_scan=True)
    assert torch.equal(got.cpu(), want)
