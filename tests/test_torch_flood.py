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
from tissue_image_processing_tpu_torch.utils.synthetic import (
    coil_mask, settle_cases)

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

# both packages' ``ops`` export a function of this module's name
jws = importlib.import_module("tissue_image_processing_tpu.ops.watershed")
tws = importlib.import_module("tissue_image_processing_tpu_torch.ops.watershed")
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


@pytest.mark.parametrize("seed", [4, 6])
def test_segmentation_one_frame_matches_jax_and_batch(seed):
    """The one-frame form against JAX's (the batch test's criterion: the
    blur is not bit-exact) and, exactly, against frame 0 of the batch form
    on a one-frame batch."""
    img = make_cell_image(96, 112, n_seeds=14, seed=seed)
    want = np.asarray(jws.watershed_segmentation(jnp.asarray(img), 0.2, 2.0, 31))
    got = tws.watershed_segmentation(torch.from_numpy(img), 0.2, 2.0, 31)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).mean() >= 0.995
    batch = tws.watershed_segmentation_batch(torch.from_numpy(img[None]), 0.2,
                                             2.0, 31)
    assert torch.equal(got, batch[0])


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


# The settle's hard cases at the size of the emulation's 8 x 8 tiles; the
# card-marked test below runs the kernel on the same cases at its own 64.
SETTLE_RAGGED = ((1, 1), (1, 70), (70, 1), (7, 9), (31, 65), (65, 31))
SETTLE_CASES = settle_cases(8, SETTLE_RAGGED)


def _tiled_settle(lam, seeds, tile=8, k=3, gate="ring", by_stamp=True,
                  order_seed=0):
    """The schedule of the CUDA settle, emulated tile by tile in torch (no
    main path runs this): rounds of ``k`` Jacobi sweeps on ``tile`` x ``tile``
    tiles loaded with a ``k``-deep halo, the region a sweep may compute
    shrinking by one ring a sweep; a tile's settled pixels stored at once;
    tiles of a round taken one after the other in a random order, so a later
    tile finds its neighbours' stores of the same round in its halo; the
    loader's rule (stamp < the round's first sweep: read the label; BIG_T:
    the seed; else unsettled); the gate (a tile runs iff itself or one of its
    8 neighbours settled something in the last sweep of the round before,
    and not at all once it has no unsettled pixel); the stop (a round whose
    last sweep settled nothing anywhere). ``gate="own"`` (only the tile's own
    last sweep) and ``by_stamp=False`` (the halo read as it stands) are the
    unsound variants. Returns (lbl, t, rounds)."""
    lam, seeds = torch.from_numpy(lam), torch.from_numpy(seeds)
    H, W = lam.shape
    mask = flood_cuda.settle_mask_plain(lam)
    lbl = torch.full((H, W), -77, dtype=torch.int32)  # every pixel is written
    t = torch.full((H, W), -77, dtype=torch.int32)
    ny, nx = -(-H // tile), -(-W // tile)
    E = tile + 2 * k
    rng = np.random.default_rng(order_seed)
    done = np.zeros((ny, nx), bool)
    chg_prev = np.ones((ny, nx), bool)
    rounds = 0
    while True:
        it0 = 1 + rounds * k
        chg_now = np.zeros((ny, nx), bool)
        for tile_id in rng.permutation(ny * nx):
            ty, tx = divmod(int(tile_id), nx)
            if rounds > 0:
                near = chg_prev[max(ty - 1, 0):ty + 2, max(tx - 1, 0):tx + 2]
                go = near.any() if gate == "ring" else chg_prev[ty, tx]
                if done[ty, tx] or not go:
                    continue
            y0, x0 = ty * tile - k, tx * tile - k
            ya, yb = max(y0, 0), min(y0 + E, H)
            xa, xb = max(x0, 0), min(x0 + E, W)
            img = (slice(ya, yb), slice(xa, xb))
            reg = (slice(ya - y0, yb - y0), slice(xa - x0, xb - x0))
            inside = torch.zeros((E, E), dtype=torch.bool)
            inside[reg] = True
            own = torch.zeros((E, E), dtype=torch.bool)
            own[k:k + tile, k:k + tile] = True
            own &= inside
            if rounds == 0:
                v = seeds[img]
            elif by_stamp:
                v = torch.where(t[img] < it0, lbl[img], torch.where(
                    t[img] == flood_cuda.BIG_T, seeds[img], 0))
            else:
                v = lbl[img].clone()
            r_lbl = torch.zeros((E, E), dtype=torch.int32)
            r_lbl[reg] = v
            r_mask = torch.zeros((E, E), dtype=torch.int32)
            r_mask[reg] = mask[img]
            r_t = torch.zeros((E, E), dtype=torch.int32)
            if rounds == 0:
                lbl[img][own[reg]] = seeds[img][own[reg]]
                t[img][own[reg]] = torch.where(
                    seeds[img][own[reg]] > 0, 0, flood_cuda.BIG_T).to(torch.int32)
            last = False
            for j in range(1, k + 1):
                new, can = flood_cuda._settle_step(r_mask, r_lbl)
                valid = torch.zeros((E, E), dtype=torch.bool)
                valid[j:E - j, j:E - j] = True
                can = can & valid & inside
                last = bool(can.any())
                if not last:
                    break
                r_lbl = torch.where(can, new, r_lbl)
                r_t[can] = it0 + j - 1
            stored = own & (r_t > 0)
            lbl[img][stored[reg]] = r_lbl[reg][stored[reg]]
            t[img][stored[reg]] = r_t[reg][stored[reg]]
            chg_now[ty, tx] = last
            done[ty, tx] = not bool((own & (r_lbl == 0)).any())
        rounds += 1
        if not chg_now.any():
            return lbl, t, rounds
        chg_prev = chg_now


@pytest.mark.parametrize("order_seed", [0, 1])
@pytest.mark.parametrize("name", sorted(SETTLE_CASES))
def test_settle_tiled_schedule_matches_plain(name, order_seed):
    """The kernel's schedule (emulated) gives the plain version's labels and
    arrival stamps bit for bit, whatever the order of the tiles in a round."""
    lam, seeds = SETTLE_CASES[name]
    want_l, want_t, sweeps = flood_cuda.settle_plain(
        torch.from_numpy(lam), torch.from_numpy(seeds), return_sweeps=True)
    got_l, got_t, rounds = _tiled_settle(lam, seeds, order_seed=order_seed)
    assert torch.equal(got_l, want_l)
    assert torch.equal(got_t, want_t)
    assert rounds == sweeps // 3 + 1  # k = 3: stops after the first idle last sweep


@pytest.mark.parametrize("tile,k", [(8, 8), (16, 5), (5, 2)])
def test_settle_tiled_schedule_other_tilings(tile, k):
    for name in ("ragged_31x65", "serpentine", "lines_cross_in_corner",
                 "negative_seeds"):
        lam, seeds = SETTLE_CASES[name]
        want = flood_cuda.settle_plain(torch.from_numpy(lam),
                                       torch.from_numpy(seeds))
        got = _tiled_settle(lam, seeds, tile=tile, k=k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


@pytest.mark.parametrize("variant", [dict(gate="own"), dict(by_stamp=False)],
                         ids=["own_tile_gate", "halo_read_in_place"])
def test_settle_tiled_schedule_unsound_variants_differ(variant):
    """The two tempting shortcuts are wrong, and these cases can tell: a
    tile that reruns only when its own last sweep settled something misses a
    front that enters from next door; a halo read as it stands sees pixels a
    neighbour settled later in the same round."""
    differ = []
    for name, (lam, seeds) in sorted(SETTLE_CASES.items()):
        want = flood_cuda.settle_plain(torch.from_numpy(lam),
                                       torch.from_numpy(seeds))
        got = _tiled_settle(lam, seeds, **variant)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            differ.append(name)
    assert differ, "the unsound schedule passed every case"


@pytest.mark.parametrize("name", sorted(SETTLE_CASES))
def test_settle_plain_matches_pallas_on_hard_cases(interpret_pallas, name):
    """The hard cases pinned to the JAX package too. Both sides get the case
    with its rows padded to the Pallas row block (+inf, no seed): the pad is
    part of the input here, since labels can travel through +inf pixels."""
    lam, seeds = SETTLE_CASES[name]
    lam, seeds = _pad_rows(lam, np.inf), _pad_rows(seeds, 0)
    want_l, want_t = jfp.settle_pallas_loop.__wrapped__(
        jnp.asarray(lam), jnp.asarray(seeds))
    want_l, want_t = np.asarray(want_l), np.asarray(want_t)
    got_l, got_t = flood_cuda.settle_plain(torch.from_numpy(lam),
                                           torch.from_numpy(seeds))
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    stamped = got_t.numpy() != flood_cuda.BIG_T
    np.testing.assert_array_equal(got_t.numpy()[stamped], want_t[stamped])
    assert (want_t[~stamped] == 1 << 29).all()


def test_settle_mask_plain_matches_jax():
    lam = _blurred(64, 64, n_seeds=5, seed=2)
    lam[10:20, 5] = np.inf
    want = np.asarray(jfp._settle_mask(jnp.asarray(lam)))
    got = flood_cuda.settle_mask_plain(torch.from_numpy(lam)).numpy()
    np.testing.assert_array_equal(got, want)


MASK_SHAPES = [(1, 1), (1, 1025), (40, 1), (37, 3), (64, 127), (33, 1025),
               (9, 128)]


def _awkward_lam(shape):
    """Flood levels with ties everywhere (four values), +inf pixels and
    whole +inf rows, as the settle mask meets them on stacked frames."""
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    lam = rng.integers(0, 4, shape).astype(np.float32)
    lam[rng.random(shape) < 0.15] = np.inf
    lam[::6] = np.inf
    return lam


@pytest.mark.parametrize("shape", MASK_SHAPES)
def test_settle_mask_plain_matches_jax_awkward_shapes(shape):
    lam = _awkward_lam(shape)
    want = np.asarray(jfp._settle_mask(jnp.asarray(lam)))
    got = flood_cuda.settle_mask_plain(torch.from_numpy(lam)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MASK_SHAPES)
def test_settle_mask_kernel_matches_plain_awkward_shapes(cuda_device, shape):
    lam = torch.from_numpy(_awkward_lam(shape)).to(cuda_device)
    assert torch.equal(flood_cuda.settle_mask(lam),
                       flood_cuda.settle_mask_plain(lam))


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
    masks = {"percolation": perc, "sea": sea, "spiral": spiral,
             "serpentine": serpentine}
    masks.update(_hard_masks())
    return masks


def test_coil_mask_is_one_thin_component():
    for h, w, pitch in ((48, 64, 4), (33, 63, 2), (100, 90, 7)):
        m = coil_mask(h, w, pitch)
        assert ndi.label(m)[1] == 1
        assert not (m[:-1, :-1] & m[1:, :-1] & m[:-1, 1:] & m[1:, 1:]).any()
        assert m.sum() > h * w / (pitch + 1)


def _hard_masks():
    """Masks that are hard for a tiled or iterated component search: a
    one-pixel coil winding to the centre (one component, as long as a
    quarter of the image), a checkerboard (every pixel alone, no link), an
    all-true image (one component over every tile), and percolation masks
    at shapes one below, at and one above the kernels' 32- and 64-pixel
    tiles."""
    coil = coil_mask(48, 64, 4)
    yy, xx = np.mgrid[0:64, 0:64]
    rng = np.random.default_rng(13)
    masks = {"coil": coil, "checker": (yy + xx) % 2 == 0,
             "all_true": np.ones((64, 96), bool)}
    for h, w in ((31, 65), (32, 64), (33, 63), (63, 33), (64, 32), (65, 31)):
        masks[f"ragged_{h}x{w}"] = rng.random((h, w)) < 0.62
    return masks


SCAN_MASKS = _scan_masks()


def _scan_init(shape, poisoned=False, mask=None):
    """An init below H*W, as the contract of both forms wants; ``poisoned``
    pushes a tenth of the pixels to idx - n as the minima search does, and
    ``poisoned="rank"`` is the second diffusion of the minima search: the
    raster-order rank on the first pixel of each component of ``mask``, H*W
    on every other pixel."""
    rng = np.random.default_rng(7)
    n = shape[0] * shape[1]
    if poisoned == "rank":
        lab, _ = ndi.label(mask)
        first = np.zeros(n, bool)
        first[np.unique(lab.ravel(), return_index=True)[1]] = True
        first = first.reshape(shape) & mask
        rank = np.cumsum(first.ravel()).reshape(shape)
        return np.where(first, rank, n).astype(np.int32)
    init = rng.integers(0, n, shape).astype(np.int32)
    if poisoned:
        init = np.where(rng.random(shape) < 0.1, init - n, init).astype(np.int32)
    return init


INIT_KINDS = pytest.mark.parametrize("poisoned", [False, True, "rank"],
                                     ids=["index", "poisoned", "rank"])


def _component_minimum(mask, init):
    """The function itself, by scipy: min of init over each 4-component."""
    lab, k = ndi.label(mask)
    mins = ndi.minimum(init, lab, np.arange(1, k + 1)) if k else np.zeros(0)
    return np.where(mask, np.concatenate([[-1], mins])[lab], -1).astype(np.int32)


@pytest.mark.parametrize("name", sorted(SCAN_MASKS))
@INIT_KINDS
def test_cc_scan_plain_matches_sweeps(name, poisoned):
    mask = torch.from_numpy(SCAN_MASKS[name])
    init = torch.from_numpy(_scan_init(mask.shape, poisoned, SCAN_MASKS[name]))
    want = flood_cuda.cc_diffusion_plain(mask, init)
    got, iterations = flood_cuda.cc_scan_plain(mask, init,
                                               return_iterations=True)
    assert torch.equal(got, want)
    assert torch.equal(flood_cuda.cc_diffusion(mask, init, scan=True), want)
    np.testing.assert_array_equal(
        got.numpy(), _component_minimum(SCAN_MASKS[name], init.numpy()))
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


HARD_MASKS = sorted(_hard_masks())


def _pad_rows(a, fill):
    """Pad the height to a multiple of 64 rows, the Pallas kernels' row
    block (the JAX package's callers pad the same way: +inf rows / rows
    outside the mask never reach a pixel of the image)."""
    return np.pad(a, ((0, -a.shape[0] % 64), (0, 0)), constant_values=fill)


@pytest.mark.parametrize("name", HARD_MASKS)
def test_cc_plain_versions_match_pallas_on_hard_masks(interpret_pallas, name):
    """Both plain versions against both Pallas forms (sweeps and scan) on the
    hard masks, with the poisoned init."""
    mask = SCAN_MASKS[name]
    init = _scan_init(mask.shape, True)
    got = flood_cuda.cc_scan_plain(torch.from_numpy(mask),
                                   torch.from_numpy(init)).numpy()
    np.testing.assert_array_equal(
        got, flood_cuda.cc_diffusion_plain(torch.from_numpy(mask),
                                           torch.from_numpy(init)).numpy())
    for scan in (False, True):
        want = np.asarray(jfp.cc_diffusion_pallas.__wrapped__(
            jnp.asarray(_pad_rows(mask, False)),
            init=jnp.asarray(_pad_rows(init, 0)), scan=scan))
        np.testing.assert_array_equal(got, want[:mask.shape[0]])


def _bf_cases():
    """(img, seeds) for the flood levels: one plateau spanning the image
    with a single seed in a corner (lam is the plateau's level everywhere,
    after as many sweeps as the image is wide and tall), the same with a
    ridge to climb, and cell images at shapes around the 64-pixel tile."""
    flat = np.full((64, 96), 0.25, np.float32)
    one_seed = np.zeros(flat.shape, np.int32)
    one_seed[-1, -1] = 1
    ridge = flat.copy()
    ridge[:, 40:43] = 0.75
    ridge[30:34, 40:43] = 0.5
    cases = {"plateau": (flat, one_seed), "plateau_ridge": (ridge, one_seed)}
    for h, w in ((63, 65), (65, 63)):
        img = _blurred(h, w, n_seeds=6, seed=h)
        cases[f"ragged_{h}x{w}"] = (
            img, tws.regional_minima_labels(torch.from_numpy(img)).numpy())
    return cases


BF_CASES = _bf_cases()


@pytest.mark.parametrize("name", sorted(BF_CASES))
def test_bf_flood_plain_matches_pallas_on_hard_cases(interpret_pallas, name):
    img, seeds = BF_CASES[name]
    want = np.asarray(jfp.bf_flood_pallas.__wrapped__(
        jnp.asarray(_pad_rows(img, np.inf)), jnp.asarray(_pad_rows(seeds, 0))))
    got = flood_cuda.bf_flood_plain(torch.from_numpy(img),
                                    torch.from_numpy(seeds)).numpy()
    np.testing.assert_array_equal(got, want[:img.shape[0]])
    if name == "plateau":
        assert (got == np.float32(0.25)).all()


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


SETTLE_CASES_CARD = settle_cases(64, ((1, 1), (1, 700), (700, 1), (31, 65),
                                      (65, 31), (1001, 931)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SETTLE_CASES_CARD))
def test_settle_kernel_matches_plain_on_hard_cases(cuda_device, name):
    lam, seeds = (torch.from_numpy(a).to(cuda_device)
                  for a in SETTLE_CASES_CARD[name])
    got_l, got_t = flood_cuda.settle(lam, seeds)
    want_l, want_t, sweeps = flood_cuda.settle_plain(lam, seeds,
                                                     return_sweeps=True)
    assert torch.equal(got_l, want_l) and torch.equal(got_t, want_t)
    assert int(flood_cuda._SWEEPS["settle"]) == sweeps
    again = flood_cuda.settle(lam, seeds)  # two runs equal
    assert torch.equal(again[0], got_l) and torch.equal(again[1], got_t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BF_CASES))
def test_bf_flood_kernel_matches_plain_on_hard_cases(cuda_device, name):
    img, seeds = (torch.from_numpy(a).to(cuda_device) for a in BF_CASES[name])
    got = flood_cuda.bf_flood(img, seeds)
    assert torch.equal(got, flood_cuda.bf_flood_plain(img, seeds))
    assert torch.equal(got, flood_cuda.bf_flood(img, seeds))  # two runs equal


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCAN_MASKS))
def test_cc_scan_kernel_matches_plain(cuda_device, name):
    """The union-find kernel and the relaxation kernel against the plain
    scan, each other and a second run, for every init kind and the default
    (null) init."""
    mask = torch.from_numpy(SCAN_MASKS[name]).to(cuda_device)
    for poisoned in (False, True, "rank"):
        init = torch.from_numpy(_scan_init(mask.shape, poisoned,
                                           SCAN_MASKS[name])).to(cuda_device)
        got = flood_cuda.cc_scan(mask, init)
        assert torch.equal(got, flood_cuda.cc_scan_plain(mask, init))
        assert torch.equal(got, flood_cuda.cc_diffusion(mask, init))
        assert torch.equal(got, flood_cuda.cc_scan(mask, init))
        assert torch.equal(got, flood_cuda.cc_diffusion(mask, init))
    want = flood_cuda.cc_scan_plain(mask)
    assert torch.equal(flood_cuda.cc_scan(mask), want)
    assert torch.equal(flood_cuda.cc_diffusion(mask), want)


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
