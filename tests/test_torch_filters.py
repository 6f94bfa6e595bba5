"""PyTorch port vs the JAX package: threshold, morphology, Gaussian blur,
band-pass filter.

Inputs come from a numpy seed and go through both functions. Threshold and
morphology (rectangular and plus-shaped max / min filters) are exact (max /
min only). The blur is held to the JAX blur-kernel
test's tolerance (rtol 2e-6, atol 1e-4): both sides sum the same taps in the
same order, but XLA on the CPU fuses each multiply-add, so bit equality
cannot be asked. The CUDA kernel itself equals its plain version bit for bit
on the card (``cuda`` marker) and in ``chip_smoke.py``: both issue each
multiply and add on its own, in the same order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tissue_image_processing_tpu.ops import morphology as jmorph
from tissue_image_processing_tpu.ops.filters import band_pass_filter as j_band_pass
from tissue_image_processing_tpu.ops.filters import gaussian_blur as j_blur
from tissue_image_processing_tpu.ops.local_threshold import (
    threshold_local_max as j_thr)
from tissue_image_processing_tpu_torch.ops import blur_cuda
from tissue_image_processing_tpu_torch.ops import morphology as tmorph
from tissue_image_processing_tpu_torch.ops.filters import (
    band_pass_filter as t_band_pass, gaussian_blur as t_blur,
    gaussian_kernel1d)
from tissue_image_processing_tpu_torch.ops.local_threshold import (
    threshold_local_max as t_thr)

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,std", [((128, 128), 3.0), ((96, 80), 2.0),
                                       ((6, 64, 128), (0.5, 1.0, 1.0)),
                                       ((3, 40, 52), (0.0, 3.0, 3.0))])
def test_gaussian_blur_matches_jax(shape, std):
    x = (np.random.default_rng(0).random(shape) * 60000).astype(np.float32)
    want = np.asarray(j_blur(jnp.asarray(x), std))
    got = t_blur(torch.from_numpy(x), std).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-4)


def test_gaussian_kernel_matches_jax():
    from tissue_image_processing_tpu.ops.filters import gaussian_kernel1d as jk
    for sigma in (0.5, 1.0, 3.0):
        np.testing.assert_allclose(gaussian_kernel1d(sigma),
                                   np.asarray(jk(sigma)), rtol=1e-6)


def test_blur3d_rejects_bad_input():
    with pytest.raises(ValueError):
        blur_cuda.blur3d(torch.zeros(4, 4), (1.0,), (1.0,), (1.0,))


@pytest.mark.parametrize("block", [31, 101, 30])
def test_threshold_local_max_exact(block):
    x = np.random.default_rng(1).random((2, 128, 112)).astype(np.float32)
    want = np.asarray(j_thr(jnp.asarray(x), block))
    got = t_thr(torch.from_numpy(x), block).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dy,dx", [(1, 0), (-1, 0), (0, 2), (-3, -1), (0, 0)])
def test_shift2d_exact(dy, dx):
    x = np.random.default_rng(2).integers(0, 50, (9, 11)).astype(np.int32)
    want = np.asarray(jmorph.shift2d(jnp.asarray(x), dy, dx, -7))
    got = tmorph.shift2d(torch.from_numpy(x), dy, dx, -7).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [3, 5, (3, 7)])
def test_max_filter_exact(size):
    x = np.random.default_rng(3).integers(0, 90, (33, 29)).astype(np.int32)
    np.testing.assert_array_equal(
        tmorph.maximum_filter(torch.from_numpy(x), size).numpy(),
        np.asarray(jmorph.maximum_filter(jnp.asarray(x), size)))


@pytest.mark.parametrize("fn,args", [
    ("maximum_filter", (5, "constant", 7)),
    ("minimum_filter", (3,)),
    ("minimum_filter", ((3, 7), "constant", 40)),
    ("plus_maximum_filter", ()),
    ("plus_maximum_filter", (99,)),
    ("plus_minimum_filter", ()),
    ("plus_minimum_filter", (99,)),
])
def test_min_max_and_plus_filters_exact(fn, args):
    x = np.random.default_rng(5).integers(0, 90, (2, 33, 29)).astype(np.int32)
    np.testing.assert_array_equal(
        getattr(tmorph, fn)(torch.from_numpy(x), *args).numpy(),
        np.asarray(getattr(jmorph, fn)(jnp.asarray(x), *args)))


@pytest.mark.parametrize("fn", ["maximum_filter", "minimum_filter"])
def test_filters_refuse_other_modes(fn):
    with pytest.raises(NotImplementedError):
        getattr(tmorph, fn)(torch.zeros(4, 4), 3, mode="reflect")


@pytest.mark.parametrize("shape,low,high", [((96, 80), 1.0, 4.0),
                                            ((64, 72), 0.5, 2.0),
                                            ((3, 40, 52), 1.0, 3.0)])
def test_band_pass_filter_matches_jax(shape, low, high):
    """Two blurs of values in [0, 1) and their difference: each blur is
    within two float32 steps of the JAX one (the blur's own tolerance class,
    XLA fusing the multiply-adds), so the difference is held to 1e-6."""
    x = np.random.default_rng(6).random(shape).astype(np.float32)
    want = np.asarray(j_band_pass(jnp.asarray(x), low, high))
    got = t_band_pass(torch.from_numpy(x), low, high).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_blur3d_kernel_matches_plain(cuda_device):
    x = torch.from_numpy((np.random.default_rng(4).random((1, 256, 320)) * 6e4)
                         .astype(np.float32)).to(cuda_device)
    taps = gaussian_kernel1d(3.0)
    got = blur_cuda.blur3d(x, (1.0,), taps, taps)
    want = blur_cuda.blur3d_plain(x, (1.0,), taps, taps)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.fixture
def pallas_blur(monkeypatch):
    """The JAX package's ``blur_pallas`` module with its Pallas kernel
    interpreted on the CPU; its function cache is cleared before and after,
    so no interpreted program outlives the test."""
    import tissue_image_processing_tpu.ops.blur_pallas as BP

    orig_call = BP.pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    BP._blur3d_fn.cache_clear()
    monkeypatch.setattr(BP.pl, "pallas_call", interp_call)
    yield BP
    BP._blur3d_fn.cache_clear()


@pytest.mark.parametrize("shape,taps", [((2, 64, 128), (1, 25, 25)),
                                        ((6, 32, 128), (5, 1, 1)),
                                        ((6, 32, 128), (5, 9, 9)),
                                        ((6, 32, 128), (9, 17, 17))],
                         ids=["watershed_pre_blur", "score_z_blur",
                              "driver_pre_blur", "driver_mask_blur"])
def test_blur3d_plain_matches_pallas(pallas_blur, shape, taps):
    """The plain version against the Pallas kernel itself, at the two
    main-path tap sets and the unfused projection's two (the walk form's;
    the JAX package's blur-kernel tolerance)."""
    rng = np.random.default_rng(7)
    x = (rng.random(shape) * 6e4).astype(np.float32)
    sigma = {1: 0.0, 5: 0.5, 9: 1.0, 17: 2.0, 25: 3.0}
    kz, ky, kx = (gaussian_kernel1d(sigma[n]) for n in taps)
    assert tuple(map(len, (kz, ky, kx))) == taps
    assert pallas_blur.blur3d_pallas_supported(shape, taps)
    want = np.asarray(pallas_blur.blur3d_pallas(jnp.asarray(x), kz, ky, kx))
    got = blur_cuda.blur3d_plain(torch.from_numpy(x), kz, ky, kx).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize("taps,form", [
    ((5, 9, 9), "walk"), ((9, 17, 17), "walk"), ((1, 9, 9), "walk"),
    ((1, 17, 17), "generic"), ((5, 17, 17), "generic"), ((9, 9, 9), "generic"),
    ((1, 25, 25), "tile25"), ((5, 25, 25), "tile25"), ((5, 1, 1), "z_only"),
    ((1, 1, 1), "z_only"), ((3, 9, 9), "generic"), ((5, 9, 17), "generic"),
    ((5, 9, 1), "generic"), ((9, 13, 13), "generic"), ((7, 17, 17), "generic"),
    ((1, 33, 1), "generic")])
def test_blur3d_form(taps, form):
    """The form ``blur3d_form`` picks depends on the taps alone, the same at
    every shape (ragged, thinner than the z taps, one plane); the wrapper
    refuses a form that does not take the taps, and ``form="generic"``
    only in place of the walk form."""
    for shape in ((30, 2048, 2048), (40, 2000, 2000), (1, 1024, 1024),
                  (2, 97, 203), (30, 953, 551), (1, 1, 1)):
        assert blur_cuda.blur3d_form(shape, taps) == form, shape
    x = torch.from_numpy(np.random.default_rng(9).random((3, 20, 24))
                         .astype(np.float32))
    kz, ky, kx = (_random_taps(n, np.random.default_rng(n)) for n in taps)
    want = blur_cuda.blur3d_plain(x, kz, ky, kx)
    assert torch.equal(blur_cuda.blur3d(x, kz, ky, kx, form=form), want)
    other = "walk" if form != "walk" else "tile25"
    with pytest.raises(ValueError):
        blur_cuda.blur3d(x, kz, ky, kx, form=other)
    if form == "walk":
        assert torch.equal(blur_cuda.blur3d(x, kz, ky, kx, form="generic"), want)
    elif form != "generic":
        with pytest.raises(ValueError):
            blur_cuda.blur3d(x, kz, ky, kx, form="generic")


def _random_taps(n, rng):
    k = rng.random(n).astype(np.float32) + 0.1
    return tuple(float(v) for v in k / k.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("taps,form", [
    ((1, 25, 25), None), ((5, 1, 1), None), ((3, 33, 1), None),
    ((33, 1, 33), None), ((1, 1, 1), None),
    ((5, 9, 9), None), ((5, 9, 9), "generic"),
    ((9, 17, 17), None), ((9, 17, 17), "generic"),
    ((1, 9, 9), None), ((1, 9, 9), "generic")])
@pytest.mark.parametrize("Y,X", [(97, 203), (100, 260)])
@pytest.mark.parametrize("Z", [1, 2, 30])
def test_blur3d_kernel_matches_plain_on_hard_inputs(cuda_device, Z, Y, X, taps,
                                                    form):
    """Shapes no tile divides (97 x 203 also no 16-byte word), stacks
    thinner than the z taps, every kernel form (the walk form's tap sets
    also forced into the generic tile form): bit for bit."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.random((Z, Y, X)) * 6e4).astype(np.float32)
                         ).to(cuda_device)
    kz, ky, kx = (_random_taps(n, rng) for n in taps)
    got = blur_cuda.blur3d(x, kz, ky, kx, form=form)
    want = blur_cuda.blur3d_plain(x, kz, ky, kx)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(blur_cuda.blur3d(x, kz, ky, kx, form=form), got), \
        "two runs differ"
