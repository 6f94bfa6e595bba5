"""PyTorch port vs the JAX package: threshold, morphology, Gaussian blur.

Inputs come from a numpy seed and go through both functions. Threshold and
morphology are exact (max/min only). The blur is held to the JAX blur-kernel
test's tolerance (rtol 2e-6, atol 1e-4): both sides sum the same taps in the
same order, but XLA on the CPU fuses each multiply-add, so bit equality
cannot be asked. The CUDA kernel itself is checked against its plain version
on the card (``cuda`` marker) and by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tissue_image_processing_tpu.ops import morphology as jmorph
from tissue_image_processing_tpu.ops.filters import gaussian_blur as j_blur
from tissue_image_processing_tpu.ops.local_threshold import (
    threshold_local_max as j_thr)
from tissue_image_processing_tpu_torch.ops import blur_cuda
from tissue_image_processing_tpu_torch.ops import morphology as tmorph
from tissue_image_processing_tpu_torch.ops.filters import (
    gaussian_blur as t_blur, gaussian_kernel1d)
from tissue_image_processing_tpu_torch.ops.local_threshold import (
    threshold_local_max as t_thr)


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


@pytest.mark.cuda
def test_blur3d_kernel_matches_plain(cuda_device):
    x = torch.from_numpy((np.random.default_rng(4).random((1, 256, 320)) * 6e4)
                         .astype(np.float32)).to(cuda_device)
    taps = gaussian_kernel1d(3.0)
    got = blur_cuda.blur3d(x, (1.0,), taps, taps)
    want = blur_cuda.blur3d_plain(x, (1.0,), taps, taps)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-4)
