"""Cellpose's flow-following kernel (``csrc/follow_flows.cu``) on the card
against its plain version (``ops/flows.py:follow_plain``), bit for bit: on
random fields of several shapes and batches (steps that leave the frame
and clamp, pixels that do not move), on a converging field, with 0 and 200
steps; and ``movie_pipeline(cellpose=...)`` launching it once a group of
frames. Imports nothing of JAX: the card's machine has none."""

import numpy as np
import pytest
import torch

from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops.flows import follow_plain

# one intra-op thread: the test workers share the cores
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _field(B, Y, X, scale, seed):
    g = torch.Generator().manual_seed(seed)
    d = scale * torch.randn((B, 2, Y, X), generator=g)
    d[:, 0][torch.rand((B, Y, X), generator=g) < 0.1] = 0.0   # not followed
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("B,Y,X,scale,steps", [
    (1, 64, 64, 0.5, 200), (2, 37, 91, 3.0, 200), (3, 128, 17, 1.0, 50),
    (1, 1, 33, 2.0, 20), (2, 50, 50, 1.0, 0)])
def test_follow_kernel_equals_plain(cuda_device, B, Y, X, scale, steps):
    from tissue_image_processing_tpu_torch.ops.flows_cuda import follow_cuda

    d = _field(B, Y, X, scale, seed=Y * X + B)
    _device.reset_launches()
    got = follow_cuda(d.to(cuda_device), steps)
    assert _device.LAUNCHES["follow_flows"] == 1
    want = follow_plain(d, steps)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(follow_plain(d.to(cuda_device), steps).cpu(), want)


@pytest.mark.cuda
def test_follow_kernel_on_a_converging_field(cuda_device):
    from tissue_image_processing_tpu_torch.ops.flows_cuda import follow_cuda

    yy, xx = torch.meshgrid(torch.arange(96.0), torch.arange(80.0),
                            indexing="ij")
    d = torch.stack([(30.3 - yy) / 40, (50.7 - xx) / 40])[None]
    got = follow_cuda(d.to(cuda_device), 200).cpu()
    assert torch.equal(got, follow_plain(d, 200))
    assert (got[0, 0] - 30.3).abs().max() < 1.0


@pytest.mark.cuda
def test_pipeline_launches_the_kernel_once_a_group(cuda_device):
    from benchmark.cellpose_weights import cellpose_state
    from tissue_image_processing_tpu_torch.core.pipeline import movie_pipeline
    from tissue_image_processing_tpu_torch.models.cellpose import (
        CellposePredictor)

    rng = np.random.default_rng(0)
    movie = (1000 * rng.random((4, 2, 1, 96, 96))).astype(np.uint16)
    cfg = CellposePredictor(cellpose_state(21, cuda_device), diameter=30.0,
                            batch=2, device=cuda_device).pipeline_config()
    _device.reset_launches()
    movie_pipeline(movie, capacity=256, device=cuda_device, cellpose=cfg)
    assert _device.LAUNCHES["follow_flows"] == 2
    assert _device.COUNTS["cp_tiles"] == 4
