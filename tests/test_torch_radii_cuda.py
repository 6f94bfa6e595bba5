"""The adaptive radii's kernels (``csrc/radii.cu``) on the card against the
plain form of the same level sweep and the port's host recursion: equal
radii bit for bit and equal solve counts on tables at the benchmark's cell
density (both capacities, the union-find in shared memory and in device
memory), chunked calls equal to the whole movie, and ``movie_pipeline``
launching the kernels. Imports nothing of JAX: the card's machine has none.
``test_torch_tables_tracking.py`` holds the plain sweep and the recursion on
these same tables to the JAX package's radii."""

import numpy as np
import pytest
import torch

from oracles import radii_tables
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.core import tracking as ttr

# one intra-op thread: the test workers share the cores
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _solves(fn):
    _device.reset_launches()
    out = fn()
    return out, _device.COUNTS["radii_solves"], _device.LAUNCHES["radii_sweep"]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["shared", "device_memory"])
@pytest.mark.parametrize("capacity,cells", [(4096, 2700), (8192, 3900)])
def test_radii_kernel_equals_plain_sweep(cuda_device, monkeypatch, form,
                                         capacity, cells):
    if form == "device_memory":
        monkeypatch.setattr(ttr, "_radii_shared_limit", lambda lib, dev: 0)
    cy, cx, area, mask, drifts = radii_tables(capacity, 4, cells, capacity)
    host = [torch.from_numpy(a) for a in (cy, cx, area, mask)]
    card = [a.to(cuda_device) for a in host]
    want, want_solves, _ = _solves(
        lambda: ttr.adaptive_radii(*host, drifts=drifts))
    got, solves, launches = _solves(lambda: ttr.adaptive_radii(
        *card, drifts=torch.from_numpy(drifts).to(cuda_device)))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got.cpu(), want)
    assert solves == want_solves and launches == 3
    recursion, rec_solves, _ = _solves(lambda: ttr.adaptive_effective_ranges(
        cy, cx, area, mask, drifts=drifts, per_cell=True))
    np.testing.assert_array_equal(want.numpy(), recursion.astype(np.float32))
    assert rec_solves == want_solves


@pytest.mark.cuda
def test_radii_kernel_chunks_carry(cuda_device):
    cy, cx, area, mask, drifts = radii_tables(5, 6, 2700, 4096)
    card = [torch.from_numpy(a).to(cuda_device)
            for a in (cy, cx, area, mask, drifts)]
    whole, solves, _ = _solves(lambda: ttr.adaptive_radii(
        *card[:4], drifts=card[4]))
    _device.reset_launches()
    first, carry = ttr.adaptive_radii(*(a[:4] for a in card[:4]),
                                      drifts=card[4][:4], return_carry=True)
    rest, _ = ttr.adaptive_radii(*(a[4:] for a in card[:4]),
                                 drifts=card[4][4:], carry=carry,
                                 return_carry=True)
    assert torch.equal(torch.cat([first, rest]), whole)
    assert _device.COUNTS["radii_solves"] == solves
    assert _device.LAUNCHES["radii_sweep"] == 6


@pytest.mark.cuda
def test_movie_pipeline_launches_radii_sweep(cuda_device):
    from tissue_image_processing_tpu_torch.core.pipeline import movie_pipeline
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    movie = make_movie(T=3, Z=1, H=256, W=256, seed=1).astype(np.uint16)
    out, solves, launches = _solves(
        lambda: movie_pipeline(movie, capacity=256, device=cuda_device))
    assert launches == 3 and solves > 0
    cpu = movie_pipeline(movie, capacity=256, device="cpu")
    np.testing.assert_array_equal(out["ids"], cpu["ids"])
