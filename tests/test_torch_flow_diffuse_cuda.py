"""The flow check's diffusion kernel (``csrc/flow_diffuse.cu``) on the card
against the plain whole-frame loop (``ops/flows.py:diffuse_plain``) on the
CPU, bit for bit, on the label maps of ``test_torch_flow_diffuse.py``
(Voronoi cells, edges and corners, masks enclosing masks, non-convex and
split masks, one-pixel masks, and a box over a block's shared memory,
which takes the global form); every map in the global form too;
``remove_bad_flow_masks`` on the card against the CPU; and
``movie_pipeline(cellpose=...)`` launching the shared form once a size
class a frame. Imports nothing of JAX: the card's machine has none."""

import pytest
import torch

from test_torch_flow_diffuse import MAPS, label_map
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops import flows as fl

# one intra-op thread: the test workers share the cores
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plan_counts(m: torch.Tensor, dev: torch.device):
    """(shared-form launches, global-form masks) that the card's plan of
    label map ``m`` gives, from the box preparation on the CPU."""
    from tissue_image_processing_tpu_torch.ops import flow_diffuse_cuda as fd

    m = m.cpu()
    N = int(m.max())
    boxes, centre = fl._geometry(m, N)
    _, _, stats = fd.box_plan(m.shape, boxes, centre,
                              fd._shared_px(fd._lib(), dev))
    top = (max(m.shape) - 1).bit_length()
    return int((stats[:top + 1] > 0).sum()), int(stats[top + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MAPS))
def test_kernel_equals_plain(cuda_device, name):
    m = label_map(name)
    N = int(m.max())
    _device.reset_launches()
    got, n_iter = fl.diffusion(m.to(cuda_device), N)
    classes, n_global = _plan_counts(m, cuda_device)
    assert _device.LAUNCHES["flow_diffuse"] == classes
    assert _device.COUNTS["qc_masks_global"] == n_global
    assert _device.LAUNCHES["flow_diffuse_global"] == (n_iter if n_global
                                                       else 0)
    assert _device.COUNTS["qc_px_iters"] == int((m > 0).sum()) * n_iter
    want, n_plain = fl.diffusion(m, N)
    assert n_iter == n_plain
    assert got.dtype == torch.float64 and torch.equal(got.cpu(), want)
    if name == "big":
        assert n_global == 1 and classes >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["voronoi", "rings_a", "non_convex",
                                  "pixels"])
def test_global_form_equals_plain(cuda_device, name):
    from tissue_image_processing_tpu_torch.ops import flow_diffuse_cuda as fd

    m = label_map(name)
    N = int(m.max())
    want, _ = fl.diffusion(m, N)
    dm = m.to(cuda_device)
    boxes, centre = fl._geometry(dm, N)
    _device.reset_launches()
    p = fd.plan(dm, boxes, centre, form="global")
    got = fd.run(p)
    assert _device.LAUNCHES["flow_diffuse"] == 0
    assert _device.LAUNCHES["flow_diffuse_global"] == p.n_iter
    assert _device.COUNTS["qc_masks_global"] == N
    assert p.pixels == int((m > 0).sum())
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_remove_bad_flow_masks_on_the_card_equals_the_cpu(cuda_device):
    m = label_map("voronoi")
    N = int(m.max())
    mu, _ = fl.masks_to_flows(m, N)
    g = torch.Generator().manual_seed(5)
    # flows near each mask's own, with a noise level that differs by mask,
    # so that some masks pass the 0.4 threshold and some do not
    level = 1.5 * torch.rand(N + 1, generator=g, dtype=torch.float64)
    noise = torch.randn((2,) + m.shape, generator=g, dtype=torch.float64)
    dP = (5 * (mu + level[m.to(torch.int64)] * noise)).to(torch.float32)
    want = fl.remove_bad_flow_masks(m, dP, N)
    got = fl.remove_bad_flow_masks(m.to(cuda_device), dP.to(cuda_device), N)
    assert torch.equal(got.cpu(), want)
    kept = int(want.unique().numel()) - 1
    assert 0 < kept < N


@pytest.mark.cuda
def test_pipeline_launches_once_a_class_a_frame(cuda_device, monkeypatch):
    from test_torch_cellpose import DIAM, TILE, _calibrate, _movie

    from benchmark.cellpose_weights import cellpose_state
    from benchmark.reference import cellpose as ref
    from tissue_image_processing_tpu_torch.core.pipeline import movie_pipeline
    from tissue_image_processing_tpu_torch.models.cellpose import (
        CellposePredictor)
    from tissue_image_processing_tpu_torch.ops import flow_diffuse_cuda as fd

    cpu = torch.device("cpu")
    state = cellpose_state(21, cpu)
    movie = _movie()
    frames = torch.from_numpy(movie[:1, :, 0].astype("float32"))
    with torch.no_grad():
        first = ref.reference_flows(ref.reference_net(state, cpu), frames,
                                    DIAM, tile=TILE)[0]
    _calibrate(state, first, 0.8, 5.0)
    seen = []
    real = fd.plan

    def spy(masks, *args, **kw):
        seen.append(masks.cpu())
        return real(masks, *args, **kw)

    monkeypatch.setattr(fd, "plan", spy)
    cfg = CellposePredictor({k: v.to(cuda_device) for k, v in state.items()},
                            diameter=DIAM, tile=TILE, batch=2,
                            device=cuda_device).pipeline_config()
    _device.reset_launches()
    movie_pipeline(movie, capacity=256, device=cuda_device, cellpose=cfg)
    assert 0 < len(seen) <= movie.shape[0]
    plans = [_plan_counts(m, cuda_device) for m in seen]
    assert _device.LAUNCHES["flow_diffuse"] == sum(c for c, _ in plans) > 0
    assert _device.LAUNCHES["flow_diffuse_global"] == 0
    assert _device.COUNTS["qc_masks_global"] == 0
