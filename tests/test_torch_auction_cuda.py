"""The tracker's auction kernel (``csrc/auction.cu``) on the card against the
port's plain loop run on the same card tensors: equal ids and round counts
on every case of ``auction_cases`` and at the benchmark's two shapes
(persons x tracks 4096 x 8192, the state in shared memory, and 8192 x
16384, in device memory), each case in both forms; one launch and no host
synchronisation for all the rounds of a call; ``track_movie`` over T = 8
frames equal to the loop's in ids, final state and cumulative drift, with
one auction launch a frame; a chunked call equal to the whole movie.
Imports nothing of JAX: the card's machine has none.
``test_torch_auction.py`` holds the plain loop to the JAX package."""

import dataclasses

import pytest
import torch

from auction_cases import auction_cases, link_benefit
from oracles import radii_tables
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.core import tracking as ttr

# one intra-op thread: the test workers share the cores
torch.set_num_threads(1)

CASES = auction_cases()
# the benchmark's shapes: (persons, tracks, cells) of the watershed and
# Cellpose cells and of the U-Net cell
SHAPES = {"4096x8192": (4096, 8192, 2200), "8192x16384": (8192, 16384, 3900)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _loop_on_card(b, cand, person_mask, eps, K, max_rounds, rounds):
    """``_rounds_card``'s contract met by the plain loop."""
    person_obj, n = ttr._rounds_plain(b, cand, person_mask, eps, K, max_rounds)
    rounds.fill_(n)
    return person_obj


def _inputs(name, dev):
    if name in SHAPES:
        M, K, cells = SHAPES[name]
        return (*link_benefit(24, M, K, cells, device=dev), 256, 8)
    ben, pm, om, eps, max_rounds, cand_k = CASES[name]
    ben, pm, om = (torch.from_numpy(x).to(dev) for x in (ben, pm, om))
    return ben, pm, om, eps, max_rounds, cand_k


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["shared", "device_memory"])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(SHAPES))
def test_auction_kernel_equals_loop(cuda_device, monkeypatch, form, name):
    if form == "device_memory":
        monkeypatch.setattr(ttr, "_auction_shared_limit", lambda lib, dev: 0)
    ben, pm, om, eps, max_rounds, cand_k = _inputs(name, cuda_device)
    K = ben.shape[1]
    b, cand = ttr._candidates(ben, pm, om, min(cand_k or 8, K))
    eps_t = torch.as_tensor(eps, dtype=torch.float32, device=cuda_device)
    want, want_rounds = ttr._rounds_plain(b, cand, pm, eps_t, K, max_rounds)
    _device.reset_launches()
    rounds = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ttr._rounds_card(b, cand, pm, eps_t, K, max_rounds, rounds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    assert int(rounds) == want_rounds
    assert _device.LAUNCHES["auction"] == 1
    assert _device.COUNTS["auction_card"] == 1
    on_global = form == "device_memory" or name == "8192x16384"
    assert _device.COUNTS["auction_global"] == int(on_global)
    # the public call: the same ids, its rounds counted with one read
    _device.reset_launches()
    public = ttr.auction_assignment(ben, pm, om, eps=eps,
                                    max_rounds=max_rounds, cand_k=cand_k)
    assert torch.equal(public, want)
    assert _device.COUNTS["auction_rounds"] == want_rounds


def _movie(capacity, cells, dev):
    cy, cx, area, mask, drifts = radii_tables(8, 8, cells, capacity)
    return [torch.from_numpy(a).to(dev) for a in (cy, cx, area, mask,
                                                  drifts)]


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,cells", [(4096, 2700), (8192, 3900)])
def test_track_movie_kernel_equals_loop(cuda_device, monkeypatch, capacity,
                                        cells):
    cy, cx, area, mask, drifts = _movie(capacity, cells, cuda_device)
    ranges = ttr.adaptive_radii(cy, cx, area, mask, drifts=drifts.double())
    kw = dict(drifts=drifts, capacity=2 * capacity, search_ranges=ranges,
              return_state=True)
    _device.reset_launches()
    ids, state, cum = ttr.track_movie(cy, cx, area, mask, **kw)
    counts = dict(_device.COUNTS)
    assert _device.LAUNCHES["auction"] == 8
    assert counts["auction_card"] == 8
    # 176 KB of state fit the H100's 227 KB of shared memory, 352 KB do not
    assert counts.get("auction_global", 0) == (0 if capacity == 4096 else 8)

    monkeypatch.setattr(ttr, "_rounds_card", _loop_on_card)
    _device.reset_launches()
    ids_l, state_l, cum_l = ttr.track_movie(cy, cx, area, mask, **kw)
    assert _device.LAUNCHES["auction"] == 0
    assert torch.equal(ids, ids_l) and torch.equal(cum, cum_l)
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(state, f.name), getattr(state_l, f.name)), f
    assert _device.COUNTS["auction_rounds"] == counts["auction_rounds"] > 8


@pytest.mark.cuda
def test_track_movie_kernel_chunks_carry(cuda_device):
    cy, cx, area, mask, drifts = _movie(4096, 2700, cuda_device)
    _device.reset_launches()
    whole = ttr.track_movie(cy, cx, area, mask, drifts=drifts, capacity=8192)
    rounds = _device.COUNTS["auction_rounds"]
    _device.reset_launches()
    head, state, cum = ttr.track_movie(
        cy[:3], cx[:3], area[:3], mask[:3], drifts=drifts[:3], capacity=8192,
        return_state=True)
    tail = ttr.track_movie(cy[3:], cx[3:], area[3:], mask[3:],
                           drifts=drifts[3:], capacity=8192,
                           init_state=state, cum_drift_init=cum)
    assert torch.equal(torch.cat([head, tail]), whole)
    assert _device.COUNTS["auction_rounds"] == rounds
    assert _device.LAUNCHES["auction"] == 8
