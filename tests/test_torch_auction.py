"""The tracker's auction rounds in the port's plain loop against the JAX
package: the semantics that ``csrc/auction.cu`` reproduces on the card
(``test_torch_auction_cuda.py`` holds it to this loop).

On each case of ``auction_cases`` (tied bids, tied candidates, rows with no
candidate, masks, fewer than 8 objects, a run cut at ``max_rounds``, eps
past its cap, an empty track set, ``link_frames``' own cost) the ids equal
``jax auction_assignment``'s, and ``COUNTS["auction_rounds"]`` is the JAX
loop's round count: the JAX ids after one round fewer are already final and
after two rounds fewer are not (the last round that bids assigns a person),
or, for a cut run, the JAX ids one round before the cut differ. Then
``track_movie`` adds each linked frame's rounds through its slots, as a
frame-by-frame ``link_frames`` loop and a chunked run count them.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from auction_cases import auction_cases
from oracles import radii_tables
from tissue_image_processing_tpu.core import tracking as jtr
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.core import tracking as ttr

# one intra-op thread: the test workers share the cores
torch.set_num_threads(1)

CASES = auction_cases()
# cases whose round count is known beforehand
ROUNDS = {"cut_at_max_rounds": 20, "empty_track_set": 1, "no_persons": 1}


def _jax(ben, pm, om, eps, max_rounds, cand_k):
    return np.asarray(jtr.auction_assignment(
        jnp.asarray(ben), jnp.asarray(pm), jnp.asarray(om), eps=eps,
        max_rounds=max_rounds, cand_k=cand_k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_auction_loop_equals_jax(name):
    ben, pm, om, eps, max_rounds, cand_k = CASES[name]
    _device.reset_launches()
    got = ttr.auction_assignment(torch.from_numpy(ben), torch.from_numpy(pm),
                                 torch.from_numpy(om), eps=eps,
                                 max_rounds=max_rounds, cand_k=cand_k).numpy()
    rounds = _device.COUNTS["auction_rounds"]
    want = _jax(ben, pm, om, eps, max_rounds, cand_k)
    np.testing.assert_array_equal(got, want)
    assert rounds == ROUNDS.get(name, rounds) and 1 <= rounds <= max_rounds
    if rounds == max_rounds:
        # bidders remained: the last round changed the ids
        assert not np.array_equal(
            _jax(ben, pm, om, eps, max_rounds - 1, cand_k), want)
        return
    np.testing.assert_array_equal(
        _jax(ben, pm, om, eps, rounds - 1, cand_k), want)
    if rounds >= 2:
        assert not np.array_equal(
            _jax(ben, pm, om, eps, rounds - 2, cand_k), want)


@pytest.mark.parametrize("skip", [(), (2,)])
def test_track_movie_counts_each_frames_rounds(skip):
    """Each linked frame's auction writes its own slot: ``track_movie``
    counts what ``link_frames`` frame by frame counts, with the same ids
    and state, and a chunked run counts the same again."""
    cy, cx, area, mask, _ = (torch.from_numpy(a) for a in
                             radii_tables(3, 5, 70, 96, side=400.0))
    valid = torch.ones(5, dtype=torch.bool)
    valid[list(skip)] = False
    _device.reset_launches()
    ids, state, _ = ttr.track_movie(cy, cx, area, mask, frame_valid=valid,
                                    capacity=192, return_state=True)
    rounds = _device.COUNTS["auction_rounds"]
    assert rounds >= 2 * (5 - len(skip))

    _device.reset_launches()
    loop = ttr.TrackingState.empty(192)
    for t in range(5):
        if not valid[t]:
            loop = dataclasses.replace(loop, age=loop.age + 1)
            continue
        loop, fid = ttr.link_frames(loop, cy[t], cx[t], area[t], mask[t])
        torch.testing.assert_close(ids[t], torch.where(mask[t], fid, 0),
                                   rtol=0, atol=0)
    assert _device.COUNTS["auction_rounds"] == rounds
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(state, f.name), getattr(loop, f.name)), f

    _device.reset_launches()
    head, carry, cum = ttr.track_movie(
        cy[:3], cx[:3], area[:3], mask[:3], frame_valid=valid[:3],
        capacity=192, return_state=True)
    tail = ttr.track_movie(cy[3:], cx[3:], area[3:], mask[3:],
                           frame_valid=valid[3:], capacity=192,
                           init_state=carry, cum_drift_init=cum)
    assert torch.equal(torch.cat([head, tail]), ids)
    assert _device.COUNTS["auction_rounds"] == rounds
