"""Inputs of the auction tests: the cases whose semantics the card's kernel
(``csrc/auction.cu``) must reproduce, and benefits built by
``link_frames``' own cost at the benchmark's cell density.
``test_torch_auction.py`` holds the port's plain loop to the JAX package on
the cases, ``test_torch_auction_cuda.py`` the kernel to the plain loop.
Imports nothing of JAX: the card's machine has none."""

import numpy as np
import torch

from tissue_image_processing_tpu_torch.core import tracking as ttr

NEG = np.float32(-np.inf)


def _war(M, K, value, eps, max_rounds=512):
    """M persons after K objects of one equal benefit: every first bid on
    an object is a tie that the lowest person wins, and the losers'
    evictions escalate their eps."""
    return (np.full((M, K), value, np.float32), np.ones(M, bool),
            np.ones(K, bool), eps, max_rounds, None)


def _random(rng, M, K, p_neg, person=0.9, obj=0.85, scale=100.0):
    ben = (rng.random((M, K)) * scale).astype(np.float32)
    ben[rng.random((M, K)) < p_neg] = NEG
    return ben, rng.random(M) < person, rng.random(K) < obj


def auction_cases() -> dict:
    """name -> (benefit (M, K) float32, person mask, object mask, eps,
    max_rounds, cand_k) as ``auction_assignment`` takes them."""
    rng = np.random.default_rng(24)
    cases = {
        # 78 rounds; one person evicted 25 times, past eps' 10 doublings
        "tied_bids": _war(12, 2, 50.0, 1e-3),
        # 234 rounds, one person evicted 58 times
        "eps_cap": _war(20, 3, 10.0, 1e-4),
        # the same war cut while persons still bid: the 20th round's bids
        # are applied and counted
        "cut_at_max_rounds": _war(12, 2, 50.0, 1e-3, max_rounds=20),
    }
    # integer benefits: equal candidate values within rows and across them
    ben = rng.integers(0, 4, (30, 40)).astype(np.float32)
    ben[rng.random((30, 40)) < 0.5] = NEG
    cases["tied_candidates"] = (ben, np.ones(30, bool), np.ones(40, bool),
                                1e-2, 512, None)
    ben, pm, om = _random(rng, 40, 60, 0.6)
    ben[::3] = NEG                       # every third person may take nothing
    cases["neg_inf_rows"] = (ben, pm, om, 1e-2, 512, None)
    cases["masks"] = (*_random(rng, 60, 90, 0.7, person=0.6, obj=0.5), 1e-2,
                      512, None)
    cases["k_below_8"] = (*_random(rng, 7, 3, 0.2), 1e-3, 512, None)
    cases["one_object"] = (*_random(rng, 5, 1, 0.0, 1.0, 1.0), 1e-3, 512,
                           None)
    cases["three_candidates"] = (*_random(rng, 50, 70, 0.3), 1e-3, 512, 3)
    ben, pm, om = _random(rng, 20, 30, 0.3)
    cases["empty_track_set"] = (ben, pm, np.zeros(30, bool), 1e-3, 512, None)
    cases["no_persons"] = (ben, np.zeros(20, bool), om, 1e-3, 512, None)
    ben, pm, om, eps = link_benefit(7, 160, 320, 120, side=450.0)
    cases["link_cost"] = (ben.numpy(), pm.numpy(), om.numpy(), eps, 512, None)
    return cases


def _frame(rng, base, rows_total, shift, jitter):
    n = base.shape[0]
    pos = np.zeros((rows_total, 2), np.float32)
    area = np.zeros(rows_total, np.float32)
    mask = np.zeros(rows_total, bool)
    rows = rng.permutation(rows_total)[:n]
    pos[rows] = base + rng.normal(0, jitter, (n, 2)) + shift
    area[rows] = rng.normal(1500.0, 300.0, n)
    mask[rows] = True
    return pos, area, mask


def link_benefit(seed, M, K, cells, side=2000.0, jitter=6.0,
                 search_range=100.0, eps_factor=1e-5, device="cpu"):
    """One frame's ~``cells`` cells on random rows of M persons against the
    previous frame's on random rows of K tracks, each moved by ``jitter``
    px (standard deviation), scored and gated by ``link_frames``' cost on
    ``device``: (benefit (M, K) float32, person mask, object mask) tensors
    and eps (numpy float32). With seed 7 at 2000 px, 4096 x 8192 with
    2,200 cells takes 30 rounds and 8192 x 16384 with 3,900 cells 59 (the
    benchmark's cells 23-48)."""
    rng = np.random.default_rng(seed)
    base = rng.random((cells, 2)) * side
    ppos, parea, pmask = _frame(rng, base[:cells - int(rng.integers(0, 60))],
                                K, 0.0, jitter)
    cpos, carea, cmask = _frame(rng, base[:cells - int(rng.integers(0, 60))],
                                M, np.array([1.5, -1.0]), jitter)
    ppos, parea, pmask, cpos, carea, cmask = (
        torch.from_numpy(a).to(device)
        for a in (ppos, parea, pmask, cpos, carea, cmask))
    cost2 = ttr._tracking_cost2(ppos, torch.sqrt(torch.clamp(parea, min=0.0)),
                                cpos, torch.sqrt(torch.clamp(carea, min=0.0)),
                                0.5)
    sr = torch.tensor(search_range, dtype=torch.float32)
    sr2 = sr * sr
    benefit = torch.where(cost2 < sr2.to(device), sr2.to(device) - cost2,
                          torch.full_like(cost2, float("-inf")))
    eps = torch.tensor(eps_factor, dtype=torch.float32) * sr2
    return benefit, cmask, pmask, np.float32(eps)
