"""Percentiles on the device, with numpy's linear interpolation.

Frozen copy of the plain code of the port's ``ops/percentile.py`` (``percentile``,
``masked_percentile`` and ``segment_percentile``) with its size rules: a sort below
``_BISECT_MIN_SIZE`` elements, the exact order statistic by integer bisection
at or above it, and above ``_EXACT_SORT_LIMIT`` elements a subsample of whole
minor-axis rows (or single elements for narrow arrays) with stride
``ceil(n / _EXACT_SORT_LIMIT)``. Both methods return the exact k-th value, so
the results equal the JAX package's. The result stays a 0-d tensor on the
input's device: nothing here reads it on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.numerics import fma_f32

__all__ = ["percentile", "masked_percentile"]

# the JAX package's size rules (ops/percentile.py there)
_EXACT_SORT_LIMIT = 1 << 22
_BISECT_MIN_SIZE = 1 << 18
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _q_frac(q) -> float:
    """q / 100 rounded to float32, as the JAX version computes it; the
    product with a float32 tensor stays in float32."""
    return float(np.float32(q) / np.float32(100.0))


def _kth_pair_bisect(flat: torch.Tensor, m: torch.Tensor, k: torch.Tensor):
    """Exact k-th and (k+1)-th smallest of ``flat[m]`` by 32-step integer
    bisection over an order-isomorphic int32 key of the float32 bit
    patterns; both ranks are searched together, one compare-and-count pass
    per step."""
    bits = flat.contiguous().view(torch.int32)
    key = torch.where(bits < 0, -1 - (bits & 0x7FFFFFFF), bits)
    key = torch.where(m, key, torch.full_like(key, _I32_MAX))
    n = m.sum(dtype=torch.int32)
    ranks = torch.stack([k, torch.minimum(k + 1, n - 1)]).to(torch.int32)
    lo = torch.full((2,), _I32_MIN, dtype=torch.int32, device=flat.device)
    hi = torch.full((2,), _I32_MAX, dtype=torch.int32, device=flat.device)
    for _ in range(32):  # invariant: answer in (lo, hi]
        mid = (lo & hi) + ((lo ^ hi) >> 1)  # overflow-safe floor average
        cnt = (key[None, :] <= mid[:, None]).sum(dim=1, dtype=torch.int32)
        take_lo = cnt >= ranks + 1
        lo, hi = torch.where(take_lo, lo, mid), torch.where(take_lo, mid, hi)
    b = torch.where(hi < 0, (-1 - hi) + _I32_MIN, hi)
    v = b.view(torch.float32)
    return v[0], v[1]


def masked_percentile(x: torch.Tensor, mask: torch.Tensor, q) -> torch.Tensor:
    """Percentile ``q`` of ``x[mask]`` (linear interpolation) as a 0-d float32
    tensor on ``x``'s device; 0 when the mask is empty."""
    flat = x.to(torch.float32).reshape(-1)
    m = mask.reshape(-1).to(torch.bool)
    if flat.shape[0] > _EXACT_SORT_LIMIT:
        stride = -(-flat.shape[0] // _EXACT_SORT_LIMIT)
        if x.dim() >= 2 and x.shape[-1] >= 128:
            W = x.shape[-1]
            flat = flat.reshape(-1, W)[::stride].reshape(-1)
            m = m.reshape(-1, W)[::stride].reshape(-1)
        else:
            flat = flat[::stride]
            m = m[::stride]
    n = m.sum(dtype=torch.int32)
    pos = torch.clamp_min(n - 1, 0).to(torch.float32) * _q_frac(q)
    lo = torch.floor(pos).to(torch.int32)
    frac = pos - lo.to(torch.float32)
    lo = torch.clamp(lo, 0, flat.shape[0] - 1)
    if flat.shape[0] >= _BISECT_MIN_SIZE:
        v_lo, v_hi = _kth_pair_bisect(flat, m, lo)
    else:
        s = torch.sort(torch.where(m, flat, float("inf"))).values
        hi = torch.clamp(torch.ceil(pos).to(torch.int32), 0, flat.shape[0] - 1)
        v_lo, v_hi = s[lo.long()], s[hi.long()]
    val = v_lo * (1.0 - frac) + v_hi * frac
    return torch.where(n > 0, val, torch.zeros_like(val))


def percentile(x: torch.Tensor, q) -> torch.Tensor:
    """``np.percentile(x, q)`` (linear interpolation, scalar ``q``) as a 0-d
    float32 tensor; large arrays go through :func:`masked_percentile`."""
    flat = x.to(torch.float32).reshape(-1)
    if flat.shape[0] >= _BISECT_MIN_SIZE:
        return masked_percentile(flat, torch.ones_like(flat, dtype=torch.bool), q)
    s = torch.sort(flat).values
    n1 = flat.shape[0] - 1
    # XLA compiles jnp.percentile's (q / 100) * (n - 1) with the static
    # n - 1 as q * (0.01f * (n - 1)) and its interpolation as one fused
    # multiply-add on top of the rounded low product; both are reproduced
    # here so the result equals the JAX package's bit for bit
    pos = np.float32(q) * np.float32(np.float32(0.01) * np.float32(n1))
    lo, hi = np.floor(pos), np.ceil(pos)
    frac = float(pos - lo)
    v_lo, v_hi = s[min(max(int(lo), 0), n1)], s[min(max(int(hi), 0), n1)]
    return fma_f32(v_hi, frac, v_lo * float(np.float32(1.0) - np.float32(frac)))
