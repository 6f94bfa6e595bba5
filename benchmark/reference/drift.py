"""Sub-pixel global drift via FFT phase correlation.

Frozen copy of the plain code of the port's ``ops/drift.py``: skimage's
``phase_cross_correlation`` with the Guizar-Sicairos upsampled-DFT
refinement on ``torch.fft``, batched over leading axes, and the drift
helpers built on it (``calculate_drift``, ``refine_drift`` with a stage
prior, ``drift_chain_with_stage_priors``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


__all__ = ["phase_cross_correlation"]


def _upsampled_dft(data: torch.Tensor, region: int, upsample: float,
                   off_y: torch.Tensor, off_x: torch.Tensor) -> torch.Tensor:
    """Inverse DFT of ``data`` (..., H, W) on a (region x region) upsampled
    grid whose corner sits at per-batch ``off_y``/``off_x`` (...,)."""
    H, W = data.shape[-2:]

    def kernel(n, offset):
        freqs = torch.fft.ifftshift(
            torch.arange(n, dtype=torch.float32, device=data.device)
            - math.floor(n / 2.0))
        samples = (torch.arange(region, dtype=torch.float32, device=data.device)
                   [:, None] - offset[..., None, None])      # (..., region, 1)
        phase = samples * freqs                              # (..., region, n)
        return torch.exp((-1j * 2.0 * math.pi / (n * upsample)) * phase)

    ky = kernel(H, off_y)
    kx = kernel(W, off_x)
    return ky @ data @ kx.transpose(-1, -2)


def phase_cross_correlation(reference: torch.Tensor, moving: torch.Tensor,
                            upsample_factor: int = 1,
                            normalization: Optional[str] = "phase"
                            ) -> torch.Tensor:
    """(..., 2) shift (dy, dx) to apply to ``moving`` to register it with
    ``reference`` (skimage sign convention). ``normalization="phase"``
    divides the cross-power spectrum by its magnitude; any other value
    (None) correlates it as it is."""
    a = reference.to(torch.float32)
    b = moving.to(torch.float32)
    R = torch.fft.fft2(a) * torch.conj(torch.fft.fft2(b))
    if normalization == "phase":
        R = R / torch.clamp(R.abs(), min=1e-20)
    cc = torch.fft.ifft2(R)
    H, W = a.shape[-2:]
    peak = cc.abs().flatten(-2).argmax(dim=-1)
    py = torch.div(peak, W, rounding_mode="floor").to(torch.float32)
    px = (peak % W).to(torch.float32)
    py = torch.where(py > H / 2, py - H, py)
    px = torch.where(px > W / 2, px - W, px)
    if upsample_factor <= 1:
        return torch.stack([py, px], dim=-1)
    u = float(upsample_factor)
    py = torch.round(py * u) / u
    px = torch.round(px * u) / u
    region = int(math.ceil(u * 1.5))
    dftshift = float(math.trunc(region / 2.0))
    cc_up = _upsampled_dft(torch.conj(R), region, u,
                           dftshift - py * u, dftshift - px * u)
    pk = cc_up.abs().flatten(-2).argmax(dim=-1)
    my = torch.div(pk, region, rounding_mode="floor").to(torch.float32) - dftshift
    mx = (pk % region).to(torch.float32) - dftshift
    return torch.stack([py + my / u, px + mx / u], dim=-1)
