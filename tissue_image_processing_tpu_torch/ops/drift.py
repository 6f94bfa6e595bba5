"""Sub-pixel global drift via FFT phase correlation.

Port of ``tissue_image_processing_tpu/ops/drift.py``: skimage's
``phase_cross_correlation`` with the Guizar-Sicairos upsampled-DFT
refinement on ``torch.fft``, batched over leading axes, and the drift
helpers built on it (``calculate_drift``, ``refine_drift`` with a stage
prior, ``drift_chain_with_stage_priors``).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import resolve_device

__all__ = ["phase_cross_correlation", "calculate_drift", "refine_drift",
           "drift_chain_with_stage_priors"]


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


def calculate_drift(first_image: torch.Tensor, second_image: torch.Tensor,
                    sub_pixel_precision: bool = True) -> torch.Tensor:
    """Global 2-D drift between two frames: the shift to add to the second
    image to get the first (1/100 pixel with ``sub_pixel_precision``)."""
    factor = 100 if sub_pixel_precision else 1
    return phase_cross_correlation(first_image, second_image,
                                   upsample_factor=factor)


def _as_tensor(image, device) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image
    return torch.as_tensor(np.asarray(image), device=resolve_device(device))


def refine_drift(previous: Union[torch.Tensor, np.ndarray],
                 current: Union[torch.Tensor, np.ndarray],
                 coarse_dy: float = 0.0, coarse_dx: float = 0.0,
                 shape_quantum: int = 32,
                 device: Optional[Union[str, torch.device]] = None) -> np.ndarray:
    """Crop both frames to the overlap that the integer part of a coarse
    stage shift predicts, then refine by sub-pixel phase correlation.

    Both crops floor the shift as the reference does, and the overlap is
    trimmed down to a multiple of ``shape_quantum``. Returns a host float64
    array (total_dy, total_dx): the shift to add to ``current`` to align it
    with ``previous``. Tensors stay on their device; host arrays go to
    ``device`` (None: the card)."""
    ry = int(math.floor(float(coarse_dy)))
    rx = int(math.floor(float(coarse_dx)))
    prev_t = _as_tensor(previous, device)
    cur_t = _as_tensor(current, device)
    H, W = prev_t.shape[-2:]
    oh = max(H - abs(ry), shape_quantum)
    ow = max(W - abs(rx), shape_quantum)
    oh -= oh % shape_quantum
    ow -= ow % shape_quantum
    a0, b0 = max(ry, 0), max(-ry, 0)
    a1, b1 = max(rx, 0), max(-rx, 0)
    # a window past the edge moves back inside it, as the JAX version's
    # slice moves it
    a0, b0 = min(a0, H - oh), min(b0, H - oh)
    a1, b1 = min(a1, W - ow), min(b1, W - ow)
    prev_c = prev_t[..., a0:a0 + oh, a1:a1 + ow]
    cur_c = cur_t[..., b0:b0 + oh, b1:b1 + ow]
    refined = phase_cross_correlation(prev_c, cur_c, upsample_factor=100)
    return np.array([ry, rx], np.float64) + refined.cpu().numpy()


def drift_chain_with_stage_priors(images, stage_shifts,
                                  device: Optional[Union[str, torch.device]] = None
                                  ) -> np.ndarray:
    """(T, H, W) images and (T, 2) per-frame coarse stage shifts (rows,
    cols; shift[0] ignored) -> (T, 2) float64 refined drifts, drift[0] = 0:
    each frame pair cropped to its stage-predicted overlap and refined by
    :func:`refine_drift`, so stage jumps far beyond phase correlation's
    reach still register."""
    T = images.shape[0]
    drifts = np.zeros((T, 2), np.float64)
    for t in range(1, T):
        drifts[t] = refine_drift(images[t - 1], images[t],
                                 coarse_dy=float(stage_shifts[t, 0]),
                                 coarse_dx=float(stage_shifts[t, 1]),
                                 device=device)
    return drifts
