"""Pyramidal TV-L1 optical flow (Zach et al. 2007).

Port of ``tissue_image_processing_tpu/ops/optical_flow.py``, the
replacement for ``skimage.registration.optical_flow_tvl1`` in the
reference's legacy tracker (its ``use_piv`` branch): a dense per-pixel
displacement map for movies where one global drift does not describe the
motion.

The solver (a pointwise threshold on the linearised residual, then
Chambolle dual ascent on the flow's gradient) has no data-dependent control
flow. Each pyramid level is ``num_warp`` bilinear warps of the moving image,
each followed by ``num_iter`` elementwise passes on (H, W) planes. The JAX
version's ``fori_loop``s are Python loops of a fixed trip count here, and no
value is read back to the host inside them, so the whole pyramid is queued
on the device without a synchronisation. The JAX code has no Pallas kernel;
this is plain PyTorch on either device.

Convention: ``optical_flow_tvl1(ref, mov)`` returns ``flow`` of shape
(2, H, W) such that ``mov(r + flow(r)) ~= ref(r)`` (skimage's). For tracking,
``flow = optical_flow_tvl1(cur, prev)`` and the cell at previous-frame
position ``y`` is found near ``y - flow(y)`` in the current frame (see
``core/tracking.py:track_movie_nearest_pixel``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tissue_image_processing_tpu_torch._device import resolve_device
from tissue_image_processing_tpu_torch.ops.filters import resize_bilinear

__all__ = ["optical_flow_tvl1", "warp_bilinear"]


def warp_bilinear(img: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` at (y + u, x + v) with bilinear weights, edge-clamped:
    the coordinates are clamped to the image before the floor, and the four
    neighbours gathered with int32 indices."""
    H, W = img.shape
    yy = torch.arange(H, dtype=torch.float32, device=img.device)[:, None] + u
    xx = torch.arange(W, dtype=torch.float32, device=img.device)[None, :] + v
    yy = torch.clamp(yy, 0.0, H - 1.0)
    xx = torch.clamp(xx, 0.0, W - 1.0)
    y0 = torch.floor(yy).to(torch.int32)
    x0 = torch.floor(xx).to(torch.int32)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    fy = yy - y0
    fx = xx - x0
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _grad(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences, zero at the far edge (the standard TV
    discretisation)."""
    gy = torch.cat([f[1:] - f[:-1], torch.zeros_like(f[:1])], 0)
    gx = torch.cat([f[:, 1:] - f[:, :-1], torch.zeros_like(f[:, :1])], 1)
    return gy, gx


def _div(py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`_grad`: the backward-difference divergence, with
    its own first and last rows and columns."""
    dy = torch.cat([py[:1], py[1:-1] - py[:-2], -py[-2:-1]], 0)
    dx = torch.cat([px[:, :1], px[:, 1:-1] - px[:, :-2], -px[:, -2:-1]], 1)
    return dy + dx


def _tvl1_level(I0: torch.Tensor, I1: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor, attachment: float, tightness: float,
                num_warp: int, num_iter: int, tau: float = 0.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level of the TV-L1 solver: ``num_warp`` warps of ``I1``
    by the current flow, each refined by ``num_iter`` proximal passes."""
    th = attachment * tightness  # lambda * theta threshold scale
    sigma = tau / tightness
    for _ in range(num_warp):
        u0, v0 = u, v
        I1w = warp_bilinear(I1, u0, v0)
        # gradients of the WARPED moving image: central differences that
        # wrap around at the edges, as the JAX version's jnp.roll does
        Iy = (torch.roll(I1w, -1, 0) - torch.roll(I1w, 1, 0)) * 0.5
        Ix = (torch.roll(I1w, -1, 1) - torch.roll(I1w, 1, 1)) * 0.5
        grad2 = Iy * Iy + Ix * Ix
        safe = torch.clamp(grad2, min=1e-8)
        rho_c = I1w - Iy * u0 - Ix * v0 - I0
        pyu = pxu = pyv = pxv = torch.zeros_like(u0)
        u, v = u0, v0
        for _ in range(num_iter):
            rho = rho_c + Iy * u + Ix * v
            # pointwise threshold (the L1 data term's proximal step)
            case_neg = rho < -th * grad2
            case_pos = rho > th * grad2
            du = torch.where(case_neg, th * Iy,
                             torch.where(case_pos, -th * Iy, -rho * Iy / safe))
            dv = torch.where(case_neg, th * Ix,
                             torch.where(case_pos, -th * Ix, -rho * Ix / safe))
            vu = u + du
            vv = v + dv
            # TV proximal step by Chambolle dual ascent
            u = vu + tightness * _div(pyu, pxu)
            v = vv + tightness * _div(pyv, pxv)
            gy, gx = _grad(u)
            pyu = pyu + sigma * gy
            pxu = pxu + sigma * gx
            nu = torch.clamp(torch.sqrt(pyu * pyu + pxu * pxu), min=1.0)
            pyu, pxu = pyu / nu, pxu / nu
            gy, gx = _grad(v)
            pyv = pyv + sigma * gy
            pxv = pxv + sigma * gx
            nv = torch.clamp(torch.sqrt(pyv * pyv + pxv * pxv), min=1.0)
            pyv, pxv = pyv / nv, pxv / nv
    return u, v


def _as_tensor(image, device: torch.device) -> torch.Tensor:
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image))
    return image.to(device=device, dtype=torch.float32)


def optical_flow_tvl1(reference, moving, attachment: float = 15.0,
                      tightness: float = 0.3, num_warp: int = 5,
                      num_iter: int = 10, min_size: int = 16,
                      device=None) -> torch.Tensor:
    """Dense flow (2, H, W) float32 on ``device`` (``None``: the card) with
    ``moving(r + flow(r)) ~= reference(r)``. ``reference`` / ``moving``:
    (H, W) arrays or tensors.

    Parameters mirror skimage's ``optical_flow_tvl1``; the images are
    normalised to [0, 1] together. The pyramid halves both sides while the
    smaller stays >= ``min_size``; each level is shrunk from the full image
    by the antialiased linear resize of ``jax.image.resize``
    (``ops/filters.py:resize_bilinear``), and the flow is carried to the
    next level by the same resize, scaled by the size ratio."""
    dev = resolve_device(device)
    I0 = _as_tensor(reference, dev)
    I1 = _as_tensor(moving, dev)
    # lo, hi and scale stay on the device: nothing here waits for it
    lo = torch.minimum(I0.min(), I1.min())
    hi = torch.maximum(I0.max(), I1.max())
    scale = torch.clamp(hi - lo, min=1e-8)
    I0 = (I0 - lo) / scale
    I1 = (I1 - lo) / scale
    H, W = I0.shape

    shapes = [(H, W)]
    while min(shapes[-1]) // 2 >= min_size:
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    shapes = shapes[::-1]  # coarse -> fine

    u = torch.zeros(shapes[0], dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    for i, shp in enumerate(shapes):
        I0l = resize_bilinear(I0, shp)
        I1l = resize_bilinear(I1, shp)
        if i > 0:
            sy = shp[0] / shapes[i - 1][0]
            sx = shp[1] / shapes[i - 1][1]
            u = resize_bilinear(u, shp) * sy
            v = resize_bilinear(v, shp) * sx
        u, v = _tvl1_level(I0l, I1l, u, v, attachment, tightness,
                           num_warp, num_iter)
    return torch.stack([u, v])
