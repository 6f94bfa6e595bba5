"""Float32 arithmetic helpers shared by the port's modules."""

from __future__ import annotations

import torch

__all__ = ["fma_f32"]


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with ONE rounding, as the fused multiply-add that
    XLA's CPU and TPU compilers emit for such expressions: the product of two
    float32 values is exact in float64, so only the final sum rounds."""
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)
