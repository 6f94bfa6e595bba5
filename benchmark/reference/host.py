"""Device helpers of the plain reference: plain ``torch`` calls in place of
the port's pinned, stream-aware copies."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "host_to_device", "host_constant"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA, as in the port."""
    return torch.device("cuda" if device is None else device)


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device)


def host_constant(key, make, device) -> torch.Tensor:
    return make().to(device)
