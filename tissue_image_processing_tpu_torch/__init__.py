"""PyTorch/CUDA port of ``tissue_image_processing_tpu`` for NVIDIA Hopper.

The module layout mirrors the JAX package (``ops/``, ``core/``, ``utils/``) so
every function has an obvious counterpart. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; asking for CUDA without a card
raises. Hand-written kernels live in ``csrc/`` and are compiled with ``nvcc``
at first use (see ``_device.py``); on CPU tensors each kernel wrapper runs its
plain PyTorch version instead.

This package never imports ``jax`` or ``tissue_image_processing_tpu``.
"""

from tissue_image_processing_tpu_torch._device import (  # noqa: F401
    LAUNCHES, build_kernels, reset_launches, resolve_device)

__all__ = ["LAUNCHES", "build_kernels", "reset_launches", "resolve_device"]
