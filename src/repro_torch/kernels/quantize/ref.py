"""Plain PyTorch versions of the block int8 quantizer (a copy of the JAX
package's ``kernels/quantize/ref.py``).

Parity with the reference's wire bytes needs IEEE division and
round-half-to-even: ``torch.round`` rounds half to even, and every divisor
is a tensor on the payload's device, because on CUDA PyTorch turns a
division by a Python scalar into a multiplication by its reciprocal. bf16
input is cast to f32 first, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(value), device=like.device)


def quantize_ref(x, block: int = 256):
    """x: [R, C] float (C % block == 0) -> (q int8 [R, C], scales f32
    [R, C/block]): per block, ``scale = max(max|x| / 127, 1e-12)`` and
    ``q = clip(round(x / scale), -127, 127)``."""
    R, C = x.shape
    xb = x.to(torch.float32).reshape(R, C // block, block)
    scale = xb.abs().amax(dim=-1) / _f32(127.0, x)
    scale = torch.clamp_min(scale, _f32(1e-12, x))
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(R, C), scale


def dequantize_ref(q, scale, block: int = 256):
    """q: [R, C] int8, scale: [R, C/block] f32 -> f32 [R, C], ``q * scale``
    per block."""
    R, C = q.shape
    xb = q.reshape(R, C // block, block).to(torch.float32) * scale[..., None]
    return xb.reshape(R, C)
