"""Dispatch for the block quantizer: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor. A CUDA tensor goes to the kernel or
the call raises: no fallback.

The kernels are reached through the custom ops ``repro_torch::
block_quantize`` and ``repro_torch::block_dequantize``: the CUDA
implementations launch them, the fake ones give the outputs' shapes and
dtypes for ``meta`` tensors under ``kernels.card_routing()`` (the dry
run), so the operation census sees each launch as one operator."""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.quantize import kernel, ref


@torch.library.custom_op("repro_torch::block_quantize", mutates_args=(),
                         device_types="cuda")
def block_quantize(x: torch.Tensor, block: int) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    return kernel.quantize_cuda(x, block=block)


@block_quantize.register_fake
def _block_quantize_fake(x, block):
    kernel._check_block(x.shape, block)
    R, C = x.shape
    return (torch.empty((R, C), dtype=torch.int8, device=x.device),
            torch.empty((R, C // block), dtype=torch.float32,
                        device=x.device))


@torch.library.custom_op("repro_torch::block_dequantize", mutates_args=(),
                         device_types="cuda")
def block_dequantize(q: torch.Tensor, s: torch.Tensor,
                     block: int) -> torch.Tensor:
    return kernel.dequantize_cuda(q, s, block=block)


@block_dequantize.register_fake
def _block_dequantize_fake(q, s, block):
    kernel._check_block(q.shape, block)
    return torch.empty(q.shape, dtype=torch.float32, device=q.device)


def quantize(x, *, block: int = 256):
    """x: [R, C] f32 or bf16, C % block == 0 -> (q int8 [R, C], scales f32
    [R, C/block])."""
    if on_card(x):
        return block_quantize(x, block)
    return ref.quantize_ref(x, block=block)


def dequantize(q, s, *, block: int = 256):
    """q int8 [R, C], s f32 [R, C/block] -> f32 [R, C]."""
    if on_card(q):
        return block_dequantize(q, s, block)
    return ref.dequantize_ref(q, s, block=block)
