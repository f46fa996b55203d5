"""Dispatch for the block quantizer: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor. A CUDA tensor goes to the kernel or
the call raises: no fallback."""
from __future__ import annotations

from repro_torch.kernels.quantize import kernel, ref


def quantize(x, *, block: int = 256):
    """x: [R, C] f32 or bf16, C % block == 0 -> (q int8 [R, C], scales f32
    [R, C/block])."""
    if x.is_cuda:
        return kernel.quantize_cuda(x, block=block)
    return ref.quantize_ref(x, block=block)


def dequantize(q, s, *, block: int = 256):
    """q int8 [R, C], s f32 [R, C/block] -> f32 [R, C]."""
    if q.is_cuda:
        return kernel.dequantize_cuda(q, s, block=block)
    return ref.dequantize_ref(q, s, block=block)
