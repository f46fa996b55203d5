"""Block-wise int8 quantization: the int8 shuffle codec's wire format.

The port of ``repro.core.compression``'s quantizer (``BLOCK``,
``int8_wire_bytes``, ``quantize_block``, ``dequantize_block``,
``compress_roundtrip``). A payload's last axis is zero-padded to whole
256-element blocks and each block gets one f32 max-abs scale. The work goes
through ``kernels/quantize``: the hand-written CUDA kernels for a CUDA
tensor, the plain PyTorch versions for a CPU tensor, bit-identical to the
reference either way.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.quantize.ops import dequantize, quantize

BLOCK = 256


def int8_wire_bytes(n: int, block: int = BLOCK) -> int:
    """Wire bytes for a block-quantized payload of ``n`` scalars: one int8
    code per element plus one fp32 scale per block (zero-padded to a full
    final block)."""
    n_pad = ((max(n, 1) + block - 1) // block) * block
    return n_pad + 4 * (n_pad // block)


def quantize_block(x: torch.Tensor, block: int = BLOCK):
    """x: [..., n] (f32 or bf16; other floats are cast to f32) -> (q int8
    [..., n_pad], scales f32 [..., n_pad/block], n). Per-block symmetric
    max-abs scaling, on ``x``'s device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    n_pad = -(-n // block) * block
    rows = x.reshape(math.prod(lead), n)
    if n_pad != n:
        rows = torch.nn.functional.pad(rows, (0, n_pad - n))
    q, s = quantize(rows.contiguous(), block=block)
    return q.reshape(*lead, n_pad), s.reshape(*lead, n_pad // block), n


def dequantize_block(q, scale, n: int, dtype=torch.float32,
                     block: int = BLOCK):
    """The inverse of ``quantize_block``: [..., n_pad] codes and their
    scales -> [..., n] of ``dtype``."""
    lead, n_pad = tuple(q.shape[:-1]), q.shape[-1]
    R = math.prod(lead)
    x = dequantize(q.reshape(R, n_pad).contiguous(),
                   scale.reshape(R, n_pad // block).contiguous(),
                   block=block)
    return x.reshape(*lead, n_pad)[..., :n].to(dtype)


def compress_roundtrip(x: torch.Tensor, block: int = BLOCK):
    """dequant(quant(x)): what the wire sees after one hop."""
    q, s, n = quantize_block(x.reshape(-1), block)
    return dequantize_block(q, s, n, x.dtype, block).reshape(x.shape)
