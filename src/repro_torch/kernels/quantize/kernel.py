"""Bind the hand-written CUDA block quantizer (``csrc/quantize.cu``).

The library is built by ``repro_torch.kernels._build`` at first use.
Nothing here runs at import. The wrappers keep the Pallas functions'
contract (``[R, C]`` with ``C % block == 0``, f32 or bf16 in, int8 codes and
f32 scales out; dequantize back to f32), check device, dtype, contiguity
and shapes, allocate their outputs, launch on the current stream, raise on
a CUDA error and add one to ``LAUNCHES["quantize"]`` /
``LAUNCHES["dequantize"]`` where they launch. An empty payload launches
nothing and counts nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import NO_FMA, Library, raise_on

CSRC = Path(__file__).resolve().parent / "csrc"


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bq_quantize_f32.argtypes = [p, ll, i, p, p, p]
    lib.bq_quantize_bf16.argtypes = [p, ll, i, p, p, p]
    lib.bq_dequantize.argtypes = [p, p, ll, i, p, p]
    for fn in (lib.bq_quantize_f32, lib.bq_quantize_bf16, lib.bq_dequantize):
        fn.restype = i


LIBRARY = Library("quantize", (CSRC / "quantize.cu",), _declare,
                  flags=NO_FMA)


def _check(name, t, dtypes):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_block(shape, block):
    if block <= 0 or block % 32:
        raise ValueError(f"block must be a positive multiple of 32, got "
                         f"{block}")
    if len(shape) != 2 or shape[1] % block:
        raise ValueError(f"expected [R, C] with C % {block} == 0, got "
                         f"{tuple(shape)}")


def quantize_cuda(x, *, block: int = 256):
    """x: [R, C] f32 or bf16 -> (q int8 [R, C], scales f32 [R, C/block])."""
    _check("x", x, (torch.float32, torch.bfloat16))
    _check_block(x.shape, block)
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R, C // block), dtype=torch.float32, device=x.device)
    n_blocks = R * C // block
    if n_blocks == 0:             # no block, no launch
        return q, s
    lib = LIBRARY.load()
    fn = lib.bq_quantize_f32 if x.dtype == torch.float32 else \
        lib.bq_quantize_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), n_blocks, block, q.data_ptr(), s.data_ptr(),
                 stream)
    raise_on(err, "bq_quantize")
    LAUNCHES["quantize"] += 1
    return q, s


def dequantize_cuda(q, s, *, block: int = 256):
    """q: [R, C] int8, s: [R, C/block] f32 -> f32 [R, C]."""
    _check("q", q, (torch.int8,))
    _check("s", s, (torch.float32,))
    _check_block(q.shape, block)
    R, C = q.shape
    if tuple(s.shape) != (R, C // block):
        raise ValueError(f"scales must be [{R}, {C // block}], got "
                         f"{tuple(s.shape)}")
    if s.device != q.device:
        raise ValueError("q and s must be on one device")
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    n_blocks = R * C // block
    if n_blocks == 0:             # no block, no launch
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bq_dequantize(q.data_ptr(), s.data_ptr(), n_blocks, block,
                                out.data_ptr(), stream)
    raise_on(err, "bq_dequantize")
    LAUNCHES["dequantize"] += 1
    return out
