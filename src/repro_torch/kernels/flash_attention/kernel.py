"""Bind the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

The library is built by ``repro_torch.kernels._build`` at first use (nvcc,
``sm_90a``, a plain C interface loaded with ``ctypes``). Nothing here runs
at import. ``flash_attention_cuda`` keeps the Pallas function's contract:
q ``[B,S,H,dh]``, k/v ``[B,S,Kv,dh]`` with ``H % Kv == 0``, f32 or bf16 in,
the same dtype out, ``dh`` in ``HEAD_DIMS``. bf16 runs on the tensor cores
(``wgmma`` fed by TMA), f32 on the CUDA cores. It checks device, dtype,
contiguity, 16-byte alignment (TMA's) and shapes, allocates the output,
launches on the current stream, raises on a CUDA error and adds one to
``LAUNCHES["flash_attention"]`` where it launches. An empty batch launches
nothing and counts nothing. ``supports`` tells a caller beforehand, from
dtypes and shapes, whether the kernel takes a call.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, count_launch
from repro_torch.kernels._build import Library, raise_on

CSRC = Path(__file__).resolve().parent / "csrc"
HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernel's template instances


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.fa_forward_f32, lib.fa_forward_bf16):
        fn.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, f, p]
        fn.restype = i
    lib.fa_tc_smem_bytes.argtypes = [i]
    lib.fa_tc_smem_bytes.restype = i


LIBRARY = Library("flash_attention", (CSRC / "flash_attention.cu",),
                  _declare)


def _unsupported(q, k, v):
    """-> the error that refuses ``q``, ``k`` and ``v`` whatever their
    device and layout, or None where the kernel computes them."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            return TypeError(f"{name} must be float32 or bfloat16, got "
                             f"{t.dtype}")
        if t.dtype != q.dtype:
            return ValueError("q, k and v must share one dtype and device")
        if t.dim() != 4:
            return ValueError(f"{name} must be [B, S, heads, dh], got "
                              f"{tuple(t.shape)}")
    B, S, H, dh = q.shape
    Kv = k.shape[2]
    if tuple(k.shape) != (B, S, Kv, dh) or v.shape != k.shape:
        return ValueError(f"k and v must be [{B}, {S}, Kv, {dh}], got "
                          f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Kv == 0 or H % Kv:
        return ValueError(f"query heads {H} must be a multiple of kv heads "
                          f"{Kv}")
    if dh not in HEAD_DIMS:
        return ValueError(f"head dim {dh} has no kernel instance; built for "
                          f"{HEAD_DIMS}")
    return None


def supports(q, k, v) -> bool:
    """Whether the kernel computes these tensors once they are on the card,
    contiguous and 16-byte aligned: f32 or bf16, one dtype, q
    ``[B,S,H,dh]`` and k, v ``[B,S,Kv,dh]`` with ``H % Kv == 0`` and ``dh``
    in ``HEAD_DIMS``. Decided from dtypes and shapes alone, on any device."""
    return _unsupported(q, k, v) is None


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError("q, k and v must share one dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    err = _unsupported(q, k, v)
    if err is not None:
        raise err


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale: float | None = None):
    """q: [B,S,H,dh], k/v: [B,S,Kv,dh] on the card -> [B,S,H,dh]."""
    _check(q, k, v)
    B, S, H, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    if B * S * H == 0:                 # no row, no launch
        return out
    lib = LIBRARY.load()
    fn = lib.fa_forward_f32 if q.dtype == torch.float32 else \
        lib.fa_forward_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], dh, scale, int(causal), int(window),
                 float(softcap), stream)
    raise_on(err, "fa_forward")
    count_launch("flash_attention")
    return out
