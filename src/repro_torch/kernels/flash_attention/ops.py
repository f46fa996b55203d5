"""Dispatch for flash attention: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor. A CUDA tensor goes to the kernel,
made contiguous and 16-byte aligned first, or the call raises: no fallback.
``kernel.supports`` says beforehand whether the kernel takes a call.

The kernel is reached through the custom op
``repro_torch::flash_attention_fwd`` (``flash_attention_fwd``): its CUDA
implementation launches the kernel, its fake implementation gives the
output ([B,S,H,dh] in q's dtype) for a ``meta`` tensor under
``kernels.card_routing()``, so the dry run and the operation census see
the launch as one operator on either device.

``flash_attention`` is a ``torch.autograd.Function``, as the JAX package's
is a ``custom_vjp``: the forward runs the kernel and the backward recomputes
through ``attention_ref`` under autograd (not a kernel).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.flash_attention import kernel, ref


def _aligned(t):
    """``t`` contiguous and 16-byte aligned, as the kernel's TMA reads it: a
    copy where it is neither (a fresh allocation is aligned)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int, softcap: float,
                        scale: float) -> torch.Tensor:
    """The kernel's launch as one operator (q, k, v as ``flash_attention``
    takes them; ``scale`` given)."""
    return kernel.flash_attention_cuda(
        _aligned(q), _aligned(k), _aligned(v), causal=causal, window=window,
        softcap=softcap, scale=scale)


@flash_attention_fwd.register_fake
def _flash_attention_fake(q, k, v, causal, window, softcap, scale):
    err = kernel._unsupported(q, k, v)
    if err is not None:
        raise err
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        if on_card(q):
            return flash_attention_fwd(
                q, k, v, causal, window, softcap,
                1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)
        return ref.attention_ref(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = ref.attention_ref(q, k, v, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    """q: [B,S,H,dh], k/v: [B,S,Kv,dh] -> [B,S,H,dh] in q's dtype."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
