"""Plain PyTorch version of the flash-attention kernel (a copy of the JAX
package's ``kernels/flash_attention/ref.py``): causal GQA attention with
an optional tanh softcap and sliding window, f32 scores, masked entries at
-2e9, and ``p`` cast to ``v``'s dtype before the context product."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e9


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: float | None = None):
    """q: [B,S,H,dh], k/v: [B,S,Kv,dh] -> [B,S,H,dh]."""
    B, S, H, dh = q.shape
    Kv = k.shape[2]
    G = H // Kv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, S, Kv, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= rel >= 0
    if window:
        ok &= rel < window
    s = torch.where(ok, s, NEG_INF)          # an f32 scalar, as s
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, S, H, dh)
