"""Shared model primitives: norms, positions, activations (the JAX
package's ``models/common.py``, computed the same way: f32 inside, cast
back), and the training loss's ``cross_entropy``."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models.params import ParamDef


def einsum(eq: str, *xs):
    """``torch.einsum`` with JAX's type promotion: operands of mixed dtypes
    (bf16 cache against f32 weights) meet in the promoted dtype."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return torch.einsum(eq, *(x.to(dt) for x in xs))


# ---------------------------------------------------------------------------
# Norms (computed in fp32, cast back)
# ---------------------------------------------------------------------------

def rmsnorm(x, scale=None, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


def layernorm(x, scale=None, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(kind: str, x, params):
    """kind: rmsnorm | layernorm | layernorm_np; params holds 'scale'/'bias'
    if any."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"] if params else None)
    if kind == "layernorm":
        return layernorm(x, params["scale"] if params else None,
                         params.get("bias") if params else None)
    if kind == "layernorm_np":          # OLMo: non-parametric
        return layernorm(x, None, None)
    raise ValueError(kind)


def norm_schema(kind: str, d: int):
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), (None,), init="zeros")}
    if kind == "layernorm":
        return {"scale": ParamDef((d,), (None,), init="ones"),
                "bias": ParamDef((d,), (None,), init="zeros")}
    if kind == "layernorm_np":
        return {}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_freq(dh: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's f32 frequencies (numpy), copied to ``device`` once:
    a copy per call would wait for the card twice a layer."""
    freq = 1.0 / (theta ** (np.arange(0, dh // 2, dtype=np.float32) * 2.0 / dh))
    with torch.inference_mode(False):        # a normal tensor, usable anywhere
        return torch.as_tensor(freq, device=device)


def rope(x, positions, theta: float):
    """Rotary embedding. x: [..., S, H, Dh] (or [..., S, Dh]); positions:
    [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    freq = _rope_freq(dh, theta, x.device)
    ang = positions[..., None].float() * freq                      # [..., S, half]
    if x.dim() == ang.dim() + 2:                                   # head dim present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sinusoid_freq(d: int, device: torch.device) -> torch.Tensor:
    """The reference's frequencies: numpy computes them in f64 (a numpy f64
    scalar times an f32 array is f64 under numpy 2), and JAX, with x64 off,
    takes them as f32. Copied to ``device`` once."""
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    with torch.inference_mode(False):        # a normal tensor, usable anywhere
        return torch.as_tensor(freq.astype(np.float32), device=device)


def sinusoidal_pos(positions, d: int, dtype=torch.bfloat16):
    """[..., S] -> [..., S, d] sinusoidal embedding (MusicGen-style): the
    angle in f32, ``[sin, cos]`` cast to ``dtype``."""
    ang = positions[..., None].float() * _sinusoid_freq(d, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def activate(kind: str, x):
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(kind)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softcap(x, cap: float):
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def cross_entropy(logits, labels, *, vocab_real: int, z_loss: float = 1e-4,
                  ignore_index: int = -1):
    """CE over a padded vocab; labels == ``ignore_index`` are masked out.

    logits: [..., V_pad] (bf16 ok), labels: [...] int. The padded columns
    get -1e9, ``logsumexp`` runs in f32, ``z_loss * lse^2`` is added to
    each label's loss, and the mean is over the valid labels (at least
    one)."""
    vpad = logits.shape[-1]
    lf = logits.float()
    if vpad > vocab_real:
        mask = torch.zeros(vpad, dtype=torch.float32, device=lf.device)
        mask[vocab_real:] = -1e9
        lf = lf + mask
    lse = torch.logsumexp(lf, dim=-1)
    safe = labels.clamp(0, vpad - 1).long()
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = lse - picked
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    valid = labels != ignore_index
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum() / torch.clamp_min(valid.sum(), 1)
