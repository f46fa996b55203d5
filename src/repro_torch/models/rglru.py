"""Griffin RG-LRU recurrent block [arXiv:2402.19427] (RecurrentGemma): the
JAX package's ``models/rglru.py``.

Real-gated linear recurrent unit:
    r_t = sigmoid(W_r u_t), i_t = sigmoid(W_i u_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
The reference's prefill runs ``jax.lax.associative_scan`` over the
sequence. PyTorch has no stable associative scan, so prefill here is a
chunked scan in f32 (``_scan``): the recurrence within every chunk at once,
then each chunk's carry. Decode is one recurrence step (O(1) state).

Gates use block-diagonal linears with n_heads blocks (as in the DeepMind
impl).

On a model axis (``tp``, a ``parallel/tp.py::Tp``, where the ranks divide
the width ``W``) each rank holds ``W / tp`` state channels: the columns of
``w_in``, ``w_gate_branch`` and ``conv``, the rows of ``w_out`` (summed by
``Tp.exit``), its channels of the cache's ``conv`` and ``state``. A
channel's gate reads its whole block of ``bw`` channels, which may
straddle two ranks (at full width 640 channels a rank on 4, blocks of
256), so the gate input is gathered whole (``Tp.gather_last``) and each
rank computes the gates of its own channels from the blocks they lie in.
The gate blocks, their biases and ``lam`` stay whole and are entered. The
scan is per channel and needs nothing across ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import activate, einsum, softplus
from repro_torch.models.params import ParamDef
from repro_torch.models.ssm import _causal_conv

SCAN_CHUNK = 64                 # steps a chunk of the prefill scan


def rglru_schema(cfg: ArchConfig) -> dict:
    g = cfg.rglru
    D = cfg.d_model
    W = g.lru_width or D
    nb = cfg.n_heads
    bw = W // nb
    return {
        "w_in": ParamDef((D, W), ("embed", "state")),
        "w_gate_branch": ParamDef((D, W), ("embed", "state")),
        "conv": ParamDef((g.conv_width, W), (None, "state"), scale=0.5),
        "w_r": ParamDef((nb, bw, bw), (None, None, None)),
        "b_r": ParamDef((W,), (None,), init="zeros"),
        "w_i": ParamDef((nb, bw, bw), (None, None, None)),
        "b_i": ParamDef((W,), (None,), init="zeros"),
        "lam": ParamDef((W,), (None,), init="ones", dtype="float32"),
        "w_out": ParamDef((W, D), ("state", "embed")),
    }


def _block_linear(u, w, b, rows: slice | None = None):
    """u: [...,W], w: [nb,bw,bw] -> [...,W]; with ``rows``, only those
    channels, from the blocks they lie in (``b`` their biases)."""
    nb, bw, _ = w.shape
    rows = rows or slice(0, nb * bw)
    n0, n1 = rows.start // bw, -(-rows.stop // bw)
    ub = u[..., n0 * bw:n1 * bw]
    yb = einsum("...nk,nkj->...nj", ub.reshape(*u.shape[:-1], n1 - n0, bw),
                w[n0:n1]).reshape(ub.shape)
    return yb[..., rows.start - n0 * bw:rows.stop - n0 * bw] + b


def _gates(cfg: ArchConfig, p, u, tp=None):
    """-> (a, sqrt(1 - a^2) * i * u), both f32. ``tp``: ``u`` holds this
    rank's channels, and so do the results."""
    g = cfg.rglru
    if tp is None:
        r = _block_linear(u, p["w_r"], p["b_r"])
        i = _block_linear(u, p["w_i"], p["b_i"])
        lam = p["lam"]
    else:
        whole = tp.gather_last(u)
        rows = tp.block(whole.shape[-1])
        w = {n: tp.enter(p[n]) for n in ("w_r", "b_r", "w_i", "b_i", "lam")}
        r = _block_linear(whole, w["w_r"], w["b_r"][rows], rows)
        i = _block_linear(whole, w["w_i"], w["b_i"][rows], rows)
        lam = w["lam"][rows]
    r, i = torch.sigmoid(r.float()), torch.sigmoid(i.float())
    log_a = -g.c * softplus(lam) * r                     # [...,W], negative
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * u.float())
    return a, gated


def _scan(a, b, chunk: int = SCAN_CHUNK):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over axis 1 of [B,L,W].

    Every chunk of ``chunk`` steps runs the recurrence from zero and keeps
    the running product of its a's, all chunks at once; then each chunk
    adds its carry-in times that product, in chunk order. A trailing pad of
    a = 1, b = 0 fills the last chunk and touches no real step."""
    B, L, W = a.shape
    T = min(chunk, L)
    nc = -(-L // T)
    pad = nc * T - L
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    a = a.reshape(B, nc, T, W)
    b = b.reshape(B, nc, T, W)
    # out of place throughout, so autograd can differentiate the scan
    hs, ps = [b[:, :, 0]], [a[:, :, 0]]
    for t in range(1, T):
        hs.append(a[:, :, t] * hs[-1] + b[:, :, t])
        ps.append(ps[-1] * a[:, :, t])
    h, prod = torch.stack(hs, dim=2), torch.stack(ps, dim=2)
    out = [h[:, 0]]
    for c in range(1, nc):
        out.append(h[:, c] + prod[:, c] * out[-1][:, -1:])
    return torch.stack(out, dim=1).reshape(B, nc * T, W)[:, :L]


def rglru_apply(cfg: ArchConfig, p, x, *, make_cache: bool = False,
                tp=None):
    """x: [B,L,D] -> (y, cache|None). ``tp``: this rank's channels of
    ``p`` and of the cache."""
    if tp is not None:
        x = tp.enter(x)
    u0 = einsum("bld,dw->blw", x, p["w_in"])
    gate = activate("gelu", einsum("bld,dw->blw", x, p["w_gate_branch"]))
    u = _causal_conv(u0, p["conv"])

    a, b = _gates(cfg, p, u, tp)                           # [B,L,W] f32
    hh = _scan(a, b)
    y = hh.to(x.dtype) * gate
    out = einsum("blw,wd->bld", y, p["w_out"])
    if tp is not None:
        out = tp.exit(out)

    cache = None
    if make_cache:
        K = cfg.rglru.conv_width
        cache = {"conv": u0[:, -(K - 1):] if K > 1 else u0[:, :0],
                 "state": hh[:, -1]}                        # [B,W] f32
    return out, cache


def rglru_cache_def(cfg: ArchConfig, batch: int, tp=None) -> dict:
    """``tp``: this rank's channels."""
    g = cfg.rglru
    W = g.lru_width or cfg.d_model
    K = g.conv_width
    if tp is not None:
        W //= tp.tp
    return {
        "conv": ParamDef((batch, K - 1, W), ("batch", None, "state"),
                         init="zeros"),
        "state": ParamDef((batch, W), ("batch", "state"), init="zeros",
                          dtype="float32"),
    }


def rglru_decode(cfg: ArchConfig, p, x1, cache: dict, pos: int, tp=None):
    """One recurrence step. x1: [B,1,D] -> (y [B,1,D], new cache). The conv
    window comes back in the promoted dtype of the cache's and the step's
    (``jnp.concatenate``'s), so a bf16 cache under an f32 stream turns
    f32, as in the reference. ``tp``: as in ``rglru_apply``."""
    if tp is not None:
        x1 = tp.enter(x1)
    x0 = x1[:, 0]
    u0 = einsum("bd,dw->bw", x0, p["w_in"])
    gate = activate("gelu", einsum("bd,dw->bw", x0, p["w_gate_branch"]))
    dt = torch.promote_types(cache["conv"].dtype, u0.dtype)
    seq = torch.cat([cache["conv"].to(dt), u0[:, None].to(dt)], dim=1)
    u = einsum("bkw,kw->bw", seq, p["conv"])
    a, b = _gates(cfg, p, u, tp)
    h = a * cache["state"] + b
    y = h.to(x1.dtype) * gate
    out = einsum("bw,wd->bd", y, p["w_out"])[:, None, :]
    if tp is not None:
        out = tp.exit(out)
    return out, {"conv": seq[:, 1:], "state": h}
