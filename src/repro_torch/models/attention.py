"""Attention: GQA/MQA/MHA, sliding-window, cross attention, and DeepSeek's
MLA (the JAX package's ``models/attention.py``).

Inner loops (``impl``), as in the reference:

- ``masked``   full scores + additive mask. Fine for short sequences.
- ``chunked``  a loop over KV chunks with online softmax: bounded memory,
               still computes masked-out blocks.
- ``blocked_causal`` the reference's static (q-block, kv-block) schedule:
               only the block pairs that meet the causal/window mask run,
               each an online-softmax step of its q block.

On the card, causal self attention (``Sq == Sk``, default positions, no
``k_valid``: the prefill and full-forward path) runs the hand-written flash
kernel through ``kernels/flash_attention/ops.py`` whatever the impl, as the
reference's docstring describes for the TPU, wherever the kernel takes the
call (``flash_attention.kernel.supports``: dtype, head dim, GQA layout);
so does a ``meta`` tensor under ``kernels.card_routing()`` (the dry run
sizes the card's path, the kernel's fake implementation in the flash
kernel's place). Every other call runs ``impl``'s formula on its device, as the
reference's ``attend`` does. Three kinds of call never reach the kernel:
decode (one query against the cache, ``k_valid``); MLA's prefill, whose
queries and keys have a head dim of ``nope + rope`` (192 at full width)
and its values ``v_head_dim`` (128), where the kernel, like the
reference's Pallas one, takes one head dim for q, k and v; and cross
attention (MusicGen: queries from the stream, keys and values from
``cond``, never causal), which always runs the masked formula, as the
reference's does. MLA's decode is the absorbed form against the latent
cache.

On a model axis (``tp``, a ``parallel/tp.py::Tp``) a layer whose heads the
ranks divide takes this rank's heads (GQA's, and MLA's ``w_uq``, ``w_uk``,
``w_uv``, ``w_o``, its down projections and norms whole and entered; the
latent cache whole on every rank, the reference's ``head_dim`` cut of it
being a storage layout). Where the ranks do not divide the heads
(``seq``), the reference's ``seq_model`` fallback: the weights stay whole
on every rank, each rank computes the queries of its block of ``S / tp``
positions and the keys and values that block reads, attends it at its
positions, and the blocks are laid end to end (``Tp.gather_seq``). Such a
block never reaches the flash kernel (which takes only default
positions): it runs ``impl``'s formula, ``chunked`` for
``blocked_causal``, whose schedule takes no positions. Decode, and a
sequence the ranks do not divide, runs whole on every rank, and so does
cross attention (its keys are ``cond``'s few positions); the caches are
whole on every rank there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels import on_card
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import einsum, rmsnorm, rope, softcap
from repro_torch.models.params import ParamDef, ParamModule

NEG_INF = -2.0e9


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def attn_schema(cfg: ArchConfig, kind: str) -> dict:
    """kind: attn | local | cross (GQA weights, under MLA too)."""
    if kind not in ("attn", "local", "cross"):
        raise ValueError(kind)
    if cfg.mla is not None and kind != "cross":
        m = cfg.mla
        D, H = cfg.d_model, cfg.n_heads
        dq = m.nope_head_dim + m.rope_head_dim
        return {
            "w_dq": ParamDef((D, m.q_lora_rank), ("embed", None)),
            "q_norm": ParamDef((m.q_lora_rank,), (None,), init="zeros"),
            "w_uq": ParamDef((m.q_lora_rank, H, dq), (None, "heads", None)),
            "w_dkv": ParamDef((D, m.kv_lora_rank), ("embed", None)),
            "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="zeros"),
            "w_uk": ParamDef((m.kv_lora_rank, H, m.nope_head_dim),
                             (None, "heads", None)),
            "w_uv": ParamDef((m.kv_lora_rank, H, m.v_head_dim),
                             (None, "heads", None)),
            "w_kr": ParamDef((D, m.rope_head_dim), ("embed", None)),
            "w_o": ParamDef((H, m.v_head_dim, D), ("heads", None, "embed")),
        }
    D, H, Kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {
        "w_q": ParamDef((D, H, dh), ("embed", "heads", None)),
        "w_k": ParamDef((D, Kv, dh), ("embed", "kv_heads", None)),
        "w_v": ParamDef((D, Kv, dh), ("embed", "kv_heads", None)),
        "w_o": ParamDef((H, dh, D), ("heads", None, "embed")),
    }


def cache_def(cfg: ArchConfig, kind: str, batch: int, max_len: int,
              tp=None) -> dict:
    """Shape template for a decode cache entry: ``[B, L, Kv, dh]`` k and v,
    ``L`` the window for a local layer with a window shorter than
    ``max_len``, ``cond_len`` for cross attention; for MLA the latent
    ``ckv [B, L, kv_lora]`` and the shared rotated key ``kr [B, L, rope]``.
    Under ``tp`` ``Kv`` is this rank's KV heads (``Tp.kv_heads``)."""
    if kind not in ("attn", "local", "cross"):
        raise ValueError(kind)
    if cfg.mla is not None and kind != "cross":
        m = cfg.mla
        return {
            "ckv": ParamDef((batch, max_len, m.kv_lora_rank),
                            ("batch", None, "head_dim"), init="zeros"),
            "kr": ParamDef((batch, max_len, m.rope_head_dim),
                           ("batch", None, None), init="zeros"),
        }
    Kv, dh = cfg.n_kv_heads, cfg.dh
    if tp is not None:
        Kv = tp.kv_heads(cfg.n_heads, Kv)[1]
    L = min(max_len, cfg.window) if kind == "local" and cfg.window else max_len
    if kind == "cross":
        L = cfg.cond_len
    dims = ("batch", None, "kv_heads", "head_dim")
    return {
        "k": ParamDef((batch, L, Kv, dh), dims, init="zeros"),
        "v": ParamDef((batch, L, Kv, dh), dims, init="zeros"),
    }


# ---------------------------------------------------------------------------
# Core attend
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, *, causal: bool, window: int, k_valid=None):
    """Additive fp32 bias [*, Sq, Sk] from position vectors."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        ok &= rel >= 0
    if window:
        ok &= rel < window
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=rel.device)
    return torch.where(ok, zero, NEG_INF)


def _scores(q, k, scale, cap):
    # q: [B,Sq,Kv,G,dh]  k: [B,Sk,Kv,dh] -> [B,Kv,G,Sq,Sk], f32
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    return softcap(s, cap) if cap else s


def _ctx(p, v):
    # p: [B,Kv,G,Sq,Sk]  v: [B,Sk,Kv,dv] -> [B,Sq,Kv,G,dv], in v's dtype: p is
    # cast to it, products summed in f32 and the sum rounded once
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def attend(q, k, v, *, causal: bool, window: int = 0, cap: float = 0.0,
           scale: float | None = None, impl: str = "masked", chunk: int = 1024,
           q_pos=None, k_pos=None, k_valid=None):
    """q: [B,Sq,H,dh], k/v: [B,Sk,Kv,d*]. Returns [B,Sq,H,dv]."""
    B, Sq, H, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    dv = v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if impl not in ("masked", "chunked", "blocked_causal"):
        raise ValueError(impl)
    if (on_card(q) and causal and Sq == Sk and q_pos is None and k_pos is None
            and k_valid is None and flash_kernel.supports(q, k, v)):
        return flash_attention(q, k, v, True, window, cap, scale)
    if impl == "blocked_causal" and Sk > chunk:
        # the reference's branch takes no positions and no key mask (it
        # drops them): refuse them rather than compute something else
        if q_pos is not None or k_pos is not None or k_valid is not None:
            raise ValueError("blocked_causal takes no q_pos, k_pos or "
                             "k_valid (self attention at arange(S))")
        return _attend_blocked(q.reshape(B, Sq, Kv, G, dh), k, v,
                               scale=scale, cap=cap, causal=causal,
                               window=window, chunk=chunk
                               ).reshape(B, Sq, H, dv)
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(Sk, device=q.device)
    qg = q.reshape(B, Sq, Kv, G, dh)

    if impl == "masked" or Sk <= chunk:
        s = _scores(qg, k, scale, cap)
        s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window,
                           k_valid=k_valid)
        p = torch.softmax(s, dim=-1)
        return _ctx(p, v).reshape(B, Sq, H, dv)
    return _attend_chunked(qg, k, v, scale=scale, cap=cap, causal=causal,
                           window=window, chunk=chunk, q_pos=q_pos,
                           k_pos=k_pos, k_valid=k_valid).reshape(B, Sq, H, dv)


def _attend_chunked(qg, k, v, *, scale, cap, causal, window, chunk,
                    q_pos, k_pos, k_valid):
    """Online softmax over KV chunks. Computes all blocks (masked baseline)."""
    B, Sq, Kv, G, dh = qg.shape
    Sk, dv = k.shape[1], v.shape[-1]
    nck = -(-Sk // chunk)
    pad = nck * chunk - Sk
    kv_flag = k_valid if k_valid is not None else \
        torch.ones(Sk, dtype=torch.bool, device=k.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
        kv_flag = torch.cat([kv_flag, kv_flag.new_zeros(pad)])

    m = torch.full((B, Kv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((B, Kv, G, Sq), dtype=torch.float32, device=qg.device)
    o = torch.zeros((B, Sq, Kv, G, dv), dtype=torch.float32, device=qg.device)
    for i in range(nck):
        sl = slice(i * chunk, (i + 1) * chunk)
        s = _scores(qg, k[:, sl], scale, cap)
        s = s + _mask_bias(q_pos, k_pos[sl], causal=causal, window=window,
                           k_valid=kv_flag[sl])
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha.permute(0, 3, 1, 2)[..., None] + _ctx(p, v[:, sl].float())
        m = m_new
    l = torch.clamp_min(l, 1e-20)
    o = o / l.permute(0, 3, 1, 2)[..., None]
    return o.to(qg.dtype)


def _attend_blocked(qg, k, v, *, scale, cap, causal, window, chunk):
    """The reference's static triangular schedule, in order: for each q
    block the kv blocks that meet its causal/window mask, each an online
    softmax step. q, k and v are zero-padded to whole chunks and the padded
    keys masked. Self attention at positions ``arange(S)``."""
    B, Sq, Kv, G, dh = qg.shape
    Sk, dv = k.shape[1], v.shape[-1]
    if Sq != Sk:
        raise ValueError("blocked_causal is for self attention (Sq == Sk)")
    nb = -(-Sq // chunk)
    pad = nb * chunk - Sq
    if pad:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    pos = torch.arange(nb * chunk, device=qg.device)
    out = []
    for qi in range(nb):
        lo = max(0, (qi * chunk - (window - 1)) // chunk) if window else 0
        hi = qi if causal else nb - 1
        qs = qg[:, qi * chunk:(qi + 1) * chunk]
        qp = pos[qi * chunk:(qi + 1) * chunk]
        m = torch.full((B, Kv, G, chunk), NEG_INF, dtype=torch.float32,
                       device=qg.device)
        l = torch.zeros((B, Kv, G, chunk), dtype=torch.float32,
                        device=qg.device)
        o = torch.zeros((B, chunk, Kv, G, dv), dtype=torch.float32,
                        device=qg.device)
        for kj in range(lo, hi + 1):
            sl = slice(kj * chunk, (kj + 1) * chunk)
            s = _scores(qs, k[:, sl], scale, cap)
            s = s + _mask_bias(qp, pos[sl], causal=causal, window=window,
                               k_valid=pos[sl] < Sq)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha.permute(0, 3, 1, 2)[..., None] + \
                _ctx(p, v[:, sl].float())
            m = m_new
        l = torch.clamp_min(l, 1e-20)
        out.append(o / l.permute(0, 3, 1, 2)[..., None])
    return torch.cat(out, dim=1)[:, :Sq].to(qg.dtype)


# ---------------------------------------------------------------------------
# Standard (GQA) attention layer: prefill / forward / decode
# ---------------------------------------------------------------------------

def _kv_weights(cfg: ArchConfig, p, tp):
    """-> (w_k, w_v, index): the KV projections of this rank's query heads
    (the whole ones without ``tp``), and the KV head of each local query
    head where they do not fall in equal groups (``Tp.kv_heads``)."""
    if tp is None or cfg.n_kv_heads % tp.tp == 0:
        return p["w_k"], p["w_v"], None
    lo, n, index = tp.kv_heads(cfg.n_heads, cfg.n_kv_heads)
    return (tp.enter(p["w_k"])[:, lo:lo + n],
            tp.enter(p["w_v"])[:, lo:lo + n], index)


def _per_head(kv, index):
    """KV heads [B, L, n, d] -> one per local query head where ``index``
    maps them."""
    return kv if index is None else kv.index_select(2, index.to(kv.device))


def _out(p, o, tp, seq=None):
    """The output projection of the rank's heads, summed over ``tp``; of
    its block of positions, laid end to end over ``seq``."""
    y = einsum("bshk,hkd->bsd", o, p["w_o"])
    if tp is not None:
        return tp.exit(y)
    return seq.gather_seq(y) if seq is not None else y


def _seq_on(seq, S: int):
    """``seq`` where it shards a sequence of ``S`` (more than one position,
    ``S / tp`` a rank), else None: the layer runs whole."""
    return seq if seq is not None and S > 1 and S % seq.tp == 0 else None


def _entered(p, names, mt):
    """``{name: p[name]}``, each entered over ``mt``'s model ranks (whole
    weights whose gradient each rank holds in part)."""
    return {n: mt.enter(p[n]) if mt is not None else p[n] for n in names}


def _seq_rows(seq, S: int, window: int, whole_kv: bool):
    """-> (query rows, key rows): this rank's block of ``S`` positions and
    the keys it reads (from ``window - 1`` before the block, or from 0;
    all ``S`` where ``whole_kv``: a cache is made); everything without
    ``seq``."""
    if seq is None:
        return slice(None), slice(None)
    rq = seq.block(S)
    k0 = 0 if whole_kv or not window else max(0, rq.start - window + 1)
    return rq, slice(k0, S if whole_kv else rq.stop)


def _attend_rows(q, k, v, positions, rq, rk, seq, *, impl, **kw):
    """``attend`` of the query rows ``rq`` over the key rows ``rk`` (the
    keys past the block dropped); the whole sequence without ``seq``."""
    if seq is None:
        return attend(q, k, v, impl=impl, **kw)
    nk = rq.stop - rk.start
    return attend(q, k[:, :nk], v[:, :nk], q_pos=positions[rq],
                  k_pos=positions[rk][:nk], **kw,
                  impl="chunked" if impl == "blocked_causal" else impl)


def _gqa_cache(cfg: ArchConfig, kind: str, k, v, S: int, L: int) -> dict:
    """The cache of a prefill over ``S`` positions: keys and values padded
    to ``L``, a local layer's last ``window`` as a ring buffer."""
    if kind == "local" and cfg.window and cfg.window < L and S >= cfg.window:
        L = cfg.window
        # ring-buffer layout: slot = pos % window
        return {"k": torch.roll(k[:, -L:], S % L, dims=1),
                "v": torch.roll(v[:, -L:], S % L, dims=1)}
    # (a local layer's prompt shorter than its window keeps the cache's
    # window length: positions < window are their own slots)
    L = min(L, cfg.window) if kind == "local" and cfg.window else L
    return {"k": F.pad(k, (0, 0, 0, 0, 0, L - S)),
            "v": F.pad(v, (0, 0, 0, 0, 0, L - S))}


def gqa_apply(cfg: ArchConfig, p, x, *, kind: str, positions, impl: str,
              chunk: int, cond=None, make_cache: int = 0, tp=None,
              seq=None):
    """x: [B,S,D]. kind: attn|local|cross (``cond`` [B,cond_len,D] gives
    cross attention's keys and values). ``tp``: this rank's heads of
    ``p``; ``seq``: the model ranks shard the sequence instead (``p``
    whole). Returns (y, cache_entry|None)."""
    B, S, D = x.shape
    if kind == "cross":
        return _cross_apply(cfg, p, x, cond, make_cache, tp)
    seq = _seq_on(seq, S)
    mt = tp or seq
    if mt is not None:
        x = mt.enter(x)
    w = _entered(p, ("w_q", "w_k", "w_v", "w_o"), seq)
    w_k, w_v, index = _kv_weights(cfg, w, tp)
    window = cfg.window if kind == "local" else 0
    rq, rk = _seq_rows(seq, S, window, bool(make_cache))
    q = einsum("bsd,dhk->bshk", x[:, rq], w["w_q"])
    k = einsum("bsd,dhk->bshk", x[:, rk], w_k)
    v = einsum("bsd,dhk->bshk", x[:, rk], w_v)
    if cfg.pos == "rope":
        q = rope(q, positions[rq], cfg.rope_theta)
        k = rope(k, positions[rk], cfg.rope_theta)
    o = _attend_rows(q, _per_head(k, index), _per_head(v, index), positions,
                     rq, rk, seq, causal=True, window=window,
                     cap=cfg.attn_logit_softcap,
                     scale=cfg.query_scale or None, impl=impl, chunk=chunk)
    y = _out(w, o, tp, seq)
    cache = _gqa_cache(cfg, kind, k, v, S, make_cache) if make_cache \
        else None
    return y, cache


def _cross_apply(cfg: ArchConfig, p, x, cond, make_cache: int, tp=None):
    """Queries from ``x``, keys and values from ``cond``, every key visible
    (the masked formula: flash takes only causal self attention). The
    cache is the keys and values at ``cond_len``, in the dtype the
    projections give (this rank's KV heads under ``tp``; where the ranks
    do not divide the heads the layer runs whole on every rank, its keys
    ``cond``'s few positions)."""
    if cond is None:
        raise ValueError(f"{cfg.name} cross-attends: the batch needs 'cond' "
                         f"[B, {cfg.cond_len}, {cfg.d_model}]")
    if tp is not None:
        x = tp.enter(x)
    w_k, w_v, index = _kv_weights(cfg, p, tp)
    q = einsum("bsd,dhk->bshk", x, p["w_q"])
    k = einsum("bsd,dhk->bshk", cond, w_k)
    v = einsum("bsd,dhk->bshk", cond, w_v)
    o = attend(q, _per_head(k, index), _per_head(v, index), causal=False,
               impl="masked", scale=cfg.query_scale or None,
               cap=cfg.attn_logit_softcap)
    return _out(p, o, tp), ({"k": k, "v": v} if make_cache else None)


def gqa_decode(cfg: ArchConfig, p, x1, cache: dict, pos: int, *, kind: str,
               tp=None):
    """Single-token decode. x1: [B,1,D]; pos: the current index. Writes the
    new key and value into ``cache`` in place (the JAX decode step donates
    its cache buffer) and returns it; cross attention reads its cache of
    ``cond``'s keys and values and writes nothing. ``tp``: this rank's
    heads of ``p`` and KV heads of ``cache``."""
    if tp is not None:
        x1 = tp.enter(x1)
    w_k, w_v, index = _kv_weights(cfg, p, tp)
    q = einsum("bsd,dhk->bshk", x1, p["w_q"])
    if kind == "cross":
        o = attend(q, _per_head(cache["k"], index),
                   _per_head(cache["v"], index), causal=False, impl="masked",
                   cap=cfg.attn_logit_softcap, scale=cfg.query_scale or None)
        return _out(p, o, tp), cache
    k1 = einsum("bsd,dhk->bshk", x1, w_k)
    v1 = einsum("bsd,dhk->bshk", x1, w_v)
    if cfg.pos == "rope":
        pvec = torch.full((1,), pos, dtype=torch.int32, device=x1.device)
        q = rope(q, pvec, cfg.rope_theta)
        k1 = rope(k1, pvec, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    L = k.shape[1]
    window = cfg.window if kind == "local" else 0
    slot = pos % L if window else pos
    k[:, slot] = k1[:, 0].to(k.dtype)
    v[:, slot] = v1[:, 0].to(v.dtype)
    idx = torch.arange(L, device=x1.device)
    # windowed: mask only; order is irrelevant (keys carry their rope)
    valid = ((idx <= pos % L) | (pos >= L)) if window else idx <= pos
    o = attend(q, _per_head(k, index), _per_head(v, index), causal=False,
               impl="masked", k_valid=valid, cap=cfg.attn_logit_softcap,
               scale=cfg.query_scale or None)
    return _out(p, o, tp), cache


def gqa_or_mla_apply(cfg: ArchConfig, p, x, *, kind: str, positions,
                     impl: str, chunk: int, cond=None, make_cache: int = 0,
                     tp=None, seq=None):
    """``tp``: the heads over the model ranks; ``seq``: the sequence
    instead (``gqa_apply``)."""
    if cfg.mla is not None and kind != "cross":
        return mla_apply(cfg, p, x, positions=positions, impl=impl,
                         chunk=chunk, make_cache=make_cache, tp=tp, seq=seq)
    return gqa_apply(cfg, p, x, kind=kind, positions=positions, impl=impl,
                     chunk=chunk, cond=cond, make_cache=make_cache, tp=tp,
                     seq=seq)


def gqa_or_mla_decode(cfg: ArchConfig, p, x1, cache: dict, pos: int, *,
                      kind: str, tp=None):
    if cfg.mla is not None and kind != "cross":
        return mla_decode(cfg, p, x1, cache, pos, tp=tp)
    return gqa_decode(cfg, p, x1, cache, pos, kind=kind, tp=tp)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

MLA_WHOLE = ("w_dq", "q_norm", "w_dkv", "kv_norm", "w_kr")   # no heads


def _mla_weights(p, tp, seq):
    """MLA's weights on this rank: under ``tp`` its heads of ``w_uq``,
    ``w_uk``, ``w_uv``, ``w_o`` and the whole rest entered; under ``seq``
    all whole and entered."""
    w = _entered(p, MLA_WHOLE, tp or seq)
    w.update(_entered(p, ("w_uq", "w_uk", "w_uv", "w_o"), seq))
    return w


def _mla_q(cfg: ArchConfig, p, x, positions):
    """-> (q_nope, q_rope) [B,S,H,*]."""
    m = cfg.mla
    cq = rmsnorm(einsum("bsd,dr->bsr", x, p["w_dq"]), p["q_norm"])
    q = einsum("bsr,rhk->bshk", cq, p["w_uq"])
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(cfg: ArchConfig, p, x, positions):
    """-> (ckv [B,S,kv_lora], kr [B,S,rope]): the latent and the shared
    rotated key."""
    ckv = rmsnorm(einsum("bsd,dr->bsr", x, p["w_dkv"]), p["kv_norm"])
    kr = rope(einsum("bsd,dr->bsr", x, p["w_kr"]), positions, cfg.rope_theta)
    return ckv, kr


def _mla_kv(cfg: ArchConfig, p, ckv, kr):
    """Decompressed keys ``[k_nope, kr]`` (the rotated key repeated per
    head) and values per head, for the heads of ``p``."""
    B, S, _ = ckv.shape
    H = p["w_uk"].shape[1]
    k_nope = einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    vfull = einsum("bsr,rhk->bshk", ckv, p["w_uv"])
    k_rope_h = kr[:, :, None, :].expand(B, S, H, cfg.mla.rope_head_dim)
    return torch.cat([k_nope, k_rope_h], dim=-1), vfull


def mla_apply(cfg: ArchConfig, p, x, *, positions, impl: str, chunk: int,
              make_cache: int = 0, tp=None, seq=None):
    """Prefill / forward MLA in the decompressed form (exact): keys
    ``[k_nope, kr]`` and values per head from the latent. ``attend`` runs
    its masked, chunked or blocked formula (the flash kernel takes one head
    dim for q, k and v). The cache keeps the latent and the rotated key,
    padded to ``make_cache``. ``tp``: this rank's heads; ``seq``: its
    block of positions (``gqa_apply``)."""
    m = cfg.mla
    S = x.shape[1]
    seq = _seq_on(seq, S)
    mt = tp or seq
    if mt is not None:
        x = mt.enter(x)
    w = _mla_weights(p, tp, seq)
    rq, rk = _seq_rows(seq, S, 0, bool(make_cache))
    q = torch.cat(_mla_q(cfg, w, x[:, rq], positions[rq]), dim=-1)
    ckv, kr = _mla_latent(cfg, w, x[:, rk], positions[rk])
    k, vfull = _mla_kv(cfg, w, ckv, kr)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    o = _attend_rows(q, k, vfull, positions, rq, rk, seq, causal=True,
                     impl=impl, chunk=chunk, scale=scale)
    y = _out(w, o, tp, seq)
    cache = None
    if make_cache:
        pad = (0, 0, 0, make_cache - S)
        cache = {"ckv": F.pad(ckv, pad), "kr": F.pad(kr, pad)}
    return y, cache


def mla_decode(cfg: ArchConfig, p, x1, cache: dict, pos: int, tp=None):
    """Absorbed-matrix decode: ``w_uk`` folded into the query, scores and
    context against the latent cache, which takes the new ``ckv`` and
    ``kr`` in place. Scores are f32 sums of the operands' products (the
    reference's ``preferred_element_type=float32``: a bf16 einsum would
    round them to bf16); the probabilities go back to the cache's dtype
    for the context, as the reference casts them, and the context is
    summed in f32 and rounded once, as ``_ctx`` does. ``tp``: this rank's
    heads score against the whole cache, and ``w_o`` sums them."""
    m = cfg.mla
    if tp is not None:
        x1 = tp.enter(x1)
    w = _mla_weights(p, tp, None)
    pvec = torch.full((1,), pos, dtype=torch.int32, device=x1.device)
    q_nope, q_rope = _mla_q(cfg, w, x1, pvec)
    ckv1, kr1 = _mla_latent(cfg, w, x1, pvec)
    ckv, kr = cache["ckv"], cache["kr"]
    ckv[:, pos] = ckv1[:, 0].to(ckv.dtype)
    kr[:, pos] = kr1[:, 0].to(kr.dtype)
    q_eff = einsum("bshk,rhk->bshr", q_nope, w["w_uk"])
    s = torch.einsum("bshr,btr->bhst", q_eff.float(), ckv.float()) + \
        torch.einsum("bshk,btk->bhst", q_rope.float(), kr.float())
    s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    valid = torch.arange(ckv.shape[1], device=x1.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(ckv.dtype)
    ctx_c = torch.einsum("bhst,btr->bshr", pr.float(), ckv.float()).to(
        ckv.dtype)
    o = einsum("bshr,rhk->bshk", ctx_c, w["w_uv"])
    return _out(w, o, tp), cache


class Attention(ParamModule):
    """``w_q [D,H,dh]``, ``w_k``/``w_v [D,Kv,dh]``, ``w_o [H,dh,D]`` (cross
    attention's too); for MLA ``w_dq``, ``q_norm``, ``w_uq``, ``w_dkv``,
    ``kv_norm``, ``w_uk``, ``w_uv``, ``w_kr``, ``w_o``."""

    def __init__(self, cfg: ArchConfig, kind: str, *, device=None,
                 dtype=None):
        super().__init__(attn_schema(cfg, kind),
                         device=resolve_device(device), dtype=dtype)
        self.cfg, self.kind = cfg, kind

    def forward(self, x, *, positions, impl: str, chunk: int, cond=None,
                make_cache: int = 0):
        return gqa_or_mla_apply(self.cfg, self, x, kind=self.kind,
                                positions=positions, impl=impl, chunk=chunk,
                                cond=cond, make_cache=make_cache)
