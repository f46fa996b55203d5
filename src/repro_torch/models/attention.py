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

Every entry point takes the model axis as ``mt`` (a ``parallel/tp.py::Tp``;
None: no axis) and derives from it what each part does. A layer whose heads
the ranks divide takes this rank's heads (GQA's, and MLA's ``w_uq``, ``w_uk``,
``w_uv``, ``w_o``, its down projections and norms whole and entered).
Where the ranks do not divide the heads (``_seq_on``), the reference's
``seq_model`` fallback: the weights stay whole on every rank, each rank
computes the queries of its block of ``S / tp`` positions and the keys and
values that block reads, attends it at its positions, and the blocks are
laid end to end (``Tp.gather_seq``). Such a block never reaches the flash
kernel (which takes only default positions): it runs ``impl``'s formula,
``chunked`` for ``blocked_causal``, whose schedule takes no positions. A
sequence the ranks do not divide runs whole on every rank, and so does
cross attention's projection (its keys are ``cond``'s few positions).

The caches follow the reference's cache dims over the model axis
(``cache_cut``), whatever the heads do: a GQA cache holds this rank's KV heads where the ranks
divide them, else its ``dh / tp`` slice of every head, or under
``cfg.cache_seq_shard`` (internvl2) its block of positions; MLA's latent
``ckv`` its ``kv_lora / tp`` (``mla_cut``), ``kr`` whole. Prefill writes
this rank's part of the keys and values it computed (every KV head's,
gathered or projected again where the rank computed only some). Decode
against a head-dim or position cut scores every head on every rank and
combines the ranks' parts (``_decode_cut``: partial scores summed, or the
blocks' softmax by the log-sum-exp rule); MLA's decode sums the partial
latent scores over the ranks (``mla_decode``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compression import all_reduce
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


def cache_cut(cfg: ArchConfig, mt) -> str | None:
    """Where the model axis (``mt``, a ``parallel/tp.py::Tp``; None: no
    axis) cuts a GQA cache entry, as the reference's cache dims and
    ``spec_for``'s first fit put it: ``"seq"`` (the cache's positions)
    under ``cfg.cache_seq_shard``; else ``"kv_heads"`` where the ranks
    divide the KV heads; else ``"head_dim"`` where they divide ``dh``;
    else None (each rank keeps the KV heads its query heads read, or all
    of them where the ranks do not divide the heads)."""
    if mt is None:
        return None
    if cfg.cache_seq_shard:
        return "seq"
    if cfg.n_kv_heads % mt.tp == 0:
        return "kv_heads"
    return "head_dim" if cfg.dh % mt.tp == 0 else None


def mla_cut(cfg: ArchConfig, mt) -> bool:
    """Whether the model axis cuts MLA's latent ``ckv`` over ``kv_lora``
    (the reference's ``("batch", None, "head_dim")``); ``kr`` stays
    whole."""
    return mt is not None and cfg.mla.kv_lora_rank % mt.tp == 0


def cache_def(cfg: ArchConfig, kind: str, batch: int, max_len: int,
              tp=None) -> dict:
    """Shape template for a decode cache entry: ``[B, L, Kv, dh]`` k and v,
    ``L`` the window for a local layer with a window shorter than
    ``max_len``, ``cond_len`` for cross attention; for MLA the latent
    ``ckv [B, L, kv_lora]`` and the shared rotated key ``kr [B, L, rope]``. ``tp``: this model rank's
    part (``cache_cut``): ``L / tp`` positions, ``Kv / tp`` KV heads or
    ``dh / tp`` of each head; else the KV heads its query heads read
    (``Tp.kv_heads``) where the ranks divide the heads. MLA's ``ckv``
    holds ``kv_lora / tp`` where the ranks divide it (``mla_cut``)."""
    if kind not in ("attn", "local", "cross"):
        raise ValueError(kind)
    if cfg.mla is not None and kind != "cross":
        m = cfg.mla
        r = m.kv_lora_rank // (tp.tp if mla_cut(cfg, tp) else 1)
        return {
            "ckv": ParamDef((batch, max_len, r),
                            ("batch", None, "head_dim"), init="zeros"),
            "kr": ParamDef((batch, max_len, m.rope_head_dim),
                           ("batch", None, None), init="zeros"),
        }
    Kv, dh = cfg.n_kv_heads, cfg.dh
    L = min(max_len, cfg.window) if kind == "local" and cfg.window else max_len
    if kind == "cross":
        L = cfg.cond_len
    cut = cache_cut(cfg, tp)
    if cut == "seq":
        if L % tp.tp:
            raise ValueError(f"{cfg.name} cuts its cache's {L} positions "
                             f"over {tp.tp} model ranks: they must divide "
                             f"them")
        L //= tp.tp
    elif cut == "kv_heads":
        Kv //= tp.tp
    elif cut == "head_dim":
        dh //= tp.tp
    elif tp is not None and tp.on(cfg.n_heads):
        Kv = tp.kv_heads(cfg.n_heads, Kv)[1]
    dims = (("batch", "seq_model", None, None) if cfg.cache_seq_shard else
            ("batch", None, "kv_heads", "head_dim"))
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


def _heads_on(cfg: ArchConfig, mt):
    """``mt`` where it cuts the attention heads, else None."""
    return mt and mt.on(cfg.n_heads)


def _seq_on(cfg: ArchConfig, mt, S: int):
    """``mt`` where attention falls back to sharding a sequence of ``S``
    (the ranks do not divide the heads; more than one position, ``S / tp``
    a rank), else None: without ``_heads_on`` too the layer runs whole."""
    seq = mt and mt.seq(cfg.n_heads)
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


def _every_kv_head(cfg: ArchConfig, w, x, positions, k, v, mt):
    """Every KV head's keys and values at ``x``'s positions, from this
    rank's ``k``, ``v`` [B, S, n, dh]: as they are where they hold all;
    gathered over ``mt`` where it cuts the KV heads (``w_k`` this rank's);
    else projected again through the whole ``w_k``/``w_v`` (rotated at
    ``positions``, None: no rotation)."""
    Kv = cfg.n_kv_heads
    if k.shape[2] == Kv:
        return k, v
    if Kv % mt.tp == 0:
        return mt.whole_at(k, 2), mt.whole_at(v, 2)
    k = einsum("bsd,dhk->bshk", x, w["w_k"])
    v = einsum("bsd,dhk->bshk", x, w["w_v"])
    if positions is not None and cfg.pos == "rope":
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def _own(t, mt, axis: int):
    """This rank's block of ``t`` along ``axis``, in a tensor of its own
    (the whole one is not kept)."""
    return mt.own_at(t, axis).clone(memory_format=torch.contiguous_format)


def _cut_cache(cfg: ArchConfig, cache: dict, mt) -> dict:
    """A cache entry of every KV head at every position as this rank keeps
    it (``cache_cut``: ``"seq"`` its block of positions, ``"head_dim"``
    its slice of each head)."""
    axis = {"seq": 1, "head_dim": 3}[cache_cut(cfg, mt)]
    return {n: _own(t, mt, axis) for n, t in cache.items()}


def gqa_apply(cfg: ArchConfig, p, x, *, kind: str, positions, impl: str,
              chunk: int, cond=None, make_cache: int = 0, mt=None):
    """x: [B,S,D]. kind: attn|local|cross (``cond`` [B,cond_len,D] gives
    cross attention's keys and values). ``mt``: the model axis; ``p``
    holds this rank's heads where it cuts them (``_heads_on``), else the
    ranks shard the sequence (``_seq_on``, ``p`` whole) or the layer runs
    whole; the cache is cut as ``cache_cut`` says either way. Returns (y,
    cache_entry|None)."""
    B, S, D = x.shape
    if kind == "cross":
        return _cross_apply(cfg, p, x, cond, make_cache, mt)
    tp, seq = _heads_on(cfg, mt), _seq_on(cfg, mt, S)
    att = tp or seq
    if att is not None:
        x = att.enter(x)
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
    if not make_cache:
        return y, None
    if cache_cut(cfg, mt) in ("seq", "head_dim"):
        k, v = _every_kv_head(cfg, w, x[:, rk], positions[rk], k, v, mt)
        return y, _cut_cache(cfg, _gqa_cache(cfg, kind, k, v, S,
                                             make_cache), mt)
    return y, _gqa_cache(cfg, kind, k, v, S, make_cache)


def _cross_apply(cfg: ArchConfig, p, x, cond, make_cache: int, mt=None):
    """Queries from ``x``, keys and values from ``cond``, every key visible
    (the masked formula: flash takes only causal self attention). The
    cache is the keys and values at ``cond_len``, in the dtype the
    projections give, as ``mt`` cuts it (``cache_cut``; this rank's KV
    heads where it cuts the heads; where the ranks do not divide the heads the layer
    runs whole on every rank, its keys ``cond``'s few positions)."""
    if cond is None:
        raise ValueError(f"{cfg.name} cross-attends: the batch needs 'cond' "
                         f"[B, {cfg.cond_len}, {cfg.d_model}]")
    tp = _heads_on(cfg, mt)
    if tp is not None:
        x = tp.enter(x)
    w_k, w_v, index = _kv_weights(cfg, p, tp)
    q = einsum("bsd,dhk->bshk", x, p["w_q"])
    k = einsum("bsd,dhk->bshk", cond, w_k)
    v = einsum("bsd,dhk->bshk", cond, w_v)
    o = attend(q, _per_head(k, index), _per_head(v, index), causal=False,
               impl="masked", scale=cfg.query_scale or None,
               cap=cfg.attn_logit_softcap)
    if not make_cache:
        return _out(p, o, tp), None
    if cache_cut(cfg, mt) in ("seq", "head_dim"):
        k, v = _every_kv_head(cfg, p, cond, None, k, v, mt)
        return _out(p, o, tp), _cut_cache(cfg, {"k": k, "v": v}, mt)
    return _out(p, o, tp), {"k": k, "v": v}


def gqa_decode(cfg: ArchConfig, p, x1, cache: dict, pos: int, *, kind: str,
               mt=None):
    """Single-token decode. x1: [B,1,D]; pos: the current index. Writes the
    new key and value into ``cache`` in place (the JAX decode step donates
    its cache buffer) and returns it; cross attention reads its cache of
    ``cond``'s keys and values and writes nothing. ``mt``: the model axis;
    ``p`` holds this rank's heads where it cuts them (``_heads_on``), and
    its cut of ``cache`` (``cache_cut``) decides the attention: over the
    KV heads (or each rank's read heads) it runs here, over positions or
    the head dim in ``_decode_cut``."""
    if cache_cut(cfg, mt) in ("seq", "head_dim"):
        return _decode_cut(cfg, p, x1, cache, pos, kind, mt)
    tp = _heads_on(cfg, mt)
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


def _decode_cut(cfg: ArchConfig, p, x1, cache: dict, pos: int, kind: str,
                mt):
    """``gqa_decode`` against a cache ``mt`` cuts by positions or by head
    dim: every rank scores every head (the one token's queries gathered
    over ``mt`` where it cuts the heads; the new key and value of every
    KV head, from the whole ``w_k``/``w_v`` or gathered, rotated whole
    before this rank's part is written).

    - ``"head_dim"``: each rank's partial scores over its ``dh / tp`` are
      summed over ``mt`` in f32 (an all-reduce of [B, H, 1, L]) before the
      scale, softcap and mask; the softmax times this rank's slice of
      ``v`` is gathered on ``dh``. (The reference's comment says GSPMD
      re-gathers the cache instead, 2 Kv dh L elements a step; the scores
      are H L.)
    - ``"seq"``: the rank that holds ``pos``'s slot writes it; each rank
      scores its block of positions, and the blocks' softmax is combined
      over ``mt`` by the log-sum-exp rule (the max, then the sum, then
      the context, each an all-reduce), the probabilities rounded to
      ``v``'s dtype as the reference's are.

    The context of this rank's heads goes through its rows of ``w_o``
    (summed over ``mt``), or the whole ``w_o`` where the layer runs
    whole."""
    Kv, H, dh = cfg.n_kv_heads, cfg.n_heads, cfg.dh
    tp = _heads_on(cfg, mt)
    q = einsum("bsd,dhk->bshk", x1, p["w_q"])
    pvec = torch.full((1,), pos, dtype=torch.int32, device=x1.device)
    if cfg.pos == "rope" and kind != "cross":
        q = rope(q, pvec, cfg.rope_theta)
    if tp is not None:
        q = mt.whole_at(q, 2)
    k, v = cache["k"], cache["v"]
    cut = cache_cut(cfg, mt)
    L = k.shape[1] * (mt.tp if cut == "seq" else 1)
    lo = mt.rank * k.shape[1] if cut == "seq" else 0
    window = cfg.window if kind == "local" else 0
    if kind != "cross":
        k1 = einsum("bsd,dhk->bshk", x1, p["w_k"])
        v1 = einsum("bsd,dhk->bshk", x1, p["w_v"])
        if k1.shape[2] != Kv:                  # ``w_k`` cut over the heads
            k1, v1 = mt.whole_at(k1, 2), mt.whole_at(v1, 2)
        if cfg.pos == "rope":
            k1 = rope(k1, pvec, cfg.rope_theta)
        slot = pos % L if window else pos
        if cut == "head_dim":
            d = mt.block(dh)
            k[:, slot] = k1[:, 0, :, d].to(k.dtype)
            v[:, slot] = v1[:, 0, :, d].to(v.dtype)
        elif lo <= slot < lo + k.shape[1]:
            k[:, slot - lo] = k1[:, 0].to(k.dtype)
            v[:, slot - lo] = v1[:, 0].to(v.dtype)
        idx = torch.arange(L, device=x1.device)
        valid = ((idx <= pos % L) | (pos >= L)) if window else idx <= pos
        bias = torch.where(valid[lo:lo + k.shape[1]], 0.0, NEG_INF)
    else:
        bias = torch.zeros(k.shape[1], device=x1.device)
    B = q.shape[0]
    qg = q.reshape(B, 1, Kv, H // Kv, dh)
    scale = cfg.query_scale or 1.0 / math.sqrt(dh)
    cap = cfg.attn_logit_softcap
    if cut == "head_dim":
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[..., mt.block(dh)].float(),
                         k.float())
        s = all_reduce(s, mt.group) * scale
        s = (softcap(s, cap) if cap else s) + bias
        o = mt.whole_at(_ctx(torch.softmax(s, dim=-1), v), 4)
    else:
        s = _scores(qg, k, scale, cap) + bias
        m = s.amax(dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mt.group)
        e = torch.exp(s - m)
        pr = e / all_reduce(e.sum(dim=-1, keepdim=True), mt.group)
        o = torch.einsum("bkgqs,bskd->bqkgd", pr.to(v.dtype).float(),
                         v.float())
        o = all_reduce(o, mt.group).to(v.dtype)
    o = o.reshape(B, 1, H, dh)
    if tp is not None:
        h0, n = tp.heads(H)
        o = o[:, :, h0:h0 + n]
    return _out(p, o, tp), cache


def gqa_or_mla_apply(cfg: ArchConfig, p, x, *, kind: str, positions,
                     impl: str, chunk: int, cond=None, make_cache: int = 0,
                     mt=None):
    """``mt``: the model axis (``gqa_apply``)."""
    if cfg.mla is not None and kind != "cross":
        return mla_apply(cfg, p, x, positions=positions, impl=impl,
                         chunk=chunk, make_cache=make_cache, mt=mt)
    return gqa_apply(cfg, p, x, kind=kind, positions=positions, impl=impl,
                     chunk=chunk, cond=cond, make_cache=make_cache, mt=mt)


def gqa_or_mla_decode(cfg: ArchConfig, p, x1, cache: dict, pos: int, *,
                      kind: str, mt=None):
    if cfg.mla is not None and kind != "cross":
        return mla_decode(cfg, p, x1, cache, pos, mt=mt)
    return gqa_decode(cfg, p, x1, cache, pos, kind=kind, mt=mt)


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
              make_cache: int = 0, mt=None):
    """Prefill / forward MLA in the decompressed form (exact): keys
    ``[k_nope, kr]`` and values per head from the latent. ``attend`` runs
    its masked, chunked or blocked formula (the flash kernel takes one head
    dim for q, k and v). The cache keeps the latent and the rotated key,
    padded to ``make_cache``. ``mt``: the model axis, which cuts the heads
    or the positions as in ``gqa_apply``, and whose ranks keep their
    ``kv_lora / tp`` of the latent (``mla_cut``)."""
    m = cfg.mla
    S = x.shape[1]
    tp, seq = _heads_on(cfg, mt), _seq_on(cfg, mt, S)
    att = tp or seq
    if att is not None:
        x = att.enter(x)
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
        if mla_cut(cfg, mt):
            cache["ckv"] = _own(cache["ckv"], mt, 2)
    return y, cache


def mla_decode(cfg: ArchConfig, p, x1, cache: dict, pos: int, mt=None):
    """Absorbed-matrix decode: ``w_uk`` folded into the query, scores and
    context against the latent cache, which takes the new ``ckv`` and
    ``kr`` in place. Scores are f32 sums of the operands' products (the
    reference's ``preferred_element_type=float32``: a bf16 einsum would
    round them to bf16); the probabilities go back to the cache's dtype
    for the context, as the reference casts them, and the context is
    summed in f32 and rounded once, as ``_ctx`` does. ``mt``: the model
    axis; where it cuts the heads (``_heads_on``) ``p`` holds this rank's
    and ``w_o`` sums them. Where ``mt`` cuts the latent (``mla_cut``),
    every rank scores every head on its ``kv_lora / tp``: the absorbed
    queries (and the rotary ones) are gathered over the heads where ``mt``
    cuts them, the partial latent scores summed over ``mt``
    before the rotary term is added once, and the context's slices
    gathered back to the full ``kv_lora`` for this rank's heads of
    ``w_uv``."""
    m = cfg.mla
    tp = _heads_on(cfg, mt)
    if tp is not None:
        x1 = tp.enter(x1)
    w = _mla_weights(p, tp, None)
    pvec = torch.full((1,), pos, dtype=torch.int32, device=x1.device)
    q_nope, q_rope = _mla_q(cfg, w, x1, pvec)
    ckv1, kr1 = _mla_latent(cfg, w, x1, pvec)
    ckv, kr = cache["ckv"], cache["kr"]
    cut = mla_cut(cfg, mt)
    r = mt.block(m.kv_lora_rank) if cut else slice(None)
    ckv[:, pos] = ckv1[:, 0, r].to(ckv.dtype)
    kr[:, pos] = kr1[:, 0].to(kr.dtype)
    q_eff = einsum("bshk,rhk->bshr", q_nope, w["w_uk"])
    if cut and tp is not None:
        q_eff, q_rope = mt.whole_at(q_eff, 2), mt.whole_at(q_rope, 2)
    s = torch.einsum("bshr,btr->bhst", q_eff[..., r].float(), ckv.float())
    if cut:
        s = all_reduce(s, mt.group)
    s = s + torch.einsum("bshk,btk->bhst", q_rope.float(), kr.float())
    s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    valid = torch.arange(ckv.shape[1], device=x1.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(ckv.dtype)
    ctx_c = torch.einsum("bhst,btr->bshr", pr.float(), ckv.float()).to(
        ckv.dtype)
    if cut:
        ctx_c = mt.whole_at(ctx_c, 3)
        if tp is not None:
            h0, n = tp.heads(cfg.n_heads)
            ctx_c = ctx_c[:, :, h0:h0 + n]
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
