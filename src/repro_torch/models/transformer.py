"""Decoder stack (the JAX package's ``models/transformer.py``): attention
(full, local and MLA), SSD and RG-LRU layers, dense and MoE FFNs, gemma2's
post-block norms, MusicGen's cross attention after each attention layer's
mixer.

The reference stacks identical units and runs them under ``lax.scan``; here
the stack is an ``nn.ModuleList`` of per-layer ``Layer``s and the scan a
loop over units of ``len(cfg.pattern)`` layers, each under the
reference's rematerialisation policy (``remat``). ``plan_layers`` keeps
the reference's grouping (scan groups and a ``tail``), which
``models/convert.py`` reads to unstack a JAX parameter, router-bias or
cache tree, and ``models/model.py::reference_leaves`` to order
parameters as the reference's tree flattens them. A MoE layer's router
bias is a buffer of its ``moe`` module (``p["moe"]["bias"]``), where the
reference passes a separate ``biases`` tree.

Under tensor parallelism (``tp``, a ``parallel/tp.py::Tp``) each block
takes the rank's part of its weights: attention (GQA or MLA) its heads, or
its block of positions where the ranks do not divide the heads
(``Tp.seq``), the RG-LRU its state channels, the SSM its heads, a dense
FFN its hidden units (where ``tp`` divides each; ``Tp.on``), a MoE
layer's shared expert likewise beside the experts of ``ep``. Each block
runs its own
all-reduces, so a unit recomputed under ``remat`` runs them again, up
to the last tensor its backward needs (the non-reentrant checkpoint
stops there: the attention output's all-reduce runs again, the FFN
output's does not).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm, norm_schema
from repro_torch.models.params import ParamModule


# ---------------------------------------------------------------------------
# Layer planning
# ---------------------------------------------------------------------------

def ffn_kind(cfg: ArchConfig, layer_idx: int) -> str:
    if cfg.moe is not None:
        return "moe" if layer_idx >= cfg.moe.start_layer else (
            "dense" if cfg.d_ff else "none")
    if cfg.pattern[layer_idx % len(cfg.pattern)] == "ssm":
        return "none"
    return "dense" if cfg.d_ff else "none"


def plan_layers(cfg: ArchConfig):
    """-> (groups: list[(unit_sig, count)], tail: unit_sig|None), as the
    reference stacks its parameters. unit_sig = tuple of (kind, ffn) per
    layer in the unit."""
    n = cfg.n_layers
    u = len(cfg.pattern)
    kinds = cfg.layer_kinds
    ffns = [ffn_kind(cfg, i) for i in range(n)]
    full = n - (n % u)
    units = [tuple(zip(kinds[i:i + u], ffns[i:i + u])) for i in range(0, full, u)]
    tail = tuple(zip(kinds[full:], ffns[full:])) if n % u else None
    groups: list[tuple[tuple, int]] = []
    for sig in units:
        if groups and groups[-1][0] == sig:
            groups[-1] = (sig, groups[-1][1] + 1)
        else:
            groups.append((sig, 1))
    return groups, tail


def layer_plan(cfg: ArchConfig) -> list[tuple[str, str]]:
    """(kind, ffn) of every layer, in order."""
    return [(k, ffn_kind(cfg, i)) for i, k in enumerate(cfg.layer_kinds)]


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def _check_layer(kind: str, ffn: str) -> None:
    if kind not in ("attn", "local", "ssm", "rglru"):
        raise ValueError(kind)
    if ffn not in ("dense", "moe", "none"):
        raise ValueError(ffn)


def _cross(cfg: ArchConfig, kind: str) -> bool:
    """Whether the layer cross-attends (every attention layer of a
    ``cross_attn`` config)."""
    return cfg.cross_attn and kind in ("attn", "local")


def _mixer(kind: str) -> str:
    """The parameter (and cache) key of a layer's sequence mixer."""
    return {"ssm": "ssm", "rglru": "rec"}.get(kind, "attn")


def layer_schema(cfg: ArchConfig, kind: str, ffn: str) -> dict:
    _check_layer(kind, ffn)
    D = cfg.d_model
    s: dict = {"norm1": norm_schema(cfg.norm, D)}
    if kind == "ssm":
        s["ssm"] = ssm_mod.ssm_schema(cfg)
    elif kind == "rglru":
        s["rec"] = rglru_mod.rglru_schema(cfg)
    else:
        s["attn"] = attn_mod.attn_schema(cfg, kind)
        if _cross(cfg, kind):
            s["norm_x"] = norm_schema(cfg.norm, D)
            s["cross"] = attn_mod.attn_schema(cfg, "cross")
    if cfg.post_block_norm:
        s["post1"] = norm_schema(cfg.norm, D)
    if ffn != "none":
        s["norm2"] = norm_schema(cfg.norm, D)
        if ffn == "moe":
            s["moe"] = moe_mod.moe_schema(cfg)
        else:
            s["ffn"] = ffn_mod.ffn_schema(cfg)
        if cfg.post_block_norm:
            s["post2"] = norm_schema(cfg.norm, D)
    return s


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _maybe_post(cfg: ArchConfig, p, key: str, y):
    if cfg.post_block_norm:
        return apply_norm(cfg.norm, y, p.get(key))
    return y


def _ffn(cfg: ArchConfig, rc: RunConfig, p, h, ffn: str, ep=None, tp=None):
    """The layer's FFN on ``h`` (a MoE layer's experts over ``ep``'s model
    ranks, the exchange int8 under ``rc.compress_moe_a2a``; a dense FFN's
    hidden units over ``tp``'s). -> (y, aux: a MoE layer's ``load`` and
    ``aux_loss``, else empty)."""
    if ffn == "moe":
        # ``tp`` only on a model axis: one card keeps the call it had
        kw = {"tp": tp} if tp is not None else {}
        return moe_mod.moe_apply(cfg, p["moe"], h, p["moe"]["bias"], ep=ep,
                                 compress_a2a=rc.compress_moe_a2a, **kw)
    return ffn_mod.ffn_apply(cfg, p["ffn"], h,
                             tp and tp.on(cfg.d_ff)), {}


def _rec(cfg: ArchConfig, kind: str, tp):
    """``tp`` where it cuts a recurrent mixer (the SSM's heads, the
    RG-LRU's width), else None."""
    if tp is None:
        return None
    if kind == "ssm":
        return tp.on(cfg.ssm.n_heads(cfg.d_model), "state")
    return tp.on(cfg.rglru.lru_width or cfg.d_model, "state")


def layer_apply(cfg: ArchConfig, rc: RunConfig, p, x, *, kind: str, ffn: str,
                positions, cond=None, make_cache_len: int = 0, ep=None,
                tp=None):
    """Full-sequence path (prefill / forward). ``cond`` [B,cond_len,D]
    feeds a cross-attending layer; ``ep`` (``parallel/ep.py::Ep``) splits
    a MoE layer's experts over the model ranks, ``tp``
    (``parallel/tp.py::Tp``) the dense blocks. Returns (x, cache,
    aux)."""
    cache: dict = {}
    aux: dict = {}
    h = apply_norm(cfg.norm, x, p.get("norm1"))
    if kind == "ssm":
        y, c = ssm_mod.ssm_apply(cfg, p["ssm"], h,
                                 make_cache=bool(make_cache_len),
                                 tp=_rec(cfg, kind, tp))
    elif kind == "rglru":
        y, c = rglru_mod.rglru_apply(cfg, p["rec"], h,
                                     make_cache=bool(make_cache_len),
                                     tp=_rec(cfg, kind, tp))
    else:
        y, c = attn_mod.gqa_or_mla_apply(
            cfg, p["attn"], h, kind=kind, positions=positions,
            impl=rc.attention_impl_for(h.shape[1]), chunk=rc.attn_chunk,
            make_cache=make_cache_len, mt=tp)
    if c:
        cache[_mixer(kind)] = c
    x = x + _maybe_post(cfg, p, "post1", y)
    if _cross(cfg, kind):
        y, c = attn_mod.gqa_apply(cfg, p["cross"],
                                  apply_norm(cfg.norm, x, p.get("norm_x")),
                                  kind="cross", positions=positions,
                                  impl="masked", chunk=rc.attn_chunk,
                                  cond=cond, make_cache=make_cache_len,
                                  mt=tp)
        if c:
            cache["cross"] = c
        x = x + y
    if ffn != "none":
        h = apply_norm(cfg.norm, x, p.get("norm2"))
        y, aux = _ffn(cfg, rc, p, h, ffn, ep, tp)
        x = x + _maybe_post(cfg, p, "post2", y)
    return x, cache, aux


def layer_decode(cfg: ArchConfig, rc: RunConfig, p, cache: dict, x1, pos: int,
                 *, kind: str, ffn: str, ep=None, tp=None):
    """Single-token path. Returns (x1, cache): an attention layer's keys and
    values are written in place, a recurrent layer's state comes back new,
    a cross-attending layer's ``cross`` entry is read and kept.
    ``ep``/``tp``: the model axis, as in ``layer_apply`` (the caches hold
    this rank's part, ``attention.cache_cut``, and its recurrent
    channels; a layer whose heads the ranks do not divide computes whole
    on every rank against its part of the cache)."""
    h = apply_norm(cfg.norm, x1, p.get("norm1"))
    if kind == "ssm":
        y, c = ssm_mod.ssm_decode(cfg, p["ssm"], h, cache["ssm"], pos,
                                  _rec(cfg, kind, tp))
    elif kind == "rglru":
        y, c = rglru_mod.rglru_decode(cfg, p["rec"], h, cache["rec"], pos,
                                      _rec(cfg, kind, tp))
    else:
        y, c = attn_mod.gqa_or_mla_decode(cfg, p["attn"], h, cache["attn"],
                                          pos, kind=kind, mt=tp)
    x1 = x1 + _maybe_post(cfg, p, "post1", y)
    new_cache = {_mixer(kind): c}
    if _cross(cfg, kind):
        y, new_cache["cross"] = attn_mod.gqa_decode(
            cfg, p["cross"], apply_norm(cfg.norm, x1, p.get("norm_x")),
            cache["cross"], pos, kind="cross", mt=tp)
        x1 = x1 + y
    if ffn != "none":
        h = apply_norm(cfg.norm, x1, p.get("norm2"))
        x1 = x1 + _maybe_post(cfg, p, "post2",
                              _ffn(cfg, rc, p, h, ffn, ep, tp)[0])
    return x1, new_cache


class Layer(ParamModule):
    """``norm1``, the mixer (``attn``, an ``Attention``; ``ssm``; or
    ``rec``, RG-LRU), ``norm_x`` and ``cross`` (an ``Attention``) where the
    layer cross-attends, ``post1`` where the config has post-block norms,
    and ``norm2``, ``ffn`` (``FFN``) or ``moe`` (``MoE``), ``post2`` for a
    layer with an FFN: the reference's per-layer parameter names."""

    def __init__(self, cfg: ArchConfig, kind: str, ffn: str, *, device=None,
                 dtype=None):
        device = resolve_device(device)
        schema = layer_schema(cfg, kind, ffn)
        super().__init__(device=device)
        self.cfg, self.kind, self.ffn_kind = cfg, kind, ffn
        for name, sub in schema.items():
            if name in ("attn", "cross"):
                mod = attn_mod.Attention(cfg, kind if name == "attn" else
                                         "cross", device=device, dtype=dtype)
            elif name == "ffn":
                mod = ffn_mod.FFN(cfg, device=device, dtype=dtype)
            elif name == "moe":
                mod = moe_mod.MoE(cfg, device=device, dtype=dtype)
            else:
                mod = ParamModule(sub, device=device, dtype=dtype)
            self.add_module(name, mod)

    def forward(self, x, *, rc: RunConfig, positions, cond=None,
                make_cache_len: int = 0):
        return layer_apply(self.cfg, rc, self, x, kind=self.kind,
                           ffn=self.ffn_kind, positions=positions, cond=cond,
                           make_cache_len=make_cache_len)


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------

def _dots_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: save the outputs of matrix
    products without a batch dimension (``mm``, ``addmm``, and the ``bmm``
    of one batch that ``torch.einsum`` makes of a product with none);
    recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(policy: str, fn):
    """``fn`` under the reference's rematerialisation ``policy``
    (``RunConfig.remat``): ``"full"`` keeps only its inputs and recomputes the
    rest in the backward (a flash launch runs again there), ``"dots"``
    also keeps the outputs of matrix products without batch dimensions,
    ``"none"`` keeps everything. Only where a graph is being recorded:
    serving and ``no_grad`` calls run ``fn`` as it is."""
    if policy not in ("none", "full", "dots"):
        raise ValueError(policy)
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {} if policy == "full" else {
        "context_fn": lambda: create_selective_checkpoint_contexts(
            _dots_policy)}
    # nothing in a unit draws random numbers, so no RNG state is kept for
    # the recompute (on the card keeping it clones the CUDA generator's
    # state twice a unit, host operators a census would count)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 preserve_rng_state=False, **kw)


def stack_apply(cfg: ArchConfig, rc: RunConfig, layers, x, *, positions,
                cond=None, make_cache_len: int = 0, fsdp=None, ep=None,
                tp=None):
    """Run every layer in order, ``len(cfg.pattern)`` layers a unit (the
    reference's scan step; the last unit may be short, its ``tail``), each
    unit under ``remat``. ``layers``: the per-layer parameters (an
    ``nn.ModuleList`` of ``Layer``s or a list of dicts). Under FSDP
    (``fsdp``, a ``parallel/fsdp.py::Fsdp``; ``layers`` hold shards) a
    unit's weights are gathered inside the function ``remat`` wraps, so
    "full" and "dots" gather them again in the backward instead of keeping
    them, and "none" keeps them, as the reference does. ``ep``/``tp``: the
    model axis (``layer_apply``). Returns (x,
    caches, auxs): one cache dict per layer (empty when ``make_cache_len``
    is 0) and one aux dict per layer (a MoE layer's ``load`` and
    ``aux_loss``, else empty)."""
    plan = layer_plan(cfg)
    layers = list(layers)
    if len(layers) != len(plan):
        raise ValueError(f"{len(layers)} layers for a plan of {len(plan)}")
    u = len(cfg.pattern)
    caches, auxs = [], []
    for start in range(0, len(plan), u):
        def unit(x, start=start):
            cs, aus = [], []
            ps = layers[start:start + u]
            if fsdp is not None:
                ps = fsdp.gather_trees(ps)
            for p, (kind, ffn) in zip(ps, plan[start:start + u]):
                x, c, a = layer_apply(cfg, rc, p, x, kind=kind, ffn=ffn,
                                      positions=positions, cond=cond,
                                      make_cache_len=make_cache_len, ep=ep,
                                      tp=tp)
                cs.append(c)
                aus.append(a)
            return x, cs, aus
        x, cs, aus = remat(rc.remat, unit)(x)
        caches += cs
        auxs += aus
    return x, caches, auxs


def stack_decode(cfg: ArchConfig, rc: RunConfig, layers, cache: list, x1,
                 pos: int, fsdp=None, ep=None, tp=None):
    """One token through every layer (``layer_decode``), ``len(cfg.pattern)``
    layers a unit. Under FSDP (``fsdp``; ``layers`` hold shards) a unit's
    weights are gathered just before it runs, every step, as
    ``stack_apply`` gathers them. -> (x1, the new cache, one dict a
    layer)."""
    plan = layer_plan(cfg)
    layers = list(layers)
    if not len(layers) == len(cache) == len(plan):
        raise ValueError(f"{len(layers)} layers and {len(cache)} caches for "
                         f"a plan of {len(plan)}")
    u = len(cfg.pattern)
    new_cache = []
    for start in range(0, len(plan), u):
        ps = layers[start:start + u]
        if fsdp is not None:
            ps = fsdp.gather_trees(ps)
        for p, c, (kind, ffn) in zip(ps, cache[start:start + u],
                                     plan[start:start + u]):
            x1, nc = layer_decode(cfg, rc, p, c, x1, pos, kind=kind,
                                  ffn=ffn, ep=ep, tp=tp)
            new_cache.append(nc)
    return x1, new_cache


# ---------------------------------------------------------------------------
# Cache defs
# ---------------------------------------------------------------------------

def cache_schema(cfg: ArchConfig, batch: int, max_len: int, tp=None) -> list:
    """One ParamDef tree per layer (``{"attn": {"k", "v"}}``, for MLA
    ``{"attn": {"ckv", "kr"}}``, ``{"ssm": {"conv_x", "conv_B", "conv_C",
    "state"}}`` or ``{"rec": {"conv", "state"}}``; a cross-attending layer
    adds ``"cross": {"k", "v"}`` at ``cond_len``), matching the cache
    prefill produces and decode consumes (``tp``: this rank's part of the
    attention caches, ``attention.cache_def``, its SSM heads and RG-LRU
    channels)."""
    out = []
    for kind, ffn in layer_plan(cfg):
        _check_layer(kind, ffn)
        if kind == "ssm":
            c = ssm_mod.ssm_cache_def(cfg, batch, _rec(cfg, kind, tp))
        elif kind == "rglru":
            c = rglru_mod.rglru_cache_def(cfg, batch, _rec(cfg, kind, tp))
        else:
            c = attn_mod.cache_def(cfg, kind, batch, max_len, tp)
        layer = {_mixer(kind): c}
        if _cross(cfg, kind):
            layer["cross"] = attn_mod.cache_def(cfg, "cross", batch, max_len,
                                                tp)
        out.append(layer)
    return out
