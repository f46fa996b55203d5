"""Decoder stack (the JAX package's ``models/transformer.py``, attention
layers with dense FFNs).

The reference stacks identical units and runs them under ``lax.scan``; here
the stack is an ``nn.ModuleList`` of per-layer ``Layer``s and the scan a
loop. ``plan_layers`` keeps the reference's grouping, which
``models/convert.py`` reads to unstack a JAX parameter tree. SSM, RG-LRU,
MoE, cross-attention and post-block norms are not ported (ROADMAP queue 1
item 6) and raise.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.attention import unported
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

def _check_ported(cfg: ArchConfig, kind: str, ffn: str) -> None:
    if kind not in ("attn", "local"):
        raise unported(f"{kind!r} layers")
    if ffn not in ("dense", "none"):
        raise unported(f"{ffn!r} FFN layers")
    if cfg.cross_attn:
        raise unported("cross attention")
    if cfg.post_block_norm:
        raise unported("post-block norms")


def layer_schema(cfg: ArchConfig, kind: str, ffn: str) -> dict:
    _check_ported(cfg, kind, ffn)
    D = cfg.d_model
    s: dict = {"norm1": norm_schema(cfg.norm, D),
               "attn": attn_mod.attn_schema(cfg, kind)}
    if ffn != "none":
        s["norm2"] = norm_schema(cfg.norm, D)
        s["ffn"] = ffn_mod.ffn_schema(cfg)
    return s


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def layer_apply(cfg: ArchConfig, rc: RunConfig, p, x, *, kind: str, ffn: str,
                positions, make_cache_len: int = 0):
    """Full-sequence path (prefill / forward). Returns (x, cache)."""
    cache: dict = {}
    h = apply_norm(cfg.norm, x, p.get("norm1"))
    y, c = attn_mod.gqa_or_mla_apply(
        cfg, p["attn"], h, kind=kind, positions=positions,
        impl=rc.attention_impl_for(h.shape[1]), chunk=rc.attn_chunk,
        make_cache=make_cache_len)
    if c:
        cache["attn"] = c
    x = x + y
    if ffn != "none":
        h = apply_norm(cfg.norm, x, p.get("norm2"))
        x = x + ffn_mod.ffn_apply(cfg, p["ffn"], h)
    return x, cache


def layer_decode(cfg: ArchConfig, rc: RunConfig, p, cache: dict, x1, pos: int,
                 *, kind: str, ffn: str):
    """Single-token path. Returns (x1, cache), the cache updated in place."""
    h = apply_norm(cfg.norm, x1, p.get("norm1"))
    y, c = attn_mod.gqa_or_mla_decode(cfg, p["attn"], h, cache["attn"], pos,
                                      kind=kind)
    x1 = x1 + y
    if ffn != "none":
        h = apply_norm(cfg.norm, x1, p.get("norm2"))
        x1 = x1 + ffn_mod.ffn_apply(cfg, p["ffn"], h)
    return x1, {"attn": c}


class Layer(ParamModule):
    """``norm1``, ``attn`` (``Attention``), and ``norm2``, ``ffn`` (``FFN``)
    for a layer with an FFN: the reference's per-layer parameter names."""

    def __init__(self, cfg: ArchConfig, kind: str, ffn: str, *, device=None,
                 dtype=None):
        device = resolve_device(device)
        schema = layer_schema(cfg, kind, ffn)
        super().__init__(device=device)
        self.cfg, self.kind, self.ffn_kind = cfg, kind, ffn
        self.norm1 = ParamModule(schema["norm1"], device=device, dtype=dtype)
        self.attn = attn_mod.Attention(cfg, kind, device=device, dtype=dtype)
        if ffn != "none":
            self.norm2 = ParamModule(schema["norm2"], device=device,
                                     dtype=dtype)
            self.ffn = ffn_mod.FFN(cfg, device=device, dtype=dtype)

    def forward(self, x, *, rc: RunConfig, positions, make_cache_len: int = 0):
        return layer_apply(self.cfg, rc, self, x, kind=self.kind,
                           ffn=self.ffn_kind, positions=positions,
                           make_cache_len=make_cache_len)


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------

def stack_apply(cfg: ArchConfig, rc: RunConfig, layers, x, *, positions,
                make_cache_len: int = 0):
    """Run every layer in order. ``layers``: the per-layer parameters (an
    ``nn.ModuleList`` of ``Layer``s or a list of dicts). Returns (x, caches),
    one cache dict per layer (empty when ``make_cache_len`` is 0)."""
    caches = []
    for p, (kind, ffn) in zip(layers, layer_plan(cfg), strict=True):
        x, c = layer_apply(cfg, rc, p, x, kind=kind, ffn=ffn,
                           positions=positions, make_cache_len=make_cache_len)
        caches.append(c)
    return x, caches


def stack_decode(cfg: ArchConfig, rc: RunConfig, layers, cache: list, x1,
                 pos: int):
    new_cache = []
    for p, c, (kind, ffn) in zip(layers, cache, layer_plan(cfg), strict=True):
        x1, nc = layer_decode(cfg, rc, p, c, x1, pos, kind=kind, ffn=ffn)
        new_cache.append(nc)
    return x1, new_cache


# ---------------------------------------------------------------------------
# Cache defs
# ---------------------------------------------------------------------------

def cache_schema(cfg: ArchConfig, batch: int, max_len: int) -> list:
    """One ``{"attn": {"k", "v"}}`` ParamDef tree per layer, matching the
    cache prefill produces and decode consumes."""
    out = []
    for kind, ffn in layer_plan(cfg):
        _check_ported(cfg, kind, ffn)
        out.append({"attn": attn_mod.cache_def(cfg, kind, batch, max_len)})
    return out
