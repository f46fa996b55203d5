"""LM wrapper: embedding, stack, head, prefill/decode (the JAX package's
``models/model.py``, serving parts).

``LM`` is an ``nn.Module`` whose parameters keep the reference schema's
names and per-layer shapes (``embed.tok [Vp,D]``, ``stack.<i>.attn.w_q
[D,H,dh]``, ``final_norm.scale``, ``head.w [D,Vp]``, DeepSeek's ``mtp``
block) and whose buffers hold the MoE router biases (``stack.<i>.moe.bias
[E_pad]``, zeros as the reference draws them); ``init`` fills it from a
seed. The plain functions (``forward``, ``prefill``, ``decode_step``) take
the config, a ``RunConfig`` and the parameters, as the reference's do;
``loss_fn`` (next-token CE, the MoE aux losses, DeepSeek's MTP loss) is
the training loss. ``reference_leaves`` orders the parameters as the
reference's stacked tree flattens, for the bucketed optimizer and
Adafactor's stacked states.
Every entry point that allocates takes ``device=``: ``None`` means the card,
and without one it raises unless given ``device="cpu"``.

Under tensor parallelism (``tp``, a ``parallel/tp.py::Tp``; ``params``
this rank's part, ``init(..., part=)``) the embedding, and the head (the
tied embedding serving both), hold this rank's ``Vp / tp`` vocabulary
rows: the lookup is ``Tp.embed``, ``forward`` returns this rank's logit
columns, ``loss_fn`` takes the vocab-parallel cross entropy
(``Tp.cross_entropy``), and ``prefill``/``decode_step`` gather the whole
logits for the serving loop.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (apply_norm, cross_entropy, einsum,
                                       norm_schema, sinusoidal_pos, softcap)
from repro_torch.models.params import (ParamDef, ParamModule, init_module,
                                       init_params, init_tensor,
                                       schema_leaves, tree_map_schema)


# ---------------------------------------------------------------------------
# Schema and module
# ---------------------------------------------------------------------------

def model_schema(cfg: ArchConfig) -> dict:
    """The parameter schema, one entry of ``stack`` per layer (the router
    biases are not parameters: ``moe.moe_bias_def``)."""
    D, Vp = cfg.d_model, cfg.vocab_padded
    s: dict = {
        "embed": {"tok": ParamDef((Vp, D), ("vocab", "embed"))},
        "stack": [tfm.layer_schema(cfg, k, f) for k, f in tfm.layer_plan(cfg)],
        "final_norm": norm_schema(cfg.norm, D),
    }
    if not cfg.tie_embeddings:
        s["head"] = {"w": ParamDef((D, Vp), ("embed", "vocab"))}
    if cfg.mtp:
        s["mtp"] = {
            "norm_h": norm_schema(cfg.norm, D),
            "norm_e": norm_schema(cfg.norm, D),
            "proj": ParamDef((2 * D, D), (None, "embed")),
            "layer": tfm.layer_schema(cfg, "attn", "dense"),
            "final_norm": norm_schema(cfg.norm, D),
        }
    return s


class LM(ParamModule):
    """``embed``, ``stack`` (an ``nn.ModuleList`` of ``Layer``s),
    ``final_norm``, ``head`` where untied and ``mtp`` where the config has
    it. Parameters are allocated, not initialised: ``init`` draws them,
    ``convert.params_from_numpy`` loads them. ``dtype`` None keeps the
    schema's (bf16; the router, RG-LRU's ``lam`` and the biases f32)."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=None):
        device = resolve_device(device)
        schema = model_schema(cfg)
        super().__init__(device=device)
        self.cfg = cfg
        self.embed = ParamModule(schema["embed"], device=device, dtype=dtype)
        self.stack = nn.ModuleList(tfm.Layer(cfg, k, f, device=device,
                                             dtype=dtype)
                                   for k, f in tfm.layer_plan(cfg))
        self.final_norm = ParamModule(schema["final_norm"], device=device,
                                      dtype=dtype)
        if "head" in schema:
            self.head = ParamModule(schema["head"], device=device,
                                    dtype=dtype)
        if "mtp" in schema:
            self.mtp = ParamModule(schema["mtp"], device=device, dtype=dtype)

    def forward(self, tokens, rc: RunConfig | None = None, **inputs):
        """tokens [B,S] (and ``cond``/``prefix`` where the config reads
        them) -> logits [B,S,Vp]."""
        return forward(self.cfg, rc or RunConfig(), self,
                       {"tokens": tokens, **inputs})[0]


def init(cfg: ArchConfig, seed: int = 0, *, device=None, dtype=None,
         part=None) -> LM:
    """An ``LM`` with weights drawn from ``seed`` (per-path generators on its
    device, ``params.init_tensor``) and zero router biases; under ``part``
    (a layout with ``shard_module``: ``parallel/tp.py::Tp``,
    ``parallel/fsdp.py::Fsdp``) this rank's part of each as the layout
    cuts it (each parameter drawn whole, then cut)."""
    if part is None:
        lm = LM(cfg, device=device, dtype=dtype)
        init_module(lm, model_schema(cfg), seed=seed)
        return lm
    device = resolve_device(device)
    leaves = schema_leaves(model_schema(cfg))
    lm = LM(cfg, device="meta", dtype=dtype)
    part.shard_module(lm, lambda name, p: init_tensor(
        name.split("."), leaves[name], seed=seed, device=device,
        dtype=p.dtype))
    for mod in lm.modules():
        for n, b in mod._buffers.items():
            mod._buffers[n] = torch.zeros(b.shape, dtype=b.dtype,
                                          device=device)
    return lm


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _vocab(cfg: ArchConfig, tp):
    """``tp`` where it cuts the vocabulary, else None."""
    return tp and tp.on(cfg.vocab_padded)


def _embed(cfg: ArchConfig, params, tokens, positions, prefix=None, tp=None):
    """Token embeddings [B,S,D]: scaled where the config says, plus the
    sinusoidal table at ``positions`` (MusicGen), and with the first ``P``
    rows replaced by ``prefix`` [B,P,D] where given (InternVL2's patch
    embeddings). ``tp``: the table holds this rank's vocabulary rows."""
    tv = _vocab(cfg, tp)
    table = params["embed"]["tok"]
    x = tv.embed(table, tokens) if tv else table[tokens]   # gather [B,S,D]
    if cfg.scale_embedding:
        # the reference multiplies by a numpy f32 scalar, which JAX does not
        # treat as weakly typed: a bf16 embedding becomes f32, and so does
        # the whole stream after it
        x = x.to(torch.promote_types(x.dtype, torch.float32)) * \
            float(np.sqrt(cfg.d_model).astype(np.float32))
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(positions, cfg.d_model, x.dtype)
    if prefix is not None:
        P, S = prefix.shape[1], x.shape[1]
        if S < P:
            raise ValueError(f"a prefix of {P} embeddings needs at least {P} "
                             f"tokens, got {S}")
        x = torch.cat([prefix.to(x.dtype), x[:, P:]], dim=1)
    return x


def _head(cfg: ArchConfig, params, x, tp=None):
    """Logits [B,S,Vp] (this rank's vocabulary columns under ``tp``)."""
    w = params["head"]["w"] if not cfg.tie_embeddings else \
        params["embed"]["tok"].T
    tv = _vocab(cfg, tp)
    if tv:
        x = tv.enter(x)
    logits = einsum("bsd,dv->bsv", x, w)
    return softcap(logits, cfg.final_logit_softcap)


def gather_outer(cfg: ArchConfig, params, fsdp) -> dict:
    """Under FSDP (``fsdp``; ``params`` an ``LM`` of shards) the weights
    outside the stack, gathered in one call: the embedding (the head too
    where tied: one tensor, its two gradients reduce-scattered as one sum),
    the final norm and the head. Without FSDP ``params`` as it is."""
    if fsdp is None:
        return params
    names = [n for n in ("embed", "final_norm", "head") if n in params]
    return dict(zip(names, fsdp.gather_trees([params[n] for n in names])))


def forward(cfg: ArchConfig, rc: RunConfig, params, batch, *,
            make_cache_len: int = 0, fsdp=None, outer=None, ep=None,
            tp=None):
    """batch: tokens [B,S], and ``cond`` [B,cond_len,D] (cross attention)
    or ``prefix`` [B,P,D] (embeddings in place of the first P tokens') where
    the config reads them. Returns (logits, cache, aux, x), as the
    reference: ``cache`` and ``aux`` one dict per layer (``aux``: a MoE
    layer's ``load`` and ``aux_loss``). ``fsdp``: ``params`` holds this
    rank's FSDP shards (``parallel/fsdp.py``), gathered as they are needed
    (``gather_outer``, or ``outer`` where the caller has gathered them; a
    unit at a time in ``stack_apply``). ``ep`` (``parallel/ep.py::Ep``):
    the MoE layers' experts over the model ranks, ``params`` holding this
    rank's. ``tp`` (``parallel/tp.py::Tp``): ``params`` this rank's part
    of every tensor the model axis cuts; the logits are this rank's
    vocabulary columns where it cuts the vocabulary."""
    unknown = batch.keys() - {"tokens", "cond", "prefix"}
    if unknown:
        raise ValueError(f"unknown batch inputs {sorted(unknown)}")
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    if outer is None:
        outer = gather_outer(cfg, params, fsdp)
    x = _embed(cfg, outer, tokens, positions, batch.get("prefix"), tp)
    x, cache, aux = tfm.stack_apply(cfg, rc, params["stack"], x,
                                    positions=positions,
                                    cond=batch.get("cond"),
                                    make_cache_len=make_cache_len,
                                    fsdp=fsdp, ep=ep, tp=tp)
    x = apply_norm(cfg.norm, x, outer.get("final_norm"))
    return _head(cfg, outer, x, tp), cache, aux, x


def loss_fn(cfg: ArchConfig, rc: RunConfig, params, batch, *, fsdp=None,
            ep=None, tp=None):
    """Next-token CE (+ MoE aux + optional MTP), the reference's
    ``loss_fn``. The last position carries no label, nor do the first
    ``cfg.prefix_embeds`` (patch embeddings, InternVL2); every MoE layer's
    ``aux_loss`` is added, and ``0.3 * mtp_loss`` where the config has
    multi-token prediction (under rematerialisation, as the reference's).
    -> (loss, (metrics, aux)): ``ce_loss``, ``moe_aux_loss`` (with MoE),
    ``mtp_loss`` (with MTP) and ``loss``; ``aux`` one dict per layer, as
    ``forward``'s. ``fsdp``: ``params`` holds FSDP shards, as in
    ``forward``; the MTP block's are gathered inside its remat. ``ep``,
    ``tp``: as in ``forward`` (the MTP block's layer is dense, and only
    configs that ``tp`` leaves whole have one); every model rank returns
    the same loss."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    outer = gather_outer(cfg, params, fsdp)
    logits, _, aux, h = forward(cfg, rc, params, batch, fsdp=fsdp,
                                outer=outer, ep=ep, tp=tp)
    labels = torch.cat([tokens[:, 1:], tokens.new_full((B, 1), -1)], dim=1)
    if cfg.prefix_embeds:
        pmask = torch.arange(S, device=tokens.device) < cfg.prefix_embeds
        labels = torch.where(pmask[None, :], -1, labels)
    tv = _vocab(cfg, tp)
    ce = tv.cross_entropy if tv else cross_entropy
    loss = ce(logits, labels, vocab_real=cfg.vocab)
    metrics = {"ce_loss": loss}
    aux_losses = [a["aux_loss"] for a in aux if "aux_loss" in a]
    if aux_losses:
        al = sum(a.sum() for a in aux_losses)
        loss = loss + al
        metrics["moe_aux_loss"] = al
    if cfg.mtp:
        def run_mtp(t, hh):
            if fsdp is None:
                return mtp_loss(cfg, rc, params, t, hh)
            m = fsdp.gather_trees([params["mtp"]])[0]
            return mtp_loss(cfg, rc, {**outer, "mtp": m}, t, hh)
        mtp = tfm.remat("full", run_mtp)(tokens, h)
        loss = loss + 0.3 * mtp
        metrics["mtp_loss"] = mtp
    metrics["loss"] = loss
    return loss, (metrics, aux)


def mtp_loss(cfg: ArchConfig, rc: RunConfig, params, tokens, h):
    """Depth-1 multi-token prediction (the reference's ``_mtp_loss``):
    predict token t+2 from the trunk's final state at t and the embedding
    of t+1, through the ``mtp`` block's norms, projection, one dense
    attention layer and the shared head."""
    m = params["mtp"]
    B, S = tokens.shape
    e = params["embed"]["tok"][tokens[:, 1:]]              # embed of t+1
    hh = apply_norm(cfg.norm, h[:, :-1], m["norm_h"])
    ee = apply_norm(cfg.norm, e, m["norm_e"])
    z = einsum("bsd,de->bse", torch.cat([hh, ee], dim=-1), m["proj"])
    z, _, _ = tfm.layer_apply(cfg, rc, m["layer"], z, kind="attn",
                              ffn="dense",
                              positions=torch.arange(S - 1,
                                                     device=tokens.device))
    z = apply_norm(cfg.norm, z, m["final_norm"])
    logits = _head(cfg, params, z)
    labels = torch.cat([tokens[:, 2:], tokens.new_full((B, 1), -1)], dim=1)
    return cross_entropy(logits, labels, vocab_real=cfg.vocab)


def _whole(cfg: ArchConfig, logits, tp):
    tv = _vocab(cfg, tp)
    return tv.gather_vocab(logits) if tv else logits


def prefill(cfg: ArchConfig, rc: RunConfig, params, batch, max_len: int, *,
            ep=None, tp=None):
    """-> (cache, last_logits [B,Vp]). ``ep``/``tp``: the model axis, as
    in ``forward``; the cache holds this rank's KV heads, the logits are
    whole on every rank."""
    logits, cache, _, _ = forward(cfg, rc, params, batch,
                                  make_cache_len=max_len, ep=ep, tp=tp)
    return cache, _whole(cfg, logits[:, -1], tp)


def decode_step(cfg: ArchConfig, rc: RunConfig, params, cache, token,
                pos: int, *, ep=None, tp=None):
    """token: [B,1] int, pos: the current index -> (logits [B,Vp], cache),
    the cache updated in place (a cross-attention layer reads its ``cross``
    entry and leaves it). ``ep``/``tp``: as in ``prefill``."""
    pvec = torch.full((1,), int(pos), dtype=torch.int32, device=token.device)
    x = _embed(cfg, params, token, pvec, tp=tp)
    x, cache = tfm.stack_decode(cfg, rc, params["stack"], cache, x, int(pos),
                                ep=ep, tp=tp)
    x = apply_norm(cfg.norm, x, params.get("final_norm"))
    return _whole(cfg, _head(cfg, params, x, tp)[:, 0], tp), cache


def stub_frontend(cfg: ArchConfig, batch: int, seed: int = 0, *,
                  device=None) -> dict:
    """The batch inputs of the frontends the configs stub (MusicGen's
    EnCodec/T5 conditioning, InternVL2's InternViT patch embeddings), drawn
    from ``seed`` in bf16 as the reference's smoke batches are: ``cond``
    [batch, cond_len, D] where the config cross-attends, ``prefix`` [batch,
    prefix_embeds, D] where it takes patch embeddings; empty otherwise."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = {"cond": cfg.cond_len if cfg.cross_attn else 0,
              "prefix": cfg.prefix_embeds}
    return {k: torch.randn(batch, n, cfg.d_model, generator=g,
                           device=device).to(torch.bfloat16)
            for k, n in shapes.items() if n}


# ---------------------------------------------------------------------------
# Cache and analytic parameter counts
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device=None, tp=None, dtype=None) -> list:
    """Zeros in the cache schema's layout and dtype (bf16, as the
    reference's ``init_cache``; ``dtype``: every tensor in that dtype
    instead); ``tp``: this rank's KV heads."""
    return init_params(tfm.cache_schema(cfg, batch, max_len, tp),
                       device=resolve_device(device), dtype=dtype)


def count_params_analytic(cfg: ArchConfig) -> int:
    """Non-embedding parameters (the 6ND count; every expert counted)."""
    total = 0

    def add(path, pd: ParamDef):
        nonlocal total
        sp = "/".join(map(str, path))
        if "embed" in sp or (not cfg.tie_embeddings and sp.startswith("head")):
            return                          # embeddings excluded from 6ND
        total += math.prod(pd.shape)

    tree_map_schema(add, model_schema(cfg))
    return total


def count_params_total(cfg: ArchConfig) -> int:
    total = 0

    def add(path, pd: ParamDef):
        nonlocal total
        total += math.prod(pd.shape)

    tree_map_schema(add, model_schema(cfg))
    return total


# ---------------------------------------------------------------------------
# The reference's leaf order
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RefLeaf:
    """One leaf of the reference's parameter tree: its key path
    (``"stack/g0/l0/attn/w_q"``), the port's parameters laid end to end in
    it (one per layer of a scan group, in layer order; one otherwise), and
    whether it is stacked (a scan group's leaf, ``[n_units, ...]`` in the
    reference, even for one unit)."""
    key: str
    names: tuple[str, ...]
    stacked: bool


def reference_leaves(cfg: ArchConfig) -> list[RefLeaf]:
    """The reference's parameter leaves in ``jax.tree.flatten`` order (dict
    keys sorted at every level), each naming the port's parameters
    (``LM.named_parameters``) it holds. Buckets filled in this order hold
    the reference's elements at the reference's offsets."""
    schema = model_schema(cfg)

    def names(idx, stacked):
        return lambda path, pd: (tuple(f"stack.{i}." + ".".join(path)
                                       for i in idx), stacked)

    tree = {k: tree_map_schema(
        lambda path, pd, k=k: ((".".join((k,) + path),), False), v)
        for k, v in schema.items() if k != "stack"}
    groups, tail = tfm.plan_layers(cfg)
    stack, first = {}, 0
    for gi, (sig, cnt) in enumerate(groups):
        u = len(sig)
        stack[f"g{gi}"] = {
            f"l{li}": tree_map_schema(
                names([first + j * u + li for j in range(cnt)], True),
                tfm.layer_schema(cfg, kind, ffn))
            for li, (kind, ffn) in enumerate(sig)}
        first += u * cnt
    if tail is not None:
        stack["tail"] = {f"l{li}": tree_map_schema(
            names([first + li], False), tfm.layer_schema(cfg, kind, ffn))
            for li, (kind, ffn) in enumerate(tail)}
    tree["stack"] = stack
    out: list[RefLeaf] = []

    def walk(node, path):
        if isinstance(node, tuple):
            out.append(RefLeaf("/".join(path), *node))
            return
        for k in sorted(node):
            walk(node[k], path + (k,))
    walk(tree, ())
    return out
