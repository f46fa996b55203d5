"""Mixture of experts on one card (the JAX package's ``models/moe.py``).

The reference runs an expert-parallel body under ``shard_map``: tokens are
dispatched into per-destination send buffers by cumulative position,
exchanged with an all-to-all over the ``model`` axis, re-bucketed per
expert, run through batched expert GEMMs and returned the same way. On one
card (``tp = 1``, no FSDP gather) the exchange is the identity, and that is
the case ported here, step for step:

- tokens in chunks of ``chunk_tokens``, the last one zero-padded (its
  padding is routed too and counts in ``load``, as in the reference);
- the router in f32, ``route`` with both routers (softmax top-k;
  DeepSeek's sigmoid plus a bias that enters the selection only);
- the reference's capacity arithmetic (``_capacity``): ``C_send`` rows of
  the send buffer, then ``C_exp`` rows an expert;
- dispatch in token-major order by exclusive cumulative sums, so exactly
  the reference's assignments drop (``_dispatch``);
- the expert GEMMs as batched einsums over ``[E_pad, C_exp, D]``, the
  outputs gathered back and weighted by the gates in the activation dtype.

Top-k is a stable descending sort, so equal scores pick the lower expert
index first, as ``jax.lax.top_k`` does (the zero-padded tokens of the
last chunk tie on every expert).

``load`` counts assignments (no gradient flows through it, as the
reference's ``stop_gradient``); ``aux_loss`` (the load-balance loss times
``aux_loss_coef``) carries the router's gradient into the training loss.
``update_router_bias`` is the training step's router-bias update.

On a data-only mesh (FSDP, ``training/step.py``) each rank runs this body
on its own rows, as the reference's data shards chunk their own tokens,
so capacity and drops match; the expert weights arrive whole through the
unit's FSDP gather (``parallel/fsdp.py``), and the step sums ``load``
over the data-parallel ranks and averages the metrics (the reference's
``psum``/``pmean`` in its body).

Not ported: the expert-parallel path (``tp > 1``: experts over a
``model`` axis, the int8-compressed all-to-all; ROADMAP queue 1 item 3);
``moe_apply(mesh=)`` raises, and so does the train step on a mesh with a
``model`` axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.attention import unported
from repro_torch.models.common import activate, einsum
from repro_torch.models.ffn import ffn_apply, ffn_schema
from repro_torch.models.params import ParamDef, ParamModule


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def moe_schema(cfg: ArchConfig) -> dict:
    m = cfg.moe
    D, E, F_ = cfg.d_model, m.n_experts_padded, m.d_ff_expert
    s = {
        "router": ParamDef((D, E), (None, None), dtype="float32"),
        "w_gate": ParamDef((E, D, F_), ("experts", None, "expert_ff")),
        "w_up": ParamDef((E, D, F_), ("experts", None, "expert_ff")),
        "w_down": ParamDef((E, F_, D), ("experts", "expert_ff", None)),
    }
    if m.n_shared:
        s["shared"] = ffn_schema(cfg, d_ff=m.d_ff_shared * m.n_shared)
    return s


def moe_bias_def(cfg: ArchConfig) -> ParamDef:
    """Aux-loss-free router bias (DeepSeek): non-gradient state."""
    return ParamDef((cfg.moe.n_experts_padded,), (None,), init="zeros",
                    dtype="float32")


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index. -> (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(m: MoEConfig, logits, bias):
    """logits: [n, E_pad] fp32. Returns (gates [n,K], ids [n,K], probs
    [n,E_pad]); padded experts are masked with -1e9 and never selected."""
    E, Epad = m.n_experts, m.n_experts_padded
    pad_mask = torch.zeros(Epad, dtype=torch.float32, device=logits.device)
    pad_mask[E:] = -1e9
    logits = logits.float() + pad_mask
    if m.router == "sigmoid_bias":
        s = torch.sigmoid(logits)
        _, ids = top_k(s + bias.detach() + pad_mask, m.top_k)
        g = torch.gather(s, -1, ids)
        g = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
        return g * m.routed_scaling, ids, s
    probs = torch.softmax(logits, dim=-1)
    g, ids = top_k(probs, m.top_k)
    g = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
    return g, ids, probs


# ---------------------------------------------------------------------------
# The one-card body
# ---------------------------------------------------------------------------

def _capacity(m: MoEConfig, T: int) -> tuple[int, int, int]:
    """The reference's chunk and capacities at ``tp = 1`` (``moe.py:150-164``):
    -> (n tokens a chunk, C_send send rows, C_exp rows an expert)."""
    n = min(m.chunk_tokens, T)
    A = n * m.top_k
    C_send = max(8, int(math.ceil(A * m.capacity_factor / 8.0)) * 8)
    rows = C_send
    C_exp = max(8, int(math.ceil(rows / m.n_experts_padded
                                 * m.capacity_factor / 8.0)) * 8)
    return n, C_send, C_exp


def _dispatch(ids, C_send: int, C_exp: int, Epad: int):
    """ids: [n, K] -> (keep [A], slot [A]) for the A = n K assignments in
    token-major order: an assignment is kept if it is among the first
    ``C_send`` (the send buffer's rows) and fewer than ``C_exp`` earlier
    kept assignments chose its expert (exclusive cumulative sum); ``slot``
    is its row of the ``[E_pad * C_exp]`` expert buffer, ``E_pad * C_exp``
    for a dropped one."""
    e = ids.reshape(-1)
    A = e.numel()
    sent = torch.arange(A, device=e.device) < C_send
    # one-hot laid out [E_pad, A], so the scan runs along the inner axis (on
    # the card a scan along the outer axis of an [A, E_pad] one-hot took 390
    # of a granite prefill's 520 ms of device time); the inclusive count at
    # an assignment's own expert, less one, is the reference's exclusive
    # cumulative sum
    oh = (torch.arange(Epad, device=e.device)[:, None] == e) & sent
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32).gather(0, e[None])[0] - 1
    keep = sent & (pos < C_exp)
    slot = torch.where(keep, e * C_exp + pos, Epad * C_exp)
    return keep, slot


def _moe_body(cfg: ArchConfig, p, x, bias):
    """x: [T, D] tokens. -> (y [T, D], load [E_pad] f32, aux scalar f32,
    keep [T_padded, K] bool: which assignments of ``ids`` were computed)."""
    m = cfg.moe
    T, D = x.shape
    Epad, K = m.n_experts_padded, m.top_k
    n, C_send, C_exp = _capacity(m, T)
    nch = -(-T // n)
    xp = F.pad(x, (0, 0, 0, nch * n - T))
    tok = torch.arange(n, device=x.device).repeat_interleave(K)
    router = p["router"].float()
    ys, loads, auxs, keeps = [], [], [], []
    for c in range(nch):
        xt = xp[c * n:(c + 1) * n]
        gates, ids, probs = route(m, xt.float() @ router, bias)
        keep, slot = _dispatch(ids, C_send, C_exp, Epad)
        buf = xt.new_zeros(Epad * C_exp + 1, D).index_copy_(0, slot, xt[tok])
        buf = buf[:-1].view(Epad, C_exp, D)
        h = einsum("ecd,edf->ecf", buf, p["w_up"])
        g = einsum("ecd,edf->ecf", buf, p["w_gate"])
        ob = einsum("ecf,efd->ecd", activate(cfg.act, g) * h, p["w_down"])
        ob = torch.cat([ob.reshape(Epad * C_exp, D), ob.new_zeros(1, D)])
        y_a = ob[slot] * keep[:, None].to(ob.dtype)
        ys.append((y_a.view(n, K, D) * gates[..., None].to(ob.dtype)).sum(1))
        # counted by index_add_: bincount would wait for the card
        load = torch.zeros(Epad, dtype=torch.float32, device=x.device)
        load.index_add_(0, ids.reshape(-1), load.new_ones(ids.numel()))
        ce = load / torch.clamp_min(load.sum(), 1.0)
        auxs.append((probs.mean(0) * ce).sum() * m.n_experts)
        loads.append(load)
        keeps.append(keep.view(n, K))
    y = torch.cat(ys)[:T]
    return (y, torch.stack(loads).sum(0), torch.stack(auxs).mean(),
            torch.cat(keeps))


# ---------------------------------------------------------------------------
# Public apply
# ---------------------------------------------------------------------------

def moe_apply(cfg: ArchConfig, p, x, bias, *, mesh=None):
    """x: [B,S,D] -> (y, {"load": [E_pad], "aux_loss": scalar}), the
    shared expert added. ``mesh`` (expert parallelism over a ``model``
    axis) is not ported."""
    if mesh is not None:
        raise unported("the expert-parallel MoE (tp > 1: the int8 "
                       "all-to-all, the FSDP gather)", 3)
    m = cfg.moe
    B, S, D = x.shape
    y, load, aux, _ = _moe_body(cfg, p, x.reshape(B * S, D), bias)
    y = y.reshape(B, S, D)
    if m.n_shared:
        y = y + ffn_apply(cfg, p["shared"], x)
    aux_loss = aux * m.aux_loss_coef if m.aux_loss_coef else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return y, {"load": load, "aux_loss": aux_loss}


def update_router_bias(m: MoEConfig, bias, load, *, gamma: float = 0.001):
    """Aux-loss-free bias update (DeepSeek-V3): push load toward uniform,
    ``gamma`` times the sign of each real expert's shortfall from the mean
    load (padded experts keep their bias), in f32, cast to the bias's
    dtype. A training step's state update, never a gradient's."""
    load = load.float()
    target = load.sum() / m.n_experts
    real = torch.zeros(m.n_experts_padded, dtype=torch.float32,
                       device=load.device)
    real[:m.n_experts] = 1.0
    delta = gamma * torch.sign(target - load)
    return (bias + delta * real).to(bias.dtype)


class MoE(ParamModule):
    """``router [D,E_pad]`` (f32), ``w_gate``/``w_up [E_pad,D,F]``,
    ``w_down [E_pad,F,D]``, ``shared`` (an FFN's parameters) where the
    config has shared experts, and the router ``bias [E_pad]`` (f32), a
    buffer: state the router reads, not a weight."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=None):
        device = resolve_device(device)
        super().__init__(moe_schema(cfg), device=device, dtype=dtype)
        self.cfg = cfg
        self.register_buffer("bias", torch.zeros(
            moe_bias_def(cfg).shape, dtype=torch.float32, device=device))

    def forward(self, x):
        return moe_apply(self.cfg, self, x, self.bias)
