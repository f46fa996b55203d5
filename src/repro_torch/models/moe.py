"""Mixture of experts (the JAX package's ``models/moe.py``).

The reference runs an expert-parallel body under ``shard_map``: tokens are
dispatched into per-destination send buffers by cumulative position,
exchanged with an all-to-all over the ``model`` axis, re-bucketed per
expert, run through batched expert GEMMs and returned the same way. The
port runs it step for step:

- tokens in chunks of ``chunk_tokens``, the last one zero-padded (its
  padding is routed too and counts in ``load``, as in the reference);
- the router in f32, ``route`` with both routers (softmax top-k;
  DeepSeek's sigmoid plus a bias that enters the selection only);
- the reference's capacity arithmetic (``_ep_capacity``): ``C_send`` rows a
  destination rank, then ``C_exp`` rows an expert;
- dispatch in token-major order by exclusive cumulative sums, so exactly
  the reference's assignments drop;
- the expert GEMMs as batched einsums over ``[E_loc, C_exp, D]``, the
  outputs returned and weighted by the gates in the activation dtype.

On one card (``tp = 1``) the exchange is the identity and the two
capacity steps merge (``_moe_body``, ``_dispatch``). With experts over
a ``model`` axis of ``tp`` ranks (``ep``, a ``parallel/ep.py::Ep``;
``_ep_body``) each rank holds ``E_pad / tp`` experts and dispatches its
``1/tp`` slice of every chunk's tokens (where ``tp`` divides the chunk;
otherwise every rank dispatches the whole chunk and ``load`` is divided
by ``tp``), the send buffers go through an all-to-all, int8 with one
scale a destination block in both directions under ``compress_a2a``, the
receive side re-buckets in [source rank, send slot] order, and ``y`` is
all-gathered over ``model``; ``load`` is summed and ``aux`` averaged over
``model``. ``moe_ep_plain`` is the same function in one process: the
``tp`` slices in a loop, the capacities counted one assignment at a
time, no collective.

Top-k is a stable descending sort, so equal scores pick the lower expert
index first, as ``jax.lax.top_k`` does (the zero-padded tokens of the
last chunk tie on every expert).

``load`` counts assignments (no gradient flows through it, as the
reference's ``stop_gradient``); ``aux_loss`` (the load-balance loss times
``aux_loss_coef``) carries the router's gradient into the training loss.
``update_router_bias`` is the training step's router-bias update.

On the data axes each rank runs the body on its own rows, as the
reference's data shards chunk their own tokens, so capacity and drops
match; under FSDP the expert weights (this rank's experts) arrive through
the unit's gather (``parallel/fsdp.py``), and the step sums ``load`` over
the data-parallel ranks and averages the metrics (the reference's
``psum``/``pmean`` in its body).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core.compression import all_reduce
from repro_torch.core.device import resolve_device
from repro_torch.models.common import activate, einsum
from repro_torch.models.ffn import ffn_apply, ffn_schema
from repro_torch.models.params import ParamDef, ParamModule
from repro_torch.parallel.ep import q8_roundtrip


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
    """The reference's chunk and capacities at ``tp = 1``: -> (n tokens a
    chunk, C_send send rows, C_exp rows an expert)."""
    n, _, C_send, C_exp, _ = _ep_capacity(m, T, 1)
    return n, C_send, C_exp


def _ep_capacity(m: MoEConfig, T: int, tp: int
                 ) -> tuple[int, int, int, int, bool]:
    """The reference's chunk and capacities (``moe.py:150-164``) on ``tp``
    model ranks: -> (n tokens a chunk, ntok tokens a rank dispatches,
    C_send send rows a destination rank, C_exp rows an expert, whether the
    ranks take slices of the chunk)."""
    n = min(m.chunk_tokens, T)
    sliced = tp > 1 and n % tp == 0
    ntok = n // tp if sliced else n
    A = ntok * m.top_k
    C_send = max(8, int(math.ceil(A / tp * m.capacity_factor / 8.0)) * 8)
    rows = tp * C_send
    C_exp = max(8, int(math.ceil(rows / (m.n_experts_padded // tp)
                                 * m.capacity_factor / 8.0)) * 8)
    return n, ntok, C_send, C_exp, sliced


def _positions(e, n_buckets: int, valid=None):
    """e: [A] bucket indices -> each element's exclusive position among the
    earlier (``valid``) elements of its bucket. The one-hot is laid out
    [n_buckets, A], so the scan runs along the inner axis (on the card a
    scan along the outer axis of an [A, E_pad] one-hot took 390 of a
    granite prefill's 520 ms of device time)."""
    oh = torch.arange(n_buckets, device=e.device)[:, None] == e
    if valid is not None:
        oh = oh & valid
    return torch.cumsum(oh, dim=1, dtype=torch.int32).gather(0, e[None])[0] - 1


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
    pos = _positions(e, Epad, sent)
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
# The expert-parallel body
# ---------------------------------------------------------------------------

def _ep_body(cfg: ArchConfig, p, x, bias, ep, compress: bool = False, *,
             with_keep: bool = False):
    """The reference's ``_moe_body`` on this rank of ``ep`` (``tp`` model
    ranks): x [T, D] this data rank's tokens (the same on every model
    rank), ``p``'s experts this rank's ``E_loc``. -> (y [T, D], load
    [E_pad] summed over ``model``, aux averaged over ``model``, keep: with
    ``with_keep``, [nch * ntok, K], which of this rank's dispatched
    assignments were computed, else None)."""
    m = cfg.moe
    T, D = x.shape
    Epad, K, tp = m.n_experts_padded, m.top_k, ep.tp
    ep.check(Epad)
    E_loc = Epad // tp
    n, ntok, C_send, C_exp, sliced = _ep_capacity(m, T, tp)
    rows = tp * C_send
    nch = -(-T // n)
    rank = ep.rank
    xp = F.pad(ep.enter(x), (0, 0, 0, nch * n - T))
    router = ep.enter(p["router"]).float()
    tok = torch.arange(ntok, device=x.device).repeat_interleave(K)
    ys, loads, auxs, keeps = [], [], [], []
    for c in range(nch):
        xt = xp[c * n:(c + 1) * n]
        if sliced:
            xt = xt[rank * ntok:(rank + 1) * ntok]
        gates, ids, probs = route(m, xt.float() @ router, bias)
        e = ids.reshape(-1)
        # send side: a slot in the destination rank's buffer, by position
        dest = torch.div(e, E_loc, rounding_mode="floor")
        posd = _positions(dest, tp)
        keep = posd < C_send
        slot = torch.where(keep, dest * C_send + posd, rows)
        xs = xt.new_zeros(rows + 1, D).index_copy_(0, slot, xt[tok])
        es = torch.zeros(rows + 1, dtype=torch.int32, device=x.device)
        es.index_copy_(0, slot, torch.where(keep, e + 1, 0).to(torch.int32))
        xr = ep.all_to_all(xs[:rows].view(tp, C_send, D), compress)
        with torch.no_grad():
            er = ep.all_to_all(es[:rows].view(tp, C_send)).reshape(rows)
        # receive side: rows in [source rank, send slot] order, C_exp an
        # expert
        valid = er > 0
        e_loc = torch.clamp(er.long() - 1 - rank * E_loc, 0, E_loc - 1)
        p2 = _positions(e_loc, E_loc, valid)
        keep2 = valid & (p2 < C_exp)
        slot2 = torch.where(keep2, e_loc * C_exp + p2, E_loc * C_exp)
        buf = xt.new_zeros(E_loc * C_exp + 1, D).index_copy_(
            0, slot2, xr.reshape(rows, D))
        buf = buf[:-1].view(E_loc, C_exp, D)
        h = einsum("ecd,edf->ecf", buf, p["w_up"])
        g = einsum("ecd,edf->ecf", buf, p["w_gate"])
        ob = einsum("ecf,efd->ecd", activate(cfg.act, g) * h, p["w_down"])
        ob = torch.cat([ob.reshape(E_loc * C_exp, D), ob.new_zeros(1, D)])
        back = (ob[slot2] * keep2[:, None].to(ob.dtype)).view(tp, C_send, D)
        back = ep.all_to_all(back, compress).reshape(rows, D)
        back = torch.cat([back, back.new_zeros(1, D)])
        y_a = back[slot] * keep[:, None].to(back.dtype)
        ys.append((y_a.view(ntok, K, D)
                   * gates[..., None].to(back.dtype)).sum(1))
        load = torch.zeros(Epad, dtype=torch.float32, device=x.device)
        load.index_add_(0, e, load.new_ones(e.numel()))
        ce = load / torch.clamp_min(load.sum(), 1.0)
        auxs.append((probs.mean(0) * ce).sum() * m.n_experts)
        loads.append(load)
        if with_keep:
            with torch.no_grad():
                k2 = ep.all_to_all(keep2.to(torch.int32).view(tp, C_send))
                k2 = torch.cat([k2.reshape(rows), k2.new_zeros(1)])
                keeps.append((keep & (k2[slot] > 0)).view(ntok, K))
    y = torch.stack(ys)
    y = ep.gather_slices(y) if sliced else ep.replicated(y.reshape(-1, D))
    with torch.no_grad():
        load = all_reduce(torch.stack(loads).sum(0), ep.group)
        if not sliced:
            load = load / tp
    aux = ep.mean(torch.stack(auxs).mean())
    return (y[:T], load, aux, torch.cat(keeps) if with_keep else None)


# ---------------------------------------------------------------------------
# The plain expert-parallel version: the tp slices in one process
# ---------------------------------------------------------------------------

def _send_plan(ids, tp: int, E_loc: int, C_send: int):
    """One source rank's send side, counted an assignment at a time:
    ids [A] -> {dest: [(assignment, slot)]} for the kept ones."""
    out: dict = {d: [] for d in range(tp)}
    for a, e in enumerate(ids.tolist()):
        d = e // E_loc
        if len(out[d]) < C_send:
            out[d].append((a, len(out[d])))
    return out


def moe_ep_plain(cfg: ArchConfig, p, x, bias, tp: int, *,
                 compress_a2a: bool = False):
    """The expert-parallel body in one process, the reference's capacity
    rules on ``tp`` model ranks and no collective: every rank's routing,
    its send buffers (a dense [C_send, D] block per source and
    destination, int8 round-tripped under ``compress_a2a``, the cotangent
    too), each destination's experts over its received rows in [source,
    slot] order, the return blocks, each rank's output. x [T, D]; ``p``
    holds every expert. -> (ys: each model rank's y [T, D] (the same
    tensor on every rank where they take slices), load [E_pad], aux,
    keeps: each rank's keep over the assignments it dispatched, [nch *
    ntok, K])."""
    m = cfg.moe
    T, D = x.shape
    Epad, K = m.n_experts_padded, m.top_k
    E_loc = Epad // tp
    n, ntok, C_send, C_exp, sliced = _ep_capacity(m, T, tp)
    nch = -(-T // n)
    xp = F.pad(x, (0, 0, 0, nch * n - T))
    router = p["router"].float()
    hop = _RoundTrip.apply if compress_a2a else (lambda t: t)
    ys = [[] for _ in range(tp)]
    keeps = [[] for _ in range(tp)]
    load = torch.zeros(Epad, dtype=torch.float32, device=x.device)
    auxs = []
    for c in range(nch):
        xc = xp[c * n:(c + 1) * n]
        src = [xc[s * ntok:(s + 1) * ntok] if sliced else xc
               for s in range(tp)]
        routed = [route(m, xt.float() @ router, bias) for xt in src]
        ids = [r[1].reshape(-1).cpu() for r in routed]
        plans = [_send_plan(i, tp, E_loc, C_send) for i in ids]
        # each destination's kept rows by local expert, in [source, slot]
        # order: {(d, el): {s: [slot]}}; kept: {(s, a)}
        kept, rows_of = set(), {}
        for d in range(tp):
            count = [0] * E_loc
            for s in range(tp):
                for a, sl in plans[s][d]:
                    el = int(ids[s][a]) - d * E_loc
                    if count[el] < C_exp:
                        count[el] += 1
                        kept.add((s, a))
                        rows_of.setdefault((d, el), {}).setdefault(
                            s, []).append(sl)

        def index(v):
            return torch.tensor(v, dtype=torch.long, device=x.device)

        # the send blocks [C_send, D], through the wire
        block = {}
        for s in range(tp):
            for d in range(tp):
                z = src[s].new_zeros(C_send, D)
                if plans[s][d]:
                    z = z.index_copy(0, index([sl for _, sl in plans[s][d]]),
                                     src[s][index([a // K for a, _ in
                                                   plans[s][d]])])
                block[(s, d)] = hop(z)
        # each destination's experts; their rows back into return blocks
        back = {sd: ([], []) for sd in block}
        for (d, el), by_src in sorted(rows_of.items()):
            srcs = sorted(by_src)
            inp = torch.cat([block[(s, d)][index(by_src[s])] for s in srcs])
            E = d * E_loc + el
            h = inp @ p["w_up"][E]
            g = inp @ p["w_gate"][E]
            o = (activate(cfg.act, g) * h) @ p["w_down"][E]
            for s, part in zip(srcs, o.split([len(by_src[s])
                                              for s in srcs])):
                back[(s, d)][0].extend(by_src[s])
                back[(s, d)][1].append(part)
        ret = {}
        for (s, d), (sls, parts) in back.items():
            z = src[s].new_zeros(C_send, D)
            if sls:
                z = z.index_copy(0, index(sls), torch.cat(parts).to(z.dtype))
            ret[(s, d)] = hop(z)
        for s in range(tp):
            gates, _, probs = routed[s]
            A = ids[s].numel()
            y_a = src[s].new_zeros(A, D)
            kmask = torch.zeros(A, dtype=torch.bool)
            for d in range(tp):
                at = [(a, sl) for a, sl in plans[s][d] if (s, a) in kept]
                for a, _ in at:
                    kmask[a] = True
                if at:
                    y_a = y_a.index_copy(0, index([a for a, _ in at]),
                                         ret[(s, d)][index([sl for _, sl
                                                            in at])])
            ys[s].append((y_a.view(-1, K, D)
                          * gates[..., None].to(y_a.dtype)).sum(1))
            keeps[s].append(kmask.view(-1, K).to(x.device))
            ld = torch.zeros(Epad, dtype=torch.float32, device=x.device)
            ld.index_add_(0, ids[s].to(x.device), ld.new_ones(A))
            load = load + ld
            ce = ld / torch.clamp_min(ld.sum(), 1.0)
            auxs.append((probs.mean(0) * ce).sum() * m.n_experts)
    if sliced:
        y = torch.cat([torch.cat([ys[s][c] for s in range(tp)])
                       for c in range(nch)])[:T]
        out = [y] * tp
    else:
        out = [torch.cat(ys[s])[:T] for s in range(tp)]
        load = load / tp
    # aux: the mean over model of each rank's mean over chunks
    aux = torch.stack(auxs).view(nch, tp).mean(0).mean()
    return out, load, aux, [torch.cat(k) for k in keeps]


class _RoundTrip(torch.autograd.Function):
    """One compressed hop of a block: ``q8_roundtrip`` of the value
    forward, of the cotangent backward."""

    @staticmethod
    def forward(ctx, x):
        return q8_roundtrip(x[None])[0]

    @staticmethod
    def backward(ctx, g):
        return q8_roundtrip(g[None])[0]


# ---------------------------------------------------------------------------
# Public apply
# ---------------------------------------------------------------------------

def moe_apply(cfg: ArchConfig, p, x, bias, *, ep=None,
              compress_a2a: bool = False, tp=None):
    """x: [B,S,D] -> (y, {"load": [E_pad], "aux_loss": scalar}), the
    shared expert added. ``ep`` (a ``parallel/ep.py::Ep``): experts over
    its ``model`` ranks, ``p`` holding this rank's; ``compress_a2a``:
    the exchange in int8 (no exchange on one rank); ``tp`` (a
    ``parallel/tp.py::Tp``): the shared expert's hidden units over the
    model ranks where they divide. The stream ``x`` is a copy on every
    model rank, as the body's token slices assume."""
    m = cfg.moe
    B, S, D = x.shape
    if ep is None:
        y, load, aux, _ = _moe_body(cfg, p, x.reshape(B * S, D), bias)
    else:
        y, load, aux, _ = _ep_body(cfg, p, x.reshape(B * S, D), bias, ep,
                                   compress_a2a)
    y = y.reshape(B, S, D)
    if m.n_shared:
        y = y + ffn_apply(cfg, p["shared"], x,
                          tp and tp.on(m.d_ff_shared * m.n_shared))
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
