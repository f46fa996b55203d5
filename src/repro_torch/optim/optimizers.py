"""Optimizers: AdamW, SGD+momentum, Adafactor — per-tensor or bucketed (the
port of ``repro.optim.optimizers``, with its constants and its f32 math).

Bucketed mode (``core/buckets.py``) is the paper's output-buffering
analogue: the gradients are flattened into a few large f32 buffers and the
optimizer update is a handful of elementwise passes over them instead of
hundreds of small ones. Adafactor keeps per-tensor states (factored second
moments need the tensor's shape) and is used for the 671B config, where
Adam-class state does not fit.

``params`` and ``grads`` are dicts of tensors (per-tensor kinds; the keys
are the caller's) or, for the bucketed kinds, lists in a ``BucketPlan``'s
order. The train step hands Adafactor the reference's *stacked* leaves
(``training/state.py``), so its factored states, its row/column means and
its update-clipping RMS cover a scan group's layers together, as the
reference's do. With ``inplace=True`` the moments are updated in their own
storage (the step's ``donate_state``; Adafactor's factored states are new
either way); the numbers are the same.

Under FSDP (``parallel/fsdp.py``) each rank updates its row shards. AdamW
and SGD are elementwise and run on them as they are. Adafactor is not:
its row and column means, the row factor's mean and the update-clipping
RMS reduce over dimensions the shards cut, so each becomes a local sum
plus an all-reduce over the FSDP ranks, divided by the full length
(``adafactor_shard_update``), which is the reference's global mean. Its
states are sharded too: a row statistic with the rows, a column statistic
(and a stacked vector leaf's per-layer statistic) as an even flat split,
gathered at the update. On a ``model`` axis a leaf that the axis cuts is
this rank's part (``parallel/tp.py``): its update-clipping RMS sums over
the model ranks, and where the cut falls on one of the two factored
dimensions (an FFN's hidden units, the vocabulary, the heads of ``w_q``)
the means over that dimension are a local sum plus an all-reduce over
``model`` too, divided by the full length; an expert leaf, or ``w_o``
(cut on its leading heads), keeps its factored statistics local.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import buckets as bk
from repro_torch.core.compression import all_reduce


# ---------------------------------------------------------------------------
# Per-tensor kernels (operate on one tensor; mapped over buckets)
# ---------------------------------------------------------------------------

def _moment(m, beta, x, inplace: bool):
    """``beta * m + (1 - beta) * x``, rounded as the reference does it."""
    if inplace:
        return m.mul_(beta).add_((1 - beta) * x)
    return beta * m + (1 - beta) * x


def _adamw_update(g, m, v, p, *, lr, b1, b2, eps, wd, step, inplace=False):
    gf = g.float()
    m = _moment(m, b1, gf, inplace)
    v = _moment(v, b2, torch.square(gf), inplace)
    mh = m / (1 - b1 ** step)
    vh = v / (1 - b2 ** step)
    upd = -lr * (mh / (torch.sqrt(vh) + eps) + wd * p.float())
    return upd, m, v


def _sgdm_update(g, m, p, *, lr, beta, wd, inplace=False):
    gf = g.float() + wd * p.float()
    m = m.mul_(beta).add_(gf) if inplace else beta * m + gf
    return -lr * m, m


def _mean(x, dim: int, ep=None, keepdim: bool = False):
    """The mean of ``x`` over ``dim``, the other model ranks' parts of that
    dimension included where ``ep`` (the model layout) holds them."""
    if ep is None:
        return x.mean(dim, keepdim=keepdim)
    s = all_reduce(x.sum(dim, keepdim=keepdim), ep.group)
    return s / (x.shape[dim] * ep.tp)


def _adafactor_update(g, state, p, *, lr, b2, eps, wd, step, ep=None,
                      cut=0):
    """``ep``: the model layout holding the rest of the leaf (None: the
    whole leaf is here); ``cut``: the factored dimension it cuts (-1 or
    -2), 0 for another one."""
    gf = g.float()
    g2 = torch.square(gf) + 1e-30
    decay = 1.0 - (step ** -0.8)
    if gf.dim() >= 2:
        on = {d: ep if cut == d else None for d in (-1, -2)}
        vr = decay * state["vr"] + (1 - decay) * _mean(g2, -1, on[-1])
        vc = decay * state["vc"] + (1 - decay) * _mean(g2, -2, on[-2])
        rfac = vr / torch.clamp_min(_mean(vr, -1, on[-2], keepdim=True),
                                    1e-30)
        vhat = rfac[..., None] * vc[..., None, :]
        new = {"vr": vr, "vc": vc}
    else:
        v = decay * state["v"] + (1 - decay) * g2
        vhat = v
        new = {"v": v}
    u = gf / torch.sqrt(vhat + eps)
    # update clipping (Shazeer & Stern), over the whole leaf: where ``ep``
    # holds its other parts, their squares too
    if ep is None:
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
    else:
        ss = all_reduce(torch.sum(torch.square(u)).reshape(1), ep.group)[0]
        rms = torch.sqrt(ss / (u.numel() * ep.tp) + 1e-30)
    u = u / torch.clamp_min(rms, 1.0)
    upd = -lr * (u + wd * p.float())
    return upd, new


# ---------------------------------------------------------------------------
# Public optimizer API
# ---------------------------------------------------------------------------

def opt_init(name: str, params, *, bucketed: bool = False,
             bucket_bytes: int = 1 << 28, pad_multiple: int = 1,
             plan: bk.BucketPlan | None = None):
    """-> the optimizer state. ``params``: a dict of tensors; for the
    bucketed kinds, the plan's leaves (``bk.make_plan``'s argument: tensors
    or runs of tensors), whose moments are f32 buckets of ``plan`` (made
    from the leaves by default)."""
    if name == "adafactor":
        def st(p):
            if p.dim() >= 2:
                return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32)}
            return {"v": p.new_zeros(p.shape, dtype=torch.float32)}
        return {"per": {k: st(p) for k, p in params.items()}}
    if bucketed:
        leaves = list(params)
        plan = plan or bk.make_plan(leaves, bucket_bytes, pad_multiple)
        dev = bk.leaf_tensors(leaves[0])[0].device
        if name == "adamw":
            return {"m": bk.zeros_like_buckets(plan, device=dev),
                    "v": bk.zeros_like_buckets(plan, device=dev)}
        if name == "sgdm":
            return {"m": bk.zeros_like_buckets(plan, device=dev)}
        raise ValueError(name)

    def z():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}
    if name == "adamw":
        return {"m": z(), "v": z()}
    if name == "sgdm":
        return {"m": z()}
    raise ValueError(name)


def opt_update(kind: str, opt_state, grads, params, *, lr, wd: float = 0.1,
               step, plan: bk.BucketPlan | None = None,
               grads_are_buckets: bool = False, inplace: bool = False,
               rms_over: dict | None = None):
    """-> (updates: a dict like ``params``, or buckets; the new optimizer
    state). ``step`` is the int step tensor (its f32 value + 1 enters the
    bias corrections and Adafactor's decay), ``lr`` a float or an f32
    tensor.

    For the bucketed kinds ``grads`` is the plan's list of tensors
    (flattened here, one bucket at a time) or ready buckets
    (``grads_are_buckets``: the explicit sync's); ``params`` is the plan's
    list of tensors. ``rms_over`` (Adafactor): by key, the
    ``parallel/ep.py::Ep`` that holds the rest of a leaf's experts."""
    stepf = step.float() + 1.0
    if kind in ("adamw_b", "sgdm_b"):
        params = list(params)
        grads = grads if grads_are_buckets else list(grads)
        ups, ms, vs = [], [], []
        for bi in range(len(plan.bucket_sizes)):
            g = grads[bi] if grads_are_buckets else \
                bk.flatten_bucket(plan, grads, bi)
            p = bk.flatten_bucket(plan, params, bi)
            if kind == "adamw_b":
                u, m, v = _adamw_update(
                    g, opt_state["m"][bi], opt_state["v"][bi], p, lr=lr,
                    b1=0.9, b2=0.95, eps=1e-8, wd=wd, step=stepf,
                    inplace=inplace)
                vs.append(v)
            else:
                u, m = _sgdm_update(g, opt_state["m"][bi], p, lr=lr,
                                    beta=0.9, wd=wd, inplace=inplace)
            ups.append(u)
            ms.append(m)
        return ups, ({"m": ms, "v": vs} if kind == "adamw_b" else {"m": ms})
    if kind == "adamw":
        outs = {k: _adamw_update(grads[k], opt_state["m"][k],
                                 opt_state["v"][k], p, lr=lr, b1=0.9,
                                 b2=0.95, eps=1e-8, wd=wd, step=stepf,
                                 inplace=inplace)
                for k, p in params.items()}
        return ({k: o[0] for k, o in outs.items()},
                {"m": {k: o[1] for k, o in outs.items()},
                 "v": {k: o[2] for k, o in outs.items()}})
    if kind == "sgdm":
        outs = {k: _sgdm_update(grads[k], opt_state["m"][k], p, lr=lr,
                                beta=0.9, wd=wd, inplace=inplace)
                for k, p in params.items()}
        return ({k: o[0] for k, o in outs.items()},
                {"m": {k: o[1] for k, o in outs.items()}})
    if kind == "adafactor":
        over = rms_over or {}
        outs = {k: _adafactor_update(grads[k], opt_state["per"][k], p, lr=lr,
                                     b2=0.999, eps=1e-30, wd=wd, step=stepf,
                                     ep=over.get(k, (None, 0))[0],
                                     cut=over.get(k, (None, 0))[1])
                for k, p in params.items()}
        return ({k: o[0] for k, o in outs.items()},
                {"per": {k: o[1] for k, o in outs.items()}})
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Adafactor over row shards (FSDP)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FactoredLeaf:
    """One reference leaf under FSDP: ``layers`` per-layer tensors of
    ``shape`` (``stacked``: the reference's leaf is [layers, *shape]), each
    a row shard of ``numel`` elements (``ShardSpec``) on ``fs``'s ranks.
    The reference factors the leaf's last two dimensions:

    - ``rows``: ``shape`` has two or more dimensions; the row statistic
      ``vr`` [layers, rows a rank] is sharded with the rows, the column
      statistic ``vc`` [layers, k] is an even flat split of its
      [*shape[:-2], c] per layer;
    - ``layers``: a stacked vector leaf [layers, n]: ``vr`` (one per layer)
      an even flat split of [layers], ``vc`` [n] sharded as the vectors;
    - ``none`` (no factoring): ``v`` [layers, k], as the parameter.

    ``ep``: where the leaf is this rank's part of a tensor the model axis
    cuts (``shape`` the local shape), the ``parallel/tp.py::Tp`` holding
    the rest; ``cut``: the factored dimension it cuts (-1: the columns,
    -2: the rows within each leading block), 0 for another (an expert
    leaf's experts, ``w_o``'s heads). The update-clipping RMS spans the
    whole leaf and sums over ``ep``'s ranks; a mean over a cut factored
    dimension sums over them too."""
    layers: int
    shape: tuple
    stacked: bool
    fs: object
    ep: object = None
    cut: int = 0

    @property
    def spec(self):
        return self.fs.spec(self.shape)

    @property
    def kind(self) -> str:
        if len(self.shape) >= 2:
            return "rows"
        return "layers" if self.stacked and len(self.shape) == 1 else "none"

    @property
    def lead(self) -> int:          # m: the per-layer leading size
        return math.prod(self.shape[:-2])

    def init(self, device) -> dict:
        L, k, fs = self.layers, self.spec.numel, self.fs
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if self.kind == "rows":
            return {"vr": z(L, self.spec.rows_per_rank),
                    "vc": z(L, fs.block(self.lead * self.shape[-1]))}
        if self.kind == "layers":
            return {"vr": z(fs.block(L)), "vc": z(k)}
        return {"v": z(L, k)}

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """State ``name`` (this rank's ``t``) in the reference's shape
        (collective)."""
        fs, L, s = self.fs, self.layers, self.shape
        lead = (L,) if self.stacked else ()
        got = fs.gather_last(t)
        if self.kind == "rows":
            if name == "vr":
                return got[:, :self.spec.rows].reshape(lead + s[:-1])
            return got[:, :self.lead * s[-1]].reshape(lead + s[:-2] + s[-1:])
        if self.kind == "layers":
            return got[:L] if name == "vr" else got[:s[0]]
        return got[:, :math.prod(s)].reshape(lead + s)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's state ``name`` from its reference-shaped ``full``."""
        fs, L = self.fs, self.layers
        if self.kind == "layers":
            return fs.own(full.reshape(-1), fs.block(L) if name == "vr"
                          else self.spec.numel)
        if self.kind == "rows":
            k = (self.spec.rows_per_rank if name == "vr"
                 else fs.block(self.lead * self.shape[-1]))
        else:
            k = self.spec.numel
        return fs.own(full.reshape(L, -1), k)


def _row_groups(x: torch.Tensor, start: int, r: int, m: int) -> torch.Tensor:
    """``x`` [L, k, ...] summed over its rows in groups of ``r`` global rows
    (local row ``j`` is global row ``start + j``, in group ``(start + j) //
    r``, the groups past ``m - 1`` summed into it) -> [L, m, ...]. The sums
    run in a fixed order: ``index_add_`` on the card adds with atomics in an
    order that changes from run to run, and a copy over ``model`` must come
    out the same on every model rank."""
    L, k = x.shape[:2]
    g0, front = divmod(start, r)
    ng = -(-(front + k) // r)
    pad = [0, 0] * (x.dim() - 2) + [front, ng * r - front - k]
    grouped = F.pad(x, pad).reshape(L, ng, r, *x.shape[2:]).sum(2)
    out = x.new_zeros(L, m, *x.shape[2:])
    n = max(0, min(ng, m - g0))
    out[:, g0:g0 + n] = grouped[:, :n]
    if ng > n:
        out[:, m - 1] += grouped[:, n:].sum(1)
    return out


def adafactor_shard_update(g, state, p, leaf: FactoredLeaf, *, lr, wd, step,
                           b2: float = 0.999, eps: float = 1e-30):
    """``_adafactor_update`` on one leaf's row shards: ``g``, ``p``
    [layers, k] (each layer's shard). -> (update [layers, k], new
    state)."""
    fs, L, s = leaf.fs, leaf.layers, leaf.shape
    gf = g.float()
    decay = 1.0 - (step ** -0.8)
    spec = leaf.spec

    def over_model(x, d):
        """``x`` summed over the model ranks where the leaf's cut is the
        factored dimension ``d``."""
        return all_reduce(x, leaf.ep.group) if leaf.cut == d else x
    tp = leaf.ep.tp if leaf.ep is not None else 1
    if leaf.kind == "rows":
        r, c, m, Rk = s[-2], s[-1], leaf.lead, spec.rows_per_rank
        rho = fs.index * Rk + torch.arange(Rk, device=g.device)
        valid = (rho < spec.rows).float()
        a = torch.clamp(rho // r, max=m - 1)
        g3 = gf.view(L, Rk, c)
        g2 = (torch.square(g3) + 1e-30) * valid[None, :, None]
        cw = c * (tp if leaf.cut == -1 else 1)
        rw = r * (tp if leaf.cut == -2 else 1)
        vr = decay * state["vr"] + (1 - decay) * (
            over_model(g2.sum(-1), -1) / cw)
        col = over_model(all_reduce(_row_groups(g2, fs.index * Rk, r, m),
                                    fs.group), -2) / rw
        vc_old = fs.gather_last(state["vc"])[:, :m * c].view(L, m, c)
        vc = decay * vc_old + (1 - decay) * col
        vr_mean = over_model(all_reduce(_row_groups(vr, fs.index * Rk, r, m),
                                        fs.group), -2) / rw
        rfac = vr / torch.clamp_min(vr_mean[:, a], 1e-30)
        vhat = (rfac[..., None] * vc[:, a, :]).view(L, -1)
        new = {"vr": vr, "vc": fs.own(vc.view(L, -1), state["vc"].shape[-1])}
    else:
        n = s[0] if s else 1
        idx = fs.index * spec.numel + torch.arange(spec.numel,
                                                   device=g.device)
        valid = (idx < n).float()
        g2 = (torch.square(gf) + 1e-30) * valid
        if leaf.kind == "layers":
            vr_old = fs.gather_last(state["vr"])[:L]
            vr = decay * vr_old + (1 - decay) * (
                all_reduce(g2.sum(-1), fs.group) / n)
            vc = decay * state["vc"] + (1 - decay) * (g2.sum(0) / L)
            rfac = vr / torch.clamp_min(vr.mean(), 1e-30)
            vhat = rfac[:, None] * vc[None, :]
            new = {"vr": fs.own(vr, state["vr"].shape[-1]), "vc": vc}
        else:
            v = decay * state["v"] + (1 - decay) * g2
            vhat = v
            new = {"v": v}
    u = gf / torch.sqrt(vhat + eps)
    total = L * math.prod(s)
    ss = all_reduce(torch.sum(torch.square(u)).reshape(1), fs.group)
    if leaf.ep is not None:
        ss = all_reduce(ss, leaf.ep.group)
        total *= leaf.ep.tp
    rms = torch.sqrt(ss[0] / total + 1e-30)
    u = u / torch.clamp_min(rms, 1.0)
    return -lr * (u + wd * p.float()), new


def apply_updates(params, updates, *, plan: bk.BucketPlan | None = None):
    """params + updates in f32, cast back to each parameter's dtype: new
    tensors, a dict like ``params`` or (with bucket updates) the plan's
    list."""
    if isinstance(updates, list):
        return [(p.float() + u.float()).to(p.dtype)
                for p, u in zip(params, bk.unflatten(plan, updates))]
    return {k: (p.float() + updates[k].float()).to(p.dtype)
            for k, p in params.items()}
