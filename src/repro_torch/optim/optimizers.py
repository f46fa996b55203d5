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
"""
from __future__ import annotations

import torch

from repro_torch.core import buckets as bk


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


def _adafactor_update(g, state, p, *, lr, b2, eps, wd, step):
    gf = g.float()
    g2 = torch.square(gf) + 1e-30
    decay = 1.0 - (step ** -0.8)
    if gf.dim() >= 2:
        vr = decay * state["vr"] + (1 - decay) * g2.mean(-1)
        vc = decay * state["vc"] + (1 - decay) * g2.mean(-2)
        rfac = vr / torch.clamp_min(vr.mean(-1, keepdim=True), 1e-30)
        vhat = rfac[..., None] * vc[..., None, :]
        new = {"vr": vr, "vc": vc}
    else:
        v = decay * state["v"] + (1 - decay) * g2
        vhat = v
        new = {"v": v}
    u = gf / torch.sqrt(vhat + eps)
    # update clipping (Shazeer & Stern)
    rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
    u = u / torch.clamp_min(rms, 1.0)
    upd = -lr * (u + wd * p.float())
    return upd, new


# ---------------------------------------------------------------------------
# Public optimizer API
# ---------------------------------------------------------------------------

def opt_init(name: str, params, *, bucketed: bool = False,
             bucket_bytes: int = 1 << 28, pad_multiple: int = 1):
    """-> the optimizer state. ``params``: a dict of tensors; for the
    bucketed kinds, the plan's leaves (``bk.make_plan``'s argument: tensors
    or runs of tensors), whose moments are f32 buckets."""
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
        plan = bk.make_plan(leaves, bucket_bytes, pad_multiple)
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
               grads_are_buckets: bool = False, inplace: bool = False):
    """-> (updates: a dict like ``params``, or buckets; the new optimizer
    state). ``step`` is the int step tensor (its f32 value + 1 enters the
    bias corrections and Adafactor's decay), ``lr`` a float or an f32
    tensor.

    For the bucketed kinds ``grads`` is the plan's list of tensors
    (flattened here, one bucket at a time) or ready buckets
    (``grads_are_buckets``: the explicit sync's); ``params`` is the plan's
    list of tensors."""
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
        outs = {k: _adafactor_update(grads[k], opt_state["per"][k], p, lr=lr,
                                     b2=0.999, eps=1e-30, wd=wd, step=stepf)
                for k, p in params.items()}
        return ({k: o[0] for k, o in outs.items()},
                {"per": {k: o[1] for k, o in outs.items()}})
    raise ValueError(kind)


def apply_updates(params, updates, *, plan: bk.BucketPlan | None = None):
    """params + updates in f32, cast back to each parameter's dtype: new
    tensors, a dict like ``params`` or (with bucket updates) the plan's
    list."""
    if isinstance(updates, list):
        return [(p.float() + u.float()).to(p.dtype)
                for p, u in zip(params, bk.unflatten(plan, updates))]
    return {k: (p.float() + updates[k].float()).to(p.dtype)
            for k, p in params.items()}
