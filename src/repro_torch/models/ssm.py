"""Mamba-2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060]: the JAX package's ``models/ssm.py``.

Prefill runs the chunked form: an intra-chunk quadratic term plus an
inter-chunk state recurrence, a loop over chunks that keeps one
``[B,H,Q,Q]`` decay tile alive, as the reference's scan does. Decode keeps
an O(1) recurrent state per layer. The reference computes in plain
``jnp``, not Pallas, so this is plain PyTorch: einsums and a loop. Each
three-operand einsum of the reference is an elementwise product and one
two-operand einsum here, so that no five-dimensional intermediate is made.

On a model axis (``tp``, a ``parallel/tp.py::Tp``, where the ranks divide
the SSD heads ``H``) each rank holds ``H / tp`` heads: the ``Din / tp``
channels of ``w_z``, ``w_x``, ``conv_x`` and ``gn`` (those heads'
channels), the heads of ``w_dt``, ``A_log``, ``D`` and ``dt_bias``, the
channels' rows of ``w_out`` (summed by ``Tp.exit``), and in the cache
its channels of ``conv_x`` and its heads of ``state``. The B/C groups
(``w_B``, ``w_C``, ``conv_B``, ``conv_C``) stay whole and are entered;
each rank reads the groups of its heads (``Tp.kv_heads``' rule). The
gated norm runs over all of ``Din``, so its sum of squares is all-reduced
both ways (``Tp.psum``) before the scale.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import einsum, rmsnorm, softplus
from repro_torch.models.params import ParamDef


def ssm_schema(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    Din = s.d_inner(D)
    H = s.n_heads(D)
    N = s.d_state
    G = s.n_groups
    K = s.conv_width
    return {
        "w_z": ParamDef((D, Din), ("embed", "state")),
        "w_x": ParamDef((D, Din), ("embed", "state")),
        "w_B": ParamDef((D, G * N), ("embed", None)),
        "w_C": ParamDef((D, G * N), ("embed", None)),
        "w_dt": ParamDef((D, H), ("embed", "heads")),
        "conv_x": ParamDef((K, Din), (None, "state"), scale=0.5),
        "conv_B": ParamDef((K, G * N), (None, None), scale=0.5),
        "conv_C": ParamDef((K, G * N), (None, None), scale=0.5),
        "A_log": ParamDef((H,), ("heads",), init="zeros"),
        "D": ParamDef((H,), ("heads",), init="ones"),
        "dt_bias": ParamDef((H,), ("heads",), init="zeros"),
        "gn": ParamDef((Din,), ("state",), init="zeros"),
        "w_out": ParamDef((Din, D), ("state", "embed")),
    }


def _causal_conv(x, w):
    """Depthwise causal conv via shifted adds. x: [B,L,C], w: [K,C]."""
    K = w.shape[0]
    y = x * w[K - 1]
    for i in range(1, K):
        y = y + F.pad(x, (0, 0, i, 0))[:, :-i] * w[K - 1 - i]
    return y


def _segsum(a):
    """a: [..., Q]. Lower-triangular cumulative sums: out[i,j] = sum_{j<t<=i}
    a_t, and -inf above the diagonal (so ``exp`` gives exact zeros)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD over chunks, one chunk at a time.

    x: [B,L,H,P], dt: [B,L,H] (positive), A: [H] (negative), Bm/Cm:
    [B,L,G,N]. Returns y: [B,L,H,P] in x's dtype.
    """
    Bz, L, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if L % chunk:
        raise ValueError(f"length {L} is not a multiple of chunk {chunk}")
    rep = H // G
    S = torch.zeros(Bz, H, N, Pd, dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, L, chunk):
        sl = slice(lo, lo + chunk)
        xq, dtq = x[:, sl], dt[:, sl]                         # [B,Q,H,P], [B,Q,H]
        Bh = Bm[:, sl].repeat_interleave(rep, dim=2).float()  # [B,Q,H,N]
        Ch = Cm[:, sl].repeat_interleave(rep, dim=2).float()
        a_t = (dtq * A).float().transpose(1, 2)               # [B,H,Q], negative
        acs = torch.cumsum(a_t, dim=-1)
        xdt = (xq * dtq[..., None]).float()

        Ldec = torch.exp(_segsum(a_t))                        # [B,H,Q,Q]
        scores = torch.einsum("bqhn,bkhn->bhqk", Ch, Bh)
        y_diag = torch.einsum("bhqk,bkhp->bqhp", scores * Ldec, xdt)

        dec_to_end = torch.exp(acs[..., -1:] - acs)           # [B,H,Q]
        S_c = torch.einsum("bkhn,bkhp->bhnp",
                           Bh * dec_to_end.transpose(1, 2)[..., None], xdt)

        dec_from_start = torch.exp(acs).transpose(1, 2)       # [B,Q,H]
        y_off = torch.einsum("bqhn,bhnp->bqhp", Ch, S) * dec_from_start[..., None]

        S = S * torch.exp(acs[..., -1])[..., None, None] + S_c
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1)


GROUP_WEIGHTS = ("w_B", "w_C", "conv_B", "conv_C")     # whole under tp


def _groups(cfg: ArchConfig, p, tp):
    """-> (the B/C group weights, entered under ``tp``; (H, G) of this
    rank's heads and groups; the index that maps B/C's groups to this
    rank's: a slice of groups, or one group per local head)."""
    s = cfg.ssm
    H, G = s.n_heads(cfg.d_model), s.n_groups
    w = {n: tp.enter(p[n]) if tp is not None else p[n]
         for n in GROUP_WEIGHTS}
    if tp is None:
        return w, (H, G), None
    lo, n, index = tp.kv_heads(H, G)
    if index is None:
        return w, (H // tp.tp, n), slice(lo, lo + n)
    return w, (H // tp.tp, H // tp.tp), index + lo


def _pick(x, sel):
    """The groups ``sel`` of x [..., G, N] (a slice, or an index with one
    group per head); all of them where ``sel`` is None."""
    if sel is None:
        return x
    if isinstance(sel, slice):
        return x[..., sel, :]
    return x.index_select(-2, sel.to(x.device))


def _gated_norm(y, z, gn, tp):
    """``rmsnorm(y * silu(z), gn)`` over all of ``Din``: under ``tp`` the
    mean square of every rank's channels."""
    if tp is None:
        return rmsnorm(y * F.silu(z), gn)
    v = y * F.silu(z)
    vf = v.float()
    ss = tp.psum(torch.sum(torch.square(vf), dim=-1, keepdim=True))
    var = ss / (vf.shape[-1] * tp.tp)
    return (vf * torch.rsqrt(var + 1e-6) * (1.0 + gn.float())).to(v.dtype)


def ssm_apply(cfg: ArchConfig, p, x, *, make_cache: bool = False, tp=None):
    """x: [B,L,D] -> (y, cache|None). The prefill / forward path. ``tp``:
    this rank's heads of ``p`` and of the cache."""
    s = cfg.ssm
    B, L, D = x.shape
    Pd = s.head_dim
    N = s.d_state
    if tp is not None:
        x = tp.enter(x)
    w, (H, G), sel = _groups(cfg, p, tp)

    z = einsum("bld,de->ble", x, p["w_z"])
    xin_pre = einsum("bld,de->ble", x, p["w_x"])
    B_pre = einsum("bld,de->ble", x, w["w_B"])
    C_pre = einsum("bld,de->ble", x, w["w_C"])
    dt = einsum("bld,dh->blh", x, p["w_dt"])

    xin = F.silu(_causal_conv(xin_pre, p["conv_x"]))
    Bm = F.silu(_causal_conv(B_pre, w["conv_B"]))
    Cm = F.silu(_causal_conv(C_pre, w["conv_C"]))

    dt = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    xh = xin.reshape(B, L, H, Pd)
    Bh = _pick(Bm.reshape(B, L, s.n_groups, N), sel)
    Ch = _pick(Cm.reshape(B, L, s.n_groups, N), sel)

    chunk = min(s.chunk, L)
    pad = (-L) % chunk
    if pad:                    # causal: trailing pad cannot affect y[:, :L]
        y = ssd_chunked(F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                        A, F.pad(Bh, (0, 0, 0, 0, 0, pad)),
                        F.pad(Ch, (0, 0, 0, 0, 0, pad)), chunk)[:, :L]
    else:
        y = ssd_chunked(xh, dt, A, Bh, Ch, chunk)
    y = y + xh * p["D"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(B, L, H * Pd)
    y = _gated_norm(y, z, p["gn"], tp)
    out = einsum("ble,ed->bld", y, p["w_out"])
    if tp is not None:
        out = tp.exit(out)

    cache = None
    if make_cache:
        K = s.conv_width
        cache = {"conv_x": _tail(xin_pre, K - 1), "conv_B": _tail(B_pre, K - 1),
                 "conv_C": _tail(C_pre, K - 1),
                 "state": _final_state(xh, dt, A, Bh)}
    return out, cache


def _tail(x, k):
    return x[:, -k:] if k else x[:, :0]


def _final_state(xh, dt, A, Bh):
    """Exact final SSM state h_L: [B,H,N,P] in f32."""
    H = xh.shape[2]
    G = Bh.shape[2]
    Bfull = Bh.repeat_interleave(H // G, dim=2).float()   # [B,L,H,N]
    acs = torch.cumsum((dt * A).float(), dim=1)           # [B,L,H]
    dec = torch.exp(acs[:, -1:, :] - acs)                 # decay from t to end
    xdt = (xh * dt[..., None]).float()
    return torch.einsum("blhn,blhp->bhnp", Bfull * dec[..., None], xdt)


def ssm_cache_def(cfg: ArchConfig, batch: int, tp=None) -> dict:
    """``tp``: this rank's channels of ``conv_x`` and heads of ``state``."""
    s = cfg.ssm
    D = cfg.d_model
    Din, H, N, G, K = (s.d_inner(D), s.n_heads(D), s.d_state, s.n_groups,
                       s.conv_width)
    if tp is not None:
        Din, H = Din // tp.tp, H // tp.tp
    return {
        "conv_x": ParamDef((batch, K - 1, Din), ("batch", None, "state"),
                           init="zeros"),
        "conv_B": ParamDef((batch, K - 1, G * N), ("batch", None, None),
                           init="zeros"),
        "conv_C": ParamDef((batch, K - 1, G * N), ("batch", None, None),
                           init="zeros"),
        "state": ParamDef((batch, H, N, s.head_dim),
                          ("batch", "heads", None, None), init="zeros",
                          dtype="float32"),
    }


def _conv_step(prev, cur, w):
    """One causal-conv step: -> (silu(conv), the window shifted by one), in
    the promoted dtype of ``prev`` and ``cur``, as ``jnp.concatenate``."""
    dt = torch.promote_types(prev.dtype, cur.dtype)
    seq = torch.cat([prev.to(dt), cur[:, None].to(dt)], dim=1)   # [B,K,C]
    return F.silu(einsum("bkc,kc->bc", seq, w)), seq[:, 1:]


def ssm_decode(cfg: ArchConfig, p, x1, cache: dict, pos: int, tp=None):
    """Single-token recurrent step. x1: [B,1,D] -> (y [B,1,D], new cache).
    ``tp``: as in ``ssm_apply``."""
    s = cfg.ssm
    B, _, D = x1.shape
    Pd, N = s.head_dim, s.d_state
    if tp is not None:
        x1 = tp.enter(x1)
    w, (H, G), sel = _groups(cfg, p, tp)
    x0 = x1[:, 0]
    z = einsum("bd,de->be", x0, p["w_z"])
    xin = einsum("bd,de->be", x0, p["w_x"])
    Bm = einsum("bd,de->be", x0, w["w_B"])
    Cm = einsum("bd,de->be", x0, w["w_C"])
    dt = einsum("bd,dh->bh", x0, p["w_dt"])

    xin, cx = _conv_step(cache["conv_x"], xin, p["conv_x"])
    Bm, cB = _conv_step(cache["conv_B"], Bm, w["conv_B"])
    Cm, cC = _conv_step(cache["conv_C"], Cm, w["conv_C"])

    dt = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, H, Pd).float()
    Bh = _pick(Bm.reshape(B, s.n_groups, N), sel).repeat_interleave(
        H // G, dim=1).float()
    Ch = _pick(Cm.reshape(B, s.n_groups, N), sel).repeat_interleave(
        H // G, dim=1).float()

    dA = torch.exp(dt * A)                                    # [B,H]
    h = cache["state"] * dA[..., None, None] + \
        (Bh * dt[..., None])[..., None] * xh[:, :, None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, h) + xh * p["D"].float()[:, None]
    y = y.reshape(B, H * Pd).to(x1.dtype)
    y = _gated_norm(y, z, p["gn"], tp)
    out = einsum("be,ed->bd", y, p["w_out"])[:, None, :]
    if tp is not None:
        out = tp.exit(out)
    return out, {"conv_x": cx, "conv_B": cB, "conv_C": cC, "state": h}
