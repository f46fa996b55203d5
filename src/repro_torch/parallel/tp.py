"""Tensor parallelism over the ``model`` axis: the layout of a parameter on
one model rank and the collectives that GSPMD inserts for the reference's
``model`` rules (``parallel/sharding.py::make_rules``: ``heads``,
``kv_heads``, ``mlp``, ``vocab``, ``state``; ``experts`` is
``parallel/ep.py``'s; ``seq_model``, the activations' fallback, below).

A parameter is cut where the reference's ``spec_for`` puts ``model``: at
its first dimension whose logical name maps to ``model`` and whose size the
model ranks divide (an axis is used once), else it is whole on every model
rank. So ``w_q [D, H, dh]`` holds this rank's ``H / tp`` heads, ``w_o
[H, dh, D]`` the same heads' rows, ``w_k``/``w_v`` this rank's ``Kv / tp``
KV heads where ``tp`` divides ``Kv`` (whole otherwise: every rank then
projects the KV heads its query heads read), ``w_up``/``w_gate [D, F]``
and ``w_down [F, D]`` this rank's ``F / tp`` hidden units, the embedding
``[Vp, D]`` and the head ``[D, Vp]`` this rank's ``Vp / tp`` vocabulary
rows (the tied embedding serves both), MLA's ``w_uq``/``w_uk``/``w_uv``
and ``w_o`` its heads. The RG-LRU's ``w_in``, ``w_gate_branch`` and
``conv`` hold this rank's ``W / tp`` state channels and ``w_out`` their
rows; the SSM's ``w_z``, ``w_x``, ``conv_x``, ``gn`` its ``Din / tp``
channels (those of its ``H / tp`` SSD heads), ``w_dt``, ``A_log``, ``D``
and ``dt_bias`` those heads, ``w_out`` the channels' rows. Where ``tp``
does not divide the SSD heads the SSM runs whole on every rank
(``uncut``: its ``state`` dimensions stay whole, though the reference cuts
``Din`` where it divides; the same numbers). An expert tensor holds this
rank's experts. FSDP then cuts each local tensor into rows
(``parallel/fsdp.py``).

The stream between the blocks is a copy on every model rank, and every
rank computes the same loss. Where that copy meets a cut weight, the
reference's adjoint is an explicit ``torch.autograd.Function`` here:

- ``enter``: the stream entering a column-parallel product (q/k/v, the
  FFN's up and gate projections, the head, the recurrent blocks' input
  projections), or a whole weight whose gradient each rank holds only in
  part (KV projections that ``tp`` does not divide; MLA's down
  projections and norms; the RG-LRU's gate blocks, biases and ``lam``;
  the SSM's B/C projections and convolutions): identity forward,
  all-reduce backward;
- ``exit``: after a row-parallel product (the attention output ``w_o``,
  the FFN's ``w_down``, the recurrent blocks' ``w_out``): all-reduce
  forward, identity backward;
- ``psum``: ``exit`` then ``enter``, all-reduce both ways: the SSM's
  gated norm sums the squares of every rank's channels;
- ``gather_last``: the RG-LRU's gate input, every rank's channels laid end
  to end (all-gather forward; backward the sum over ``model`` of the
  cotangent, this rank's channels of it);
- ``gather_seq``: the sequence-sharded fallback (the reference's
  ``seq_model``, where ``tp`` does not divide the attention heads): each
  rank attends its block of ``S / tp`` query positions with whole weights
  (entered), and the blocks' outputs are laid end to end over ``model``;
  every rank computes the same loss from them, so each takes only its own
  block of the cotangent;
- ``embed``: the vocab-parallel lookup: rows outside this rank's range
  give zeros, then one ``exit``;
- ``cross_entropy``: the vocab-parallel loss: the max over ``model`` (no
  gradient: the log-sum-exp does not depend on it), the sum of
  exponentials and the target logit (from the rank that holds it) through
  ``exit``, so each rank's backward is its own columns' softmax minus its
  own one-hot;
- ``gather_vocab``: whole logits for serving (an all-gather, no
  autograd).

A recompute under rematerialisation repeats its forward all-reduces up
to the last tensor the backward needs, and the census
(``core/op_census.py``) counts them where they run.

``uncovered`` names what a model axis does not run: experts that do not
split over it, which the reference's ``shard_map`` does not run either.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.core.compression import all_gather, all_reduce, axis_group
from repro_torch.core.device import meta_empty
from repro_torch.parallel.sharding import axis_sizes

# the logical dimensions tensor parallelism cuts over ``model``
DENSE_DIMS = ("heads", "kv_heads", "mlp", "vocab", "state")


def uncovered(cfg, tp: int) -> str | None:
    """What of ``cfg`` a model axis of ``tp`` ranks does not run (None:
    all of it): experts that do not split over the ranks."""
    if cfg.moe is not None and cfg.moe.n_experts_padded % tp:
        return (f"{cfg.moe.n_experts_padded} experts do not split over "
                f"{tp} model ranks")
    return None


def uncut_dims(cfg, tp: int) -> tuple[str, ...]:
    """The dense dimensions that stay whole on ``tp`` model ranks where
    their sizes divide: the SSM's ``state`` where ``tp`` does not divide
    its heads (the mixer then runs whole on every rank)."""
    if cfg.ssm is not None and cfg.ssm.n_heads(cfg.d_model) % tp:
        return ("state",)
    return ()


class Tp:
    """The tensor-parallel layout on ``mesh``: ``tp`` model ranks, the
    dense dimensions cut but those of ``uncut``.
    ``rank`` and ``group`` are resolved at first use, so a stand-in mesh
    that only answers ``mesh_dim_names`` and ``size`` serves for
    shapes."""

    def __init__(self, mesh, uncut: tuple = ()):
        self.mesh = mesh
        self.tp = axis_sizes(mesh)["model"]
        self.uncut = tuple(uncut)

    @classmethod
    def of(cls, mesh, cfg):
        """The layout of ``cfg`` on ``mesh``, or None without a ``model``
        axis of more than one rank."""
        tp = axis_sizes(mesh).get("model", 1)
        if tp <= 1:
            return None
        return cls(mesh, uncut=uncut_dims(cfg, tp))

    @functools.cached_property
    def group(self):
        return axis_group("model", mesh=self.mesh)

    @functools.cached_property
    def rank(self) -> int:
        return self.mesh.get_local_rank("model")

    def on(self, n: int, dim: str = ""):
        """``self`` where a dense dimension of size ``n`` (named ``dim``)
        is cut (the rule applies), else None: the block runs whole on
        every rank."""
        if dim not in self.uncut and n % self.tp == 0:
            return self
        return None

    def seq(self, n_heads: int):
        """``self`` where attention of ``n_heads`` falls back to sequence
        sharding (the ranks do not divide its heads), else None."""
        return self if n_heads % self.tp else None

    # ------------------------------------------------------------------
    # the layout of one tensor (no autograd)
    # ------------------------------------------------------------------
    def cut_axis(self, shape, dims) -> int | None:
        """The dimension ``model`` cuts in a tensor of ``shape`` and
        logical ``dims`` (the reference's ``spec_for`` over ``model``), or
        None."""
        names = ("experts",) + DENSE_DIMS
        for i, (s, d) in enumerate(zip(shape, dims)):
            if d in names and d not in self.uncut:
                if d == "experts" or s % self.tp == 0:
                    return i
        return None

    def local_shape(self, shape, dims) -> tuple:
        """This rank's shape of a tensor of full ``shape``."""
        shape = tuple(shape)
        ax = self.cut_axis(shape, dims)
        if ax is None:
            return shape
        return shape[:ax] + (shape[ax] // self.tp,) + shape[ax + 1:]

    def own(self, full: torch.Tensor, dims, lead: int = 0) -> torch.Tensor:
        """This rank's part of ``full`` (a view; ``lead`` leading axes
        before the parameter's own, e.g. a stacked state's layer axis)."""
        ax = self.cut_axis(full.shape[lead:], dims)
        return full if ax is None else self.own_at(full, lead + ax)

    def whole(self, local: torch.Tensor, dims, full_shape,
              lead: int = 0) -> torch.Tensor:
        """Every rank's part of ``local`` (of a parameter of
        ``full_shape``, after ``lead`` leading axes) laid end to end on
        the cut axis: a collective of the model group."""
        ax = self.cut_axis(tuple(full_shape), dims)
        return local if ax is None else self.whole_at(local, lead + ax)

    def own_at(self, full: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's block of ``full`` along ``axis`` (a view)."""
        k = full.shape[axis] // self.tp
        return full.narrow(axis, self.rank * k, k)

    def whole_at(self, local: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's ``local`` laid end to end along ``axis``."""
        x = local.movedim(axis, 0).contiguous()
        return all_gather(x, self.group).movedim(0, axis)

    def shard_module(self, module, fill=None):
        """Replace each parameter of ``module`` (a ``ParamModule`` tree,
        its ``shapes`` the full ones) by this rank's part of ``fill(name,
        param)``, the full tensor, in a new tensor; without ``fill``, each
        cut tensor by an empty one of its local shape on the parameter's
        device (the others kept). -> ``module``."""
        for name, p in list(module.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = module.get_submodule(mod_name)
            dims = mod.dims[leaf]
            if fill is None:
                shape = self.local_shape(mod.shapes[leaf], dims)
                if shape == tuple(p.shape):
                    continue
                t = (meta_empty(shape, dtype=p.dtype) if p.is_meta else
                     torch.empty(shape, dtype=p.dtype, device=p.device))
            else:
                t = self.own(fill(name, p), dims).clone()
            mod._parameters[leaf] = torch.nn.Parameter(
                t, requires_grad=p.requires_grad)
        return module

    # ------------------------------------------------------------------
    # attention heads
    # ------------------------------------------------------------------
    def heads(self, H: int) -> tuple[int, int]:
        """(first, count) of this rank's query heads."""
        n = H // self.tp
        return self.rank * n, n

    def kv_heads(self, H: int, Kv: int) -> tuple[int, int, torch.Tensor | None]:
        """The KV heads this rank's query heads read: (first, count, index)
        into the whole KV heads where ``tp`` does not divide ``Kv`` (every
        rank projects them from the whole ``w_k``/``w_v``), ``index`` the
        KV head of each local query head when they do not fall in equal
        groups (None when they do: ``attend`` takes the count as it is);
        where ``tp`` divides ``Kv``, (this rank's first, Kv / tp, None)."""
        if Kv % self.tp == 0:
            n = Kv // self.tp
            return self.rank * n, n, None
        G = H // Kv
        h0, n = self.heads(H)
        kv = [(h0 + j) // G for j in range(n)]
        lo, cnt = kv[0], kv[-1] - kv[0] + 1
        if n % cnt == 0 and kv == [lo + j // (n // cnt) for j in range(n)]:
            return lo, cnt, None
        return lo, cnt, torch.tensor([k - lo for k in kv])

    # ------------------------------------------------------------------
    # the adjoints at the model boundary
    # ------------------------------------------------------------------
    def enter(self, x):
        return _Enter.apply(x, self.group)

    def exit(self, y):
        return _Exit.apply(y, self.group)

    def psum(self, x):
        """The sum of ``x`` over the model ranks, all-reduced both ways."""
        return self.enter(self.exit(x))

    def gather_last(self, x):
        """[..., n] -> [..., tp n]: every rank's ``x`` in rank order on
        the last axis."""
        return _GatherAt.apply(x, self, x.dim() - 1, True)

    def gather_seq(self, y):
        """[B, S / tp, ...] -> [B, S, ...]: every rank's block of
        positions in rank order."""
        return _GatherAt.apply(y, self, 1, False)

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` positions or channels."""
        k = n // self.tp
        return slice(self.rank * k, (self.rank + 1) * k)

    def embed(self, table, tokens):
        """Rows of the vocab-parallel ``table`` [Vp / tp, D] for
        ``tokens`` (global ids), summed over the model ranks."""
        V = table.shape[0]
        lo = self.rank * V
        mine = (tokens >= lo) & (tokens < lo + V)
        rows = table[torch.where(mine, tokens - lo, 0)]
        rows = rows * mine[..., None].to(rows.dtype)
        return self.exit(rows)

    def gather_vocab(self, logits):
        """[..., Vp / tp] -> [..., Vp]: every rank's columns in rank
        order (detached: serving reads them)."""
        x = logits.detach().movedim(-1, 0).contiguous()
        return all_gather(x, self.group).movedim(0, -1)

    def cross_entropy(self, logits, labels, *, vocab_real: int,
                      z_loss: float = 1e-4, ignore_index: int = -1):
        """``models/common.py::cross_entropy`` over vocab-parallel
        ``logits`` [..., Vp / tp] (this rank's columns): the same loss on
        every model rank."""
        V = logits.shape[-1]
        lo = self.rank * V
        lf = logits.float()
        if lo + V > vocab_real:         # this rank holds padded columns
            col = lo + torch.arange(V, device=lf.device)
            lf = lf + torch.where(col >= vocab_real, -1e9, 0.0).to(lf)
        with torch.no_grad():
            m = lf.amax(dim=-1)
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        se = self.exit(torch.exp(lf - m[..., None]).sum(dim=-1))
        lse = m + torch.log(se)
        mine = (labels >= lo) & (labels < lo + V)
        idx = torch.where(mine, labels - lo, 0).long()
        picked = torch.gather(lf, -1, idx[..., None])[..., 0]
        picked = self.exit(torch.where(mine, picked,
                                       torch.zeros((), device=lf.device)))
        nll = lse - picked
        if z_loss:
            nll = nll + z_loss * torch.square(lse)
        valid = labels != ignore_index
        nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
        return nll.sum() / torch.clamp_min(valid.sum(), 1)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        return all_reduce(y.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAt(torch.autograd.Function):
    """Every rank's ``x`` laid end to end along ``axis``. Backward: this
    rank's block of the cotangent, summed over ``model`` first where
    ``summed`` (each rank's cotangent a part; without it, every rank's
    cotangent is already the whole one)."""

    @staticmethod
    def forward(ctx, x, tp, axis, summed):
        ctx.tp, ctx.axis, ctx.summed, ctx.n = tp, axis, summed, x.shape[axis]
        return tp.whole_at(x, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = all_reduce(g.contiguous(), ctx.tp.group)
        return (g.narrow(ctx.axis, ctx.tp.rank * ctx.n, ctx.n).contiguous(),
                None, None, None)
