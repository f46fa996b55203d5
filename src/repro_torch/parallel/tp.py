"""Tensor parallelism over the ``model`` axis: the layout of a parameter on
one model rank and the collectives that GSPMD inserts for the reference's
``model`` rules (``parallel/sharding.py::make_rules``: ``heads``,
``kv_heads``, ``mlp``, ``vocab``; ``experts`` is ``parallel/ep.py``'s).

A parameter is cut where the reference's ``spec_for`` puts ``model``: at
its first dimension whose logical name maps to ``model`` and whose size the
model ranks divide (an axis is used once), else it is whole on every model
rank. So ``w_q [D, H, dh]`` holds this rank's ``H / tp`` heads, ``w_o
[H, dh, D]`` the same heads' rows, ``w_k``/``w_v`` this rank's ``Kv / tp``
KV heads where ``tp`` divides ``Kv`` (whole otherwise: every rank then
projects the KV heads its query heads read), ``w_up``/``w_gate [D, F]``
and ``w_down [F, D]`` this rank's ``F / tp`` hidden units, the embedding
``[Vp, D]`` and the head ``[D, Vp]`` this rank's ``Vp / tp`` vocabulary
rows (the tied embedding serves both). An expert tensor holds this rank's
experts. FSDP then cuts each local tensor into rows
(``parallel/fsdp.py``).

The stream between the blocks is a copy on every model rank, and every
rank computes the same loss. Where that copy meets a cut weight, the
reference's adjoint is an explicit ``torch.autograd.Function`` here:

- ``enter``: the stream entering a column-parallel product (q/k/v, the
  FFN's up and gate projections, the head), or a whole weight whose
  gradient each rank holds only in part (KV projections that ``tp`` does
  not divide): identity forward, all-reduce backward;
- ``exit``: after a row-parallel product (the attention output ``w_o``,
  the FFN's ``w_down``): all-reduce forward, identity backward;
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

``Tp.dense`` is False where the config's mixers are not GQA attention with
heads that ``tp`` divides (``uncovered``): then only the experts are cut
(``parallel/ep.py``'s expert-parallel layout), and every other tensor is a
copy over ``model``.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.core.compression import all_gather, all_reduce, axis_group
from repro_torch.parallel.sharding import axis_sizes

# the logical dimensions tensor parallelism cuts over ``model``
DENSE_DIMS = ("heads", "kv_heads", "mlp", "vocab")


def uncovered(cfg, tp: int) -> str | None:
    """What of ``cfg`` tensor parallelism over ``tp`` model ranks does not
    cover (None: every mixer is GQA attention whose heads ``tp``
    divides)."""
    kinds = set(cfg.layer_kinds)
    if "ssm" in kinds:
        return "the SSM mixer's heads and state dims"
    if "rglru" in kinds:
        return "the RG-LRU mixer's state dims"
    if cfg.mla is not None:
        return "MLA's heads"
    if cfg.n_heads % tp:
        return (f"sequence-sharded attention ({cfg.n_heads} heads on {tp} "
                "model ranks)")
    return None


class Tp:
    """The tensor-parallel layout on ``mesh``: ``tp`` model ranks, the
    dense dimensions cut where ``dense``. ``rank`` and ``group`` are
    resolved at first use, so a stand-in mesh that only answers
    ``mesh_dim_names`` and ``size`` serves for shapes."""

    def __init__(self, mesh, dense: bool = True):
        self.mesh = mesh
        self.tp = axis_sizes(mesh)["model"]
        self.dense = dense

    @classmethod
    def of(cls, mesh, cfg):
        """The layout of ``cfg`` on ``mesh``, or None without a ``model``
        axis of more than one rank."""
        tp = axis_sizes(mesh).get("model", 1)
        if tp <= 1:
            return None
        return cls(mesh, dense=uncovered(cfg, tp) is None)

    @functools.cached_property
    def group(self):
        return axis_group("model", mesh=self.mesh)

    @functools.cached_property
    def rank(self) -> int:
        return self.mesh.get_local_rank("model")

    def on(self, n: int):
        """``self`` where a dense dimension of size ``n`` is cut (the rule
        applies), else None: the block runs whole on every rank."""
        return self if self.dense and n % self.tp == 0 else None

    # ------------------------------------------------------------------
    # the layout of one tensor (no autograd)
    # ------------------------------------------------------------------
    def cut_axis(self, shape, dims) -> int | None:
        """The dimension ``model`` cuts in a tensor of ``shape`` and
        logical ``dims`` (the reference's ``spec_for`` over ``model``), or
        None."""
        names = ("experts",) + (DENSE_DIMS if self.dense else ())
        for i, (s, d) in enumerate(zip(shape, dims)):
            if d in names:
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
                t = torch.empty(shape, dtype=p.dtype, device=p.device)
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
