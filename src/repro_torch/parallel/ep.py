"""Expert parallelism over the ``model`` axis: the layout and the adjoints
at the model boundary (the part of the JAX package's ``models/moe.py``
that ``shard_map`` gives it implicitly).

The experts of every MoE layer are split over the ``model`` ranks: rank r
holds experts [r E_loc, (r + 1) E_loc), E_loc = E_pad / tp, of each
``w_gate``/``w_up``/``w_down`` (the leaves whose first logical dimension
is ``"experts"``, the reference's ``P('model', ...)``). Every other
parameter, and every activation outside the MoE body, is a copy on each
model rank: the model ranks compute the same numbers and the same loss.

Where a replicated value enters the body, or a body value leaves it, the
reference's adjoint is an explicit ``torch.autograd.Function`` here:

- ``enter``: the tokens ``x`` and the router weight. A model rank reads
  only its slice of the tokens, so its gradient holds only that slice's
  part; the sum over ``model`` is the whole gradient. Identity forward,
  all-reduce backward.
- ``gather_slices``: ``y`` from each rank's token slices, all-gathered
  over ``model``. Every model rank computes the same loss from the
  gathered ``y``, so each takes only its own slice of the cotangent (a
  sum would count it ``tp`` times).
- ``replicated``: ``y`` where every rank dispatched all tokens (a chunk
  that ``tp`` does not divide): the ranks' copies are ``tp`` evaluations
  of one function, so each passes a ``tp``-th of the cotangent on.
- ``mean``: ``aux`` averaged over ``model``; its backward hands each rank
  a ``tp``-th of the cotangent and reduces nothing
  (``torch.distributed.nn``'s ``all_reduce`` would all-reduce again).
- ``all_to_all``: the dispatch and return trip, int8 with one scale a
  destination block in both directions under ``compress``
  (``compressed_all_to_all``); an all-to-all is its own adjoint.

The collectives are ``core/compression.py``'s, on the mesh's ``model``
group: NCCL, or gloo on ranks that share a card or on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.compression import (all_gather, all_reduce,
                                          all_to_all, axis_group)
from repro_torch.parallel.sharding import axis_sizes


def is_expert(dims) -> bool:
    """Whether a parameter of logical ``dims`` is split over ``model``."""
    return bool(dims) and dims[0] == "experts"


class Ep:
    """The expert-parallel layout on ``mesh``: ``tp`` model ranks. ``rank``
    and ``group`` are resolved at first use, so a stand-in mesh that only
    answers ``mesh_dim_names`` and ``size`` serves for shapes."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.tp = axis_sizes(mesh)["model"]

    @classmethod
    def of(cls, mesh):
        """The layout on ``mesh``, or None without a ``model`` axis of more
        than one rank."""
        if axis_sizes(mesh).get("model", 1) <= 1:
            return None
        return cls(mesh)

    @functools.cached_property
    def group(self):
        return axis_group("model", mesh=self.mesh)

    @functools.cached_property
    def rank(self) -> int:
        return self.mesh.get_local_rank("model")

    def check(self, n_experts_padded: int) -> None:
        if n_experts_padded % self.tp:
            raise ValueError(f"{n_experts_padded} experts do not split over "
                             f"{self.tp} model ranks")

    # ------------------------------------------------------------------
    # the layout of one parameter (no autograd)
    # ------------------------------------------------------------------
    def local_shape(self, shape, dims) -> tuple:
        """This rank's shape of a parameter of full ``shape``."""
        shape = tuple(shape)
        if not is_expert(dims):
            return shape
        return (shape[0] // self.tp,) + shape[1:]

    def own(self, full: torch.Tensor, dims, axis: int = 0) -> torch.Tensor:
        """This rank's experts of ``full`` (the expert axis ``axis``)."""
        if not is_expert(dims):
            return full
        k = full.shape[axis] // self.tp
        return full.narrow(axis, self.rank * k, k)

    def whole(self, local: torch.Tensor, dims, axis: int = 0
              ) -> torch.Tensor:
        """Every rank's experts of ``local`` in rank order (a collective
        of the model group)."""
        if not is_expert(dims):
            return local
        x = local.movedim(axis, 0).contiguous()
        got = all_gather(x, self.group)
        return got.movedim(0, axis)

    def shard_module(self, module, fill=None):
        """Replace each parameter of ``module`` (a ``ParamModule`` tree, its
        ``shapes`` the full ones) by ``fill(name, param)``, the full
        tensor, an expert tensor by this rank's experts of it in a new
        tensor; without ``fill``, each expert tensor by an empty one of its
        local shape on the parameter's device (the others kept).
        -> ``module``."""
        for name, p in list(module.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = module.get_submodule(mod_name)
            if not is_expert(mod.dims[leaf]):
                if fill is not None:
                    mod._parameters[leaf] = torch.nn.Parameter(
                        fill(name, p), requires_grad=p.requires_grad)
                continue
            if fill is None:
                t = torch.empty(self.local_shape(mod.shapes[leaf],
                                                 mod.dims[leaf]),
                                dtype=p.dtype, device=p.device)
            else:
                t = self.own(fill(name, p), mod.dims[leaf]).clone()
            mod._parameters[leaf] = torch.nn.Parameter(
                t, requires_grad=p.requires_grad)
        return module

    # ------------------------------------------------------------------
    # the adjoints at the model boundary
    # ------------------------------------------------------------------
    def enter(self, x):
        return _Enter.apply(x, self.group)

    def gather_slices(self, y):
        """y [nch, ntok, D], this rank's slice of each chunk -> [nch * tp *
        ntok, D], each chunk's slices in rank order."""
        return _GatherSlices.apply(y, self.group, self.tp, self.rank)

    def replicated(self, y):
        return _Scale.apply(y, 1.0 / self.tp)

    def mean(self, a):
        return _Mean.apply(a, self.group, self.tp)

    def all_to_all(self, x, compress: bool = False):
        """x [tp, ...]: block r to rank r, block j of the result from rank j;
        int8 with a scale a block under ``compress``."""
        return _AllToAll.apply(x, self.group, compress)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, tp, rank):
        ctx.tp, ctx.rank, ctx.shape = tp, rank, tuple(y.shape)
        nch, ntok, D = y.shape
        got = all_gather(y.contiguous(), group).view(tp, nch, ntok, D)
        return got.transpose(0, 1).reshape(nch * tp * ntok, D)

    @staticmethod
    def backward(ctx, g):
        nch, ntok, D = ctx.shape
        g = g.reshape(nch, ctx.tp, ntok, D)[:, ctx.rank]
        return g.contiguous(), None, None, None


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, group, tp):
        ctx.tp = tp
        return all_reduce(a, group) / tp

    @staticmethod
    def backward(ctx, g):
        return g / ctx.tp, None, None


# ---------------------------------------------------------------------------
# The int8 all-to-all (the reference's ``_q8``/``_dq8``/
# ``compressed_all_to_all``)
# ---------------------------------------------------------------------------

def q8(x: torch.Tensor):
    """x [R, ...] -> (int8 codes, f32 scale [R, 1, ...]): one scale a
    block x[r], max |x[r]| / 127 floored at 1e-12; codes rounded half to
    even and clipped to +-127."""
    dims = tuple(range(1, x.dim()))
    scale = x.abs().amax(dim=dims, keepdim=True).float() / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dq8(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def q8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """dq8(q8(x)): what a block looks like after one compressed hop."""
    q, s = q8(x)
    return dq8(q, s, x.dtype)


def compressed_all_to_all(x: torch.Tensor, group, compress: bool):
    """The exchange of ``x`` [R, ...] over ``group``: int8 codes and one
    f32 scale a block under ``compress``, else ``x`` as it is."""
    if not compress:
        return all_to_all(x, group)
    q, s = q8(x)
    return dq8(all_to_all(q, group), all_to_all(s, group), x.dtype)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, compress):
        ctx.group, ctx.compress = group, compress
        return compressed_all_to_all(x, group, compress)

    @staticmethod
    def backward(ctx, g):
        return compressed_all_to_all(g, ctx.group, ctx.compress), None, None
