"""FSDP (ZeRO-3) over the data axes: what GSPMD inserts for the
reference's ``pod_param_mode`` "sharded" and "data".

Each parameter lives on every FSDP rank as one shard of rows
(``parallel/sharding.py::ShardSpec``): the full tensor viewed as [rows,
last dim], rank i holding rows [i r, (i + 1) r), flat, the last rank's
block zero-padded. ``Fsdp`` is the layout on one mesh: its FSDP axes (the
``"embed"`` rule's), their process group and this rank's index in it, and
the replica axes (``pod`` in "data" mode), over which the shards are
copies. On a mesh with a ``model`` axis (``tp``, ``parallel/tp.py``) the
FSDP group is that of this rank's model coordinate, and a tensor that
``model`` cuts (its heads, hidden units, vocabulary rows or experts,
``Tp.local_shape``) is this rank's part, cut into rows like any other:
the shapes a rank gathers and shards are its local ones.

``Fsdp.gather`` is the weights' all-gather as a ``torch.autograd.Function``
(``_Gather``): its forward all-gathers a group of shards into full
tensors, one ``all_gather`` per dtype; its backward reduce-scatters the
full gradients back into shards, one ``reduce_scatter`` per dtype (a sum
over the FSDP ranks; the step divides by the data-parallel size once),
then sums them over the replica axes. A tensor used twice (a tied
embedding) is gathered once and reduce-scattered once, with the sum of
its gradients. ``gather_trees`` gathers modules' parameters into dict
trees that the model's functions read as they read a ``ParamModule``
(buffers, such as the router biases, passed as they are).

Every rank issues the same collectives in the same order: the gathers in
the forward's order, the reduce-scatters in the backward's. The
collectives are ``core/compression.py``'s, so NCCL and gloo (ranks that
share a card, or the CPU) run the same code.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.compression import (all_gather, all_reduce,
                                          axis_group, reduce_scatter)
from repro_torch.parallel.sharding import (ShardSpec, axis_sizes,
                                           batch_axes, fsdp_axes)


class Fsdp:
    """The FSDP layout on ``mesh`` over ``axes``. ``ranks``: the FSDP
    ranks; ``index``, ``group`` and ``replica_group`` are resolved at first
    use, so a stand-in mesh that only answers ``mesh_dim_names`` and
    ``size`` serves for shapes (``abstract_state``). ``tp``: the
    ``parallel/tp.py::Tp`` layout of the model axis, or None."""

    def __init__(self, mesh, axes, tp=None):
        sizes = axis_sizes(mesh)
        self.mesh = mesh
        self.axes = tuple(axes)
        self.ranks = math.prod(sizes[a] for a in self.axes)
        self.replica_axes = tuple(a for a in batch_axes(mesh)
                                  if a not in self.axes)
        self.tp = tp

    @classmethod
    def of(cls, mesh, pod_param_mode: str, tp=None):
        """The layout of ``pod_param_mode`` on ``mesh`` (``tp`` its model
        axis's layout), or None where nothing is sharded (no mesh,
        "replicated", one FSDP rank)."""
        if mesh is None:
            return None
        axes = fsdp_axes(mesh, pod_param_mode)
        fs = cls(mesh, axes, tp) if axes else None
        return fs if fs is not None and fs.ranks > 1 else None

    @functools.cached_property
    def group(self):
        return axis_group(self.axes, mesh=self.mesh)

    @functools.cached_property
    def index(self) -> int:
        return dist.get_rank(self.group)

    @functools.cached_property
    def replica_group(self):
        return (axis_group(self.replica_axes, mesh=self.mesh)
                if self.replica_axes else None)

    def spec(self, shape) -> ShardSpec:
        return ShardSpec(tuple(shape), self.ranks)

    def local_shape(self, module, name: str) -> tuple:
        """The shape this rank shards of ``module``'s parameter ``name``:
        its schema shape, this rank's part where ``model`` cuts it."""
        shape = module.shapes[name]
        if self.tp is None:
            return tuple(shape)
        return self.tp.local_shape(shape, module.dims[name])

    def block(self, n: int, unit: int = 1) -> int:
        """Elements a rank holds of ``n`` split in blocks of ``unit``."""
        return -(-n // (self.ranks * unit)) * unit

    # ------------------------------------------------------------------
    # one tensor, no autograd (state construction, the optimizer,
    # checkpoints)
    # ------------------------------------------------------------------
    def own(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """This rank's ``k`` elements of the last axis of ``x`` [..., n]
        (elements [i k, (i + 1) k), zeros past n), in a new tensor."""
        lo = self.index * k
        mine = x[..., lo:lo + k]
        pad = k - mine.shape[-1]
        return (torch.nn.functional.pad(mine, (0, pad)) if pad
                else mine.clone())

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` [..., k] laid end to end on the last axis:
        [..., ranks * k]."""
        lead, k = tuple(x.shape[:-1]), x.shape[-1]
        got = all_gather(x.reshape(1, -1), self.group)      # [ranks, L k]
        return got.view(self.ranks, -1, k).permute(1, 0, 2).reshape(
            *lead, self.ranks * k)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's row shard of ``full``, flat."""
        return self.own(full.reshape(-1), self.spec(full.shape).numel)

    def full(self, shard: torch.Tensor, shape) -> torch.Tensor:
        """The whole tensor of ``shape`` from every rank's ``shard``."""
        return self.gather_last(shard)[:math.prod(shape)].view(shape)

    # ------------------------------------------------------------------
    # the weights' gather under autograd
    # ------------------------------------------------------------------
    def gather(self, shards, shapes) -> list:
        """Full tensors of ``shapes`` from this rank's ``shards`` (one
        all-gather per dtype); the backward reduce-scatters their
        gradients into the shards'."""
        if not shards:
            return []
        out = _Gather.apply(self, tuple(map(tuple, shapes)), *shards)
        return list(out) if isinstance(out, tuple) else [out]

    def gather_trees(self, modules) -> list[dict]:
        """Each of ``modules`` (``ParamModule``s holding shards) as a dict
        tree of full parameters, its buffers and its submodules' trees, all
        the parameters gathered in one call."""
        entries = []

        def walk(m, path):
            for n, p in m._parameters.items():
                entries.append((path, n, p, self.local_shape(m, n)))
            for n, sub in m._modules.items():
                walk(sub, path + (n,))

        for j, m in enumerate(modules):
            walk(m, (j,))
        fulls = self.gather([e[2] for e in entries], [e[3] for e in entries])
        got = {(path, n): f for (path, n, _, _), f in zip(entries, fulls)}

        def build(m, path):
            d = {n: got[(path, n)] for n in m._parameters}
            d.update(m._buffers)
            d.update({n: build(sub, path + (n,))
                      for n, sub in m._modules.items()})
            return d

        return [build(m, (j,)) for j, m in enumerate(modules)]

    def shard_module(self, module: nn.Module, fill=None) -> nn.Module:
        """Replace each parameter of ``module`` (a ``ParamModule`` tree, its
        ``shapes`` the full ones) by this rank's shard of ``fill(name,
        param)``, the full tensor (this rank's part of a tensor ``model``
        cuts first); without ``fill``, by an empty shard on the parameter's
        device (``meta``: shapes only). -> ``module``."""
        for name, p in list(module.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = module.get_submodule(mod_name)
            if fill is None:
                t = torch.empty(self.spec(self.local_shape(mod, leaf)).numel,
                                dtype=p.dtype, device=p.device)
            else:
                full = fill(name, p)
                if self.tp is not None:
                    full = self.tp.own(full, mod.dims[leaf])
                t = self.shard(full)
            mod._parameters[leaf] = nn.Parameter(
                t, requires_grad=p.requires_grad)
        return module


def _by_dtype(tensors) -> list[list[int]]:
    """Indices of ``tensors`` grouped by dtype, in first-seen order."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


class _Gather(torch.autograd.Function):
    """shards -> full tensors (all-gather); full gradients -> shard
    gradients (reduce-scatter, then the replica sum)."""

    @staticmethod
    def forward(ctx, fs: Fsdp, shapes, *shards):
        ctx.fs, ctx.shapes = fs, shapes
        ctx.ks = [s.numel() for s in shards]
        out = [None] * len(shards)
        for idx in _by_dtype(shards):
            buf = torch.cat([shards[i].reshape(-1) for i in idx])
            got = all_gather(buf.reshape(1, -1), fs.group)   # [ranks, K]
            off = 0
            for i in idx:
                k, n = ctx.ks[i], math.prod(shapes[i])
                out[i] = got[:, off:off + k].reshape(-1)[:n].view(shapes[i])
                off += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        fs, ks = ctx.fs, ctx.ks
        out = [None] * len(grads)
        for idx in _by_dtype(grads):
            parts = []
            for i in idx:
                g = grads[i].reshape(-1)
                pad = fs.ranks * ks[i] - g.numel()
                if pad:
                    g = torch.nn.functional.pad(g, (0, pad))
                parts.append(g.view(fs.ranks, ks[i]))
            red = reduce_scatter(torch.cat(parts, dim=1), fs.group)[0]
            if fs.replica_group is not None:
                red = all_reduce(red, fs.replica_group)
            off = 0
            for i in idx:
                out[i] = red[off:off + ks[i]]
                off += ks[i]
        return (None, None, *out)
