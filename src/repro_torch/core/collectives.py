"""Hierarchical, optionally compressed all-reduce over a mesh.

The port of ``repro.core.collectives``. The paper's transport insight:
local (same-node, shared-memory) bytes are cheap; remote (TCP) bytes are
expensive and can only be *reduced*, not accelerated. On a multi-pod mesh
the same split exists between the links inside a pod and those across
pods. The hierarchical schedule moves 1/|inner| of the bytes across pods:

    flat:          all-reduce over (pod, data)           cross-pod bytes ~ n
    hierarchical:  reduce-scatter over data (in the pod)
                   -> all-reduce over pod on n/|data|    cross-pod bytes ~ n/|data|
                   -> all-gather over data (in the pod)

``codec="int8"`` quantizes the cross-pod phase (``compressed_psum_1d``,
the LZO analogue applied where the paper applied it: on the wire that
cannot be made faster).

Every rank calls these with its own ``x``; axes are the mesh's dim names,
resolved to its process groups (``core/compression.py::axis_group``).
"""
from __future__ import annotations

import torch

from repro_torch.core.compression import (all_gather, all_reduce,
                                          axis_group, axis_size,
                                          compressed_psum_1d, reduce_scatter)


def flat_psum(x: torch.Tensor, axes, *, mesh) -> torch.Tensor:
    """Sum of ``x`` over ``axes`` (a dim name or a tuple of them): one
    all-reduce over all their ranks."""
    return all_reduce(x, axis_group(axes, mesh=mesh))


def hierarchical_psum_1d(x: torch.Tensor, inner_axis: str | None,
                         outer_axis: str | None, codec: str = "none", *,
                         mesh) -> torch.Tensor:
    """x: [n] on each rank -> the (outer, inner)-all-reduced vector.

    ``inner_axis``: the fast axis inside a pod (reduce-scatter, then
    all-gather); ``outer_axis``: the slow axis across pods (all-reduce of
    the scattered shard, int8-compressed with ``codec="int8"``)."""
    n = x.shape[0]
    if inner_axis is None:
        if outer_axis is None:
            return x
        return (compressed_psum_1d(x, outer_axis, mesh=mesh)
                if codec == "int8"
                else all_reduce(x, axis_group(outer_axis, mesh=mesh)))
    inner = axis_group(inner_axis, mesh=mesh)
    R = axis_size(inner_axis, mesh=mesh)
    xp = torch.nn.functional.pad(x, (0, (-n) % R))
    shard = reduce_scatter(xp, inner)
    if outer_axis is not None:
        shard = (compressed_psum_1d(shard, outer_axis, mesh=mesh)
                 if codec == "int8"
                 else all_reduce(shard, axis_group(outer_axis, mesh=mesh)))
    return all_gather(shard, inner)[:n]
