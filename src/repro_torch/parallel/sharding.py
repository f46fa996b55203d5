"""Logical-axis rules, the parameters' shards and the batch's split over a
mesh: the part of the JAX package's ``parallel/sharding.py`` that training
reads.

The port's meshes are ``torch.distributed`` device meshes
(``launch/mesh.py``) with the reference's axis names. ``make_rules``
validates ``pod_param_mode`` and says which axes each logical dimension
shards over; ``spec_for`` is the reference's rule for one shape (an axis
that does not divide its dimension is dropped). ``batch_spec`` is the rows
of the global batch that this rank takes.

FSDP (``pod_param_mode`` "sharded" or "data") shards over the axes of the
``"embed"`` rule (``fsdp_axes``). The reference shards the dimension that
``spec_for`` names and replicates a parameter that has none; the port
shards every parameter by rows instead (``ShardSpec``: the tensor viewed as
[rows, last dim], rows split evenly over the FSDP ranks, the last rank's
block zero-padded), so each rank holds 1/F of every parameter, its
gradient and its optimizer state. On a ``model`` axis a parameter is first
cut where ``spec_for`` puts ``model`` (``parallel/tp.py``: this rank's
heads, hidden units, vocabulary rows or experts), and FSDP cuts that local
tensor into rows. ``sharding_tree`` gives each parameter's ``ShardSpec``
of its local shape; ``parallel/fsdp.py`` gathers and reduce-scatters them.
The parameter schema half (``ParamDef``, ``tree_map_schema``,
``init_params``) is ``models/params.py``. The reference's ``shard_act``
(activation constraints) has no counterpart: under a ``model`` axis the
port's blocks run their collectives themselves (``parallel/tp.py``), and
on the data axes each rank already holds only its own rows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.models.params import tree_map_schema


@dataclass(frozen=True)
class AxisRules:
    """Logical axis -> tuple of mesh axis names."""
    rules: dict[str, tuple[str, ...]]

    def axes_for(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return self.rules.get(logical, ())


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def make_rules(mesh=None, *, pod_param_mode: str = "sharded") -> AxisRules:
    """pod_param_mode: 'sharded' (FSDP over pod+data), 'data' (FSDP within
    pod, replicated across pods), 'replicated' (pure DP: params replicated
    over pod+data, TP over model only — the paper-faithful Hadoop-style
    baseline). ``mesh`` None is one device: every rule is empty."""
    names = set(_names(mesh))
    batch = tuple(a for a in ("pod", "data") if a in names)
    if pod_param_mode == "sharded":
        fsdp = batch
    elif pod_param_mode == "data":
        fsdp = tuple(a for a in ("data",) if a in names)
    elif pod_param_mode == "replicated":
        fsdp = ()
    else:
        raise ValueError(pod_param_mode)
    model = ("model",) if "model" in names else ()
    return AxisRules(rules={
        "batch": batch, "embed": fsdp, "vocab": model, "mlp": model,
        "heads": model, "kv_heads": model, "head_dim": model,
        "experts": model, "expert_ff": fsdp, "state": model,
        "seq_model": model, "seq": (), "layers": ()})


def axis_sizes(mesh=None) -> dict[str, int]:
    """``{axis name: ranks along it}`` (empty without a mesh)."""
    return {a: int(mesh.size(i)) for i, a in enumerate(_names(mesh))}


def _axes_fit(size: int, axes: tuple[str, ...], mesh) -> bool:
    sizes = axis_sizes(mesh)
    if any(a not in sizes for a in axes):
        return False
    prod = math.prod(sizes[a] for a in axes)
    return prod > 0 and size % prod == 0


def spec_for(shape, dims, mesh=None, rules: AxisRules | None = None
             ) -> tuple:
    """The reference's ``PartitionSpec`` for ``shape`` with logical
    ``dims``, as a tuple: per dimension the mesh axis (or tuple of axes) it
    shards over, or None; an axis already used, or whose ranks do not
    divide the dimension, is dropped; trailing Nones are cut."""
    if mesh is None or rules is None:
        return ()
    used: set[str] = set()
    parts: list = []
    for size, logical in zip(shape, dims):
        axes = tuple(a for a in rules.axes_for(logical) if a not in used)
        if axes and _axes_fit(size, axes, mesh):
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def fsdp_axes(mesh=None, pod_param_mode: str = "sharded") -> tuple[str, ...]:
    """The axes FSDP shards parameters over: the ``"embed"`` rule's
    (``pod`` and ``data`` in "sharded", ``data`` in "data", none in
    "replicated" or without a mesh)."""
    return make_rules(mesh, pod_param_mode=pod_param_mode).axes_for("embed")


@dataclass(frozen=True)
class ShardSpec:
    """One parameter's row shard: the full ``shape`` viewed as [rows, c]
    (c its last dimension; 1 for a vector or a scalar), ``rows_per_rank``
    = ceil(rows / ranks) rows a rank. Rank i holds rows [i r, (i + 1) r),
    zero rows past the end, flat: ``numel`` elements."""
    shape: tuple[int, ...]
    ranks: int

    @property
    def c(self) -> int:
        return self.shape[-1] if len(self.shape) >= 2 else 1

    @property
    def rows(self) -> int:
        return math.prod(self.shape) // max(self.c, 1)

    @property
    def rows_per_rank(self) -> int:
        return -(-self.rows // self.ranks)

    @property
    def numel(self) -> int:
        return self.rows_per_rank * self.c


def sharding_tree(schema, mesh, rules: AxisRules, tp=None):
    """A ``ShardSpec`` for every ``ParamDef`` of ``schema``, over the
    ranks of the FSDP axes (``rules``' ``"embed"``): each parameter's shard
    on this rank, of its part on this model rank first where ``tp`` (a
    ``parallel/tp.py::Tp``) cuts it."""
    sizes = axis_sizes(mesh)
    ranks = math.prod(sizes[a] for a in rules.axes_for("embed"))

    def spec(path, pd):
        shape = tuple(pd.shape)
        if tp is not None:
            shape = tp.local_shape(shape, pd.dims)
        return ShardSpec(shape, ranks)
    return tree_map_schema(spec, schema)


def batch_axes(mesh=None) -> tuple[str, ...]:
    """The mesh's batch (data-parallel) axes, ``pod`` before ``data``."""
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def batch_size(mesh=None) -> int:
    """Ranks over the batch axes (1 without a mesh)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def batch_spec(n_rows: int, mesh=None) -> slice:
    """The rows of a global batch of ``n_rows`` that this rank takes: its
    block of ``n_rows / batch_size`` rows, by its row-major index over the
    batch axes (the reference's ``P(("pod", "data"))`` on dim 0)."""
    R = batch_size(mesh)
    if n_rows % R:
        raise ValueError(f"a batch of {n_rows} rows does not split over "
                         f"{R} data-parallel ranks")
    idx = 0
    for a in batch_axes(mesh):
        i = _names(mesh).index(a)
        idx = idx * mesh.size(i) + mesh.get_local_rank(a)
    n = n_rows // R
    return slice(idx * n, (idx + 1) * n)
