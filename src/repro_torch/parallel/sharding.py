"""Logical-axis rules and the batch's split over a mesh: the part of the
JAX package's ``parallel/sharding.py`` that training reads.

The port's meshes are ``torch.distributed`` device meshes
(``launch/mesh.py``) with the reference's axis names. ``make_rules``
validates ``pod_param_mode`` and says which axes each logical dimension
would shard over; the data-parallel step reads only ``"batch"``.
``batch_spec`` is the rows of the global batch that this rank takes. The
parameter schema half (``ParamDef``, ``tree_map_schema``,
``init_params``) is ``models/params.py``; ``spec_for``, ``sharding_tree``
and ``shard_act`` wait for FSDP over the data axis (ROADMAP queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass


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


def batch_axes(mesh=None) -> tuple[str, ...]:
    """The mesh's batch (data-parallel) axes, ``pod`` before ``data``."""
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def batch_size(mesh=None) -> int:
    """Ranks over the batch axes (1 without a mesh)."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.size(_names(mesh).index(a))
    return n


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
