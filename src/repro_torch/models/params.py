"""Parameter schemas and the modules built from them.

The counterpart of the parts of the JAX package's ``parallel/sharding.py``
the model needs: ``ParamDef`` (shape, logical dims, init), ``tree_map_schema``
and ``init_params``. The axis rules, the parameters' shards and the
batch's split are ``parallel/sharding.py``.

``ParamModule`` turns a schema into an ``nn.Module``: a ``ParamDef`` leaf
becomes a parameter of the same name, a nested dict a submodule. It reads
like the JAX parameter tree (``m["attn"]["w_q"]``, ``m.get("norm1")``), so
the model's plain functions take either.

Init draws from an explicit ``torch.Generator`` seeded per parameter path
with ``zlib.crc32``, stable across processes. (The JAX init folds in
Python's ``hash()``, salted per process, so the two inits cannot match;
parity tests carry the JAX parameters across, ``models/convert.py``.)
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from repro_torch.core.device import meta_empty, resolve_device


@dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical dims + init."""
    shape: tuple[int, ...]
    dims: tuple[Any, ...]            # logical names (str) or None, len == rank
    init: str = "normal"             # normal | zeros | ones
    scale: float = -1.0              # -1 -> 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"shape {self.shape} and dims {self.dims} differ "
                             "in rank")


def tree_map_schema(fn, schema):
    """Map over a nested dict (or list) schema whose leaves are ParamDefs,
    keeping paths."""
    def rec(node, path):
        if isinstance(node, ParamDef):
            return fn(path, node)
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v, path + (i,)) for i, v in enumerate(node)]
        raise TypeError(f"bad schema node at {path}: {type(node)}")
    return rec(schema, ())


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _init_scale(pd: ParamDef) -> float:
    if pd.scale >= 0:
        return pd.scale
    fan_in = pd.shape[0] if pd.shape else 1
    for s, d in zip(pd.shape, pd.dims):
        if d == "embed":            # prefer the model dim as fan-in when marked
            fan_in = s
            break
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_tensor(path, pd: ParamDef, *, seed: int = 0, device="cpu",
                dtype=None) -> torch.Tensor:
    """One parameter: zeros, ones, or N(0, 1) * scale drawn in f32 from a
    generator on ``device`` seeded by ``crc32(f"{seed}/{path}")``."""
    dt = torch_dtype(dtype or pd.dtype)
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    key = f"{seed}/" + "/".join(map(str, path))
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(key.encode()))
    x = torch.randn(pd.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * _init_scale(pd)).to(dt)


def init_params(schema, *, seed: int = 0, device=None, dtype=None):
    """Materialize a schema into tensors (deterministic per path) on
    ``device``: ``None`` means the card (``resolve_device``)."""
    device = resolve_device(device)
    return tree_map_schema(
        lambda path, pd: init_tensor(path, pd, seed=seed, device=device,
                                     dtype=dtype), schema)


def schema_leaves(schema) -> dict:
    """``{"stack.0.attn.w_q": ParamDef, ...}``: the leaves by the dotted
    path that ``nn.Module.named_parameters`` gives a ``ParamModule``."""
    out = {}
    tree_map_schema(lambda path, pd: out.__setitem__(
        ".".join(map(str, path)), pd), schema)
    return out


@torch.no_grad()
def init_module(module: nn.Module, schema, *, seed: int = 0) -> None:
    """Fill every parameter of ``module`` (laid out as ``schema``) in place
    with ``init_tensor`` on its own device and dtype."""
    leaves = schema_leaves(schema)
    for name, p in module.named_parameters():
        p.copy_(init_tensor(name.split("."), leaves[name], seed=seed,
                            device=p.device, dtype=p.dtype))


class ParamModule(nn.Module):
    """An ``nn.Module`` laid out as a schema: each ``ParamDef`` leaf is a
    parameter, each nested dict a ``ParamModule``; ``shapes`` keeps each
    parameter's schema shape by name (an FSDP shard is one rank's rows of
    it, ``parallel/fsdp.py``). Parameters start with
    ``requires_grad=False`` (serving needs no graph); ``trainable(True)``
    turns them on for training. Subclasses add submodules of their own
    kind with ``add_module`` and state with ``register_buffer`` (the MoE's
    router bias, which no optimizer updates). Items (parameters, buffers,
    submodules) read like the JAX tree. ``dims`` keeps each parameter's
    logical dimensions (``"experts"`` first: split over the ``model`` axis,
    ``parallel/ep.py``).
    ``device=None`` means the card (``resolve_device``)."""

    def __init__(self, schema: dict | None = None, *, device=None,
                 dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.shapes: dict[str, tuple[int, ...]] = {}
        self.dims: dict[str, tuple] = {}
        for name, node in (schema or {}).items():
            if isinstance(node, ParamDef):
                self.shapes[name] = tuple(node.shape)
                self.dims[name] = tuple(node.dims)
                dt = torch_dtype(dtype or node.dtype)
                t = (meta_empty(node.shape, dtype=dt) if device.type == "meta"
                     else torch.empty(node.shape, device=device, dtype=dt))
                self.register_parameter(name, nn.Parameter(
                    t, requires_grad=False))
            else:
                self.add_module(name, ParamModule(node, device=device,
                                                  dtype=dtype))

    def __getitem__(self, name: str):
        for table in (self._parameters, self._buffers, self._modules):
            if name in table:
                return table[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return (name in self._parameters or name in self._buffers
                or name in self._modules)

    def get(self, name: str, default=None):
        return self[name] if name in self else default

    def trainable(self, on: bool = True):
        """Set ``requires_grad`` of every parameter (buffers stay state).
        -> self."""
        for p in self.parameters():
            p.requires_grad_(on)
        return self
