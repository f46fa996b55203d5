"""Carry the JAX package's parameter and cache trees into the port.

The reference stacks each scan group's layers on a leading axis
(``tree["stack"]["g0"]["l0"]["attn"]["w_q"]`` is ``[n, D, H, dh]``, and
``["tail"]`` holds an unstacked remainder); the port keeps one entry per
layer: ``{"attn": ...}``, ``{"ssm": ...}`` or ``{"rec": ...}``, ``ffn`` or
``moe``, for gemma2 ``post1``/``post2`` and, for MusicGen, ``norm_x`` and
``cross`` (whose cache entry, ``[n, B, cond_len, Kv, dh]`` per group in the
reference, lands under the layer's ``"cross"``). The reference's router biases
are a tree of their own (``{g<i>: {l<j>: [n, E_pad]}, tail: ...}``, only
the groups that hold MoE layers); each lands in its layer's ``moe.bias``
buffer. The trees come in as numpy arrays (bf16 arrays as ``ml_dtypes``'
bfloat16, widened to f32 on the way, which is exact), so both frameworks
compute from the same numbers.

``params_to_numpy`` goes the other way: an ``LM``'s parameters as the
reference's tree (stacked leaves, numpy), the reference's parameters for
the port's weights.

``state_from_numpy`` carries a whole train state across: the parameters
and biases as above, the optimizer state (bucketed moments as they are:
the port's buckets hold the reference's elements in its order; per-tensor
moments unstacked by parameter name; Adafactor's factored states kept in
the reference's stacked shapes, by its key paths), the step and the
error-feedback residuals.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.models.transformer import layer_plan, plan_layers


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(stack: dict, cfg: ArchConfig) -> list:
    """The reference's ``{g<i>: {l<j>: ...[n, ...]}, tail: ...}`` -> one
    tree per layer, in layer order; None for a layer the tree lacks (the
    biases tree holds MoE layers only)."""
    groups, tail = plan_layers(cfg)
    layers = []
    for gi, (sig, cnt) in enumerate(groups):
        group = stack.get(f"g{gi}", {})
        for u in range(cnt):
            layers += [_map(lambda a, u=u: np.asarray(a)[u], group[f"l{li}"])
                       if f"l{li}" in group else None
                       for li in range(len(sig))]
    if tail is not None:
        group = stack.get("tail", {})
        layers += [group.get(f"l{li}") for li in range(len(tail))]
    return layers


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def params_from_numpy(tree: dict, cfg: ArchConfig, device=None,
                      dtype=None, biases=None, tp=None) -> LM:
    """The reference's parameter tree (numpy leaves) and router-bias tree
    (None: zeros, the reference's init) -> an ``LM`` on ``device`` (None:
    the card), every parameter in ``dtype`` (None: each keeps its leaf's,
    so a bf16 tree keeps RG-LRU's ``lam`` and the router f32). The biases
    stay f32. ``tp`` (a ``parallel/tp.py::Tp``): this model rank's part of
    each parameter the model axis cuts."""
    device = resolve_device(device)
    ported = {**tree, "stack": _unstack(tree["stack"], cfg)}
    flat = {k: _to_torch(v) for k, v in _flatten(ported).items()}
    if tp is not None:
        from repro_torch.training.state import param_dims
        dims = param_dims(LM(cfg, device="meta"))
        flat = {k: tp.own(v, dims[k]).clone() for k, v in flat.items()}
    flat = {k: v.to(device=device, dtype=dtype) for k, v in flat.items()}
    per_layer = _unstack(biases or {}, cfg)
    for i, (_, ffn) in enumerate(layer_plan(cfg)):
        if ffn == "moe":
            b = per_layer[i]
            b = torch.zeros(cfg.moe.n_experts_padded) if b is None else \
                _to_torch(b)
            flat[f"stack.{i}.moe.bias"] = b.to(device=device,
                                               dtype=torch.float32)
    lm = LM(cfg, device="meta")
    if tp is not None:
        tp.shard_module(lm)
    lm.load_state_dict(flat, strict=True, assign=True)
    return lm


def params_to_numpy(lm: LM, cfg: ArchConfig) -> dict:
    """An ``LM``'s (whole) parameters as the reference's nested parameter
    tree: a scan group's layers stacked, numpy arrays in each parameter's
    dtype (bf16 as ``ml_dtypes``' bfloat16)."""
    from repro_torch.models.model import reference_leaves
    named = dict(lm.named_parameters())
    tree: dict = {}
    for leaf in reference_leaves(cfg):
        ts = [named[n].detach().cpu() for n in leaf.names]
        t = torch.stack(ts) if leaf.stacked else ts[0]
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            a = t.float().numpy().astype(ml_dtypes.bfloat16)
        else:
            a = t.numpy().copy()
        *head, last = leaf.key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


def cache_from_numpy(tree: dict, cfg: ArchConfig, device=None) -> list:
    """The reference's decode cache tree -> the port's per-layer list of
    ``{"attn": {"k", "v"}}`` (MLA: ``{"ckv", "kr"}``; plus ``"cross":
    {"k", "v"}`` where the layer cross-attends), ``{"ssm": ...}`` or
    ``{"rec": ...}``, dtypes kept."""
    device = resolve_device(device)
    return [_map(lambda a: _to_torch(a).to(device), layer)
            for layer in _unstack(tree, cfg)]


def _by_key(tree, prefix="", is_leaf=lambda x: False) -> dict:
    """A nested dict -> ``{"a/b/c": leaf}`` (the reference's key paths)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        out = {}
        for k, v in tree.items():
            out.update(_by_key(v, f"{prefix}{k}/", is_leaf))
        return out
    return {prefix[:-1]: tree}


def tensors_by_name(tree: dict, cfg: ArchConfig, device) -> dict:
    """A tree shaped as the reference's parameters -> ``{parameter name:
    f32 tensor}``, its stacked leaves split by layer."""
    ported = {**tree, "stack": _unstack(tree["stack"], cfg)}
    return {k: _to_torch(v).to(device=device, dtype=torch.float32)
            for k, v in _flatten(ported).items()}


def state_from_numpy(state: dict, cfg: ArchConfig, device=None,
                     dtype=None) -> dict:
    """The reference's train state (numpy leaves: ``params``, ``biases``,
    ``opt``, ``step`` and ``ef`` where present) -> the port's
    (``training/state.py``'s layout) on ``device`` (None: the card), the
    parameters in ``dtype`` (None: each keeps its leaf's)."""
    from repro_torch.training.state import biases_of
    device = resolve_device(device)
    lm = params_from_numpy(state["params"], cfg, device=device, dtype=dtype,
                           biases=state.get("biases")).trainable(True)

    def buckets(xs):
        return [_to_torch(x).to(device=device, dtype=torch.float32)
                for x in xs]
    o = state["opt"]
    if "per" in o:
        per = _by_key(o["per"], is_leaf=lambda d: "vr" in d or "v" in d)
        opt = {"per": {k: {n: _to_torch(a).to(device=device,
                                               dtype=torch.float32)
                           for n, a in s.items()} for k, s in per.items()}}
    elif isinstance(o["m"], list):
        opt = {k: buckets(v) for k, v in o.items()}
    else:
        opt = {k: tensors_by_name(v, cfg, device) for k, v in o.items()}
    out = {"params": lm, "biases": biases_of(lm), "opt": opt,
           "step": torch.as_tensor(np.array(state["step"]),
                                   device=device).to(torch.int32)}
    if "ef" in state:
        ef = state["ef"]
        out["ef"] = (buckets(ef) if isinstance(ef, list)
                     else tensors_by_name(ef, cfg, device))
    return out
