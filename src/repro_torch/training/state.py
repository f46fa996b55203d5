"""Train state construction: concrete and abstract (the port of
``repro.training.state``).

A state is ``{"params", "biases", "opt", "step"}``, plus ``"ef"`` (the
error-feedback residuals) under ``compress_grads``:

- ``params``: the ``LM``, its parameters trainable;
- ``biases``: the MoE router biases, ``{"stack.<i>.moe.bias": [E_pad]}``,
  the LM's own buffers (the reference's separate biases tree; no
  gradient, updated by the step from the expert loads);
- ``opt``: the optimizer state. Bucketed AdamW/SGD keep f32 buckets in
  the reference's element order (``make_bucket_plan``); per-tensor
  AdamW/SGD one f32 tensor per parameter, by name; Adafactor one state per
  reference leaf, by its key, in the reference's *stacked* shapes
  (``stacked_params``);
- ``step``: an int32 scalar on the parameters' device;
- ``ef``: f32 buckets, or one f32 tensor per parameter, by name.

``abstract_state`` is the same tree on the ``meta`` device: shapes and
dtypes without storage (the reference's ``ShapeDtypeStruct`` tree, which
the dry run reads).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import buckets as bk
from repro_torch.models import model as mdl
from repro_torch.optim import optimizers as opt


def bucket_pad_multiple(mesh) -> int:
    """Ranks in the mesh (1 without one): buckets split evenly over them."""
    return 1 if mesh is None else int(mesh.mesh.numel())


def biases_of(lm) -> dict:
    """The LM's router-bias buffers by name."""
    return {n: b for n, b in lm.named_buffers() if n.endswith("moe.bias")}


def reference_groups(cfg: ArchConfig, lm) -> list:
    """``[(RefLeaf, (tensor, ...))]``: the LM's parameters grouped and
    ordered as the reference's parameter leaves."""
    named = dict(lm.named_parameters())
    return [(leaf, tuple(named[n] for n in leaf.names))
            for leaf in mdl.reference_leaves(cfg)]


def ordered_names(cfg: ArchConfig) -> list[str]:
    """The port's parameter names in the reference's flattened order."""
    return [n for leaf in mdl.reference_leaves(cfg) for n in leaf.names]


def stacked_params(cfg: ArchConfig, lm, tensors: dict | None = None) -> dict:
    """``{reference key: tensor}`` in the reference's shapes: a scan
    group's layers stacked on a new leading axis. ``tensors`` (by
    parameter name; the LM's parameters by default) may be gradients."""
    tensors = tensors or dict(lm.named_parameters())
    out = {}
    for leaf in mdl.reference_leaves(cfg):
        ts = [tensors[n] for n in leaf.names]
        out[leaf.key] = torch.stack(ts) if leaf.stacked else ts[0]
    return out


def make_bucket_plan(cfg: ArchConfig, rc: RunConfig, mesh=None,
                     lm=None) -> bk.BucketPlan | None:
    """The bucket plan of the bucketed optimizers (None for per-tensor
    updates and for Adafactor) over ``lm``'s parameters (a ``meta`` LM in
    the schema's dtypes by default). Byte counts use the parameters' own
    dtypes, as the reference's ``opt_init`` plans; its step plans from the
    schema's dtypes, the same plan for a model in those dtypes."""
    if not rc.bucketed_updates or cfg.optimizer == "adafactor":
        return None
    lm = lm if lm is not None else mdl.LM(cfg, device="meta")
    return bk.make_plan([ts for _, ts in reference_groups(cfg, lm)],
                        rc.bucket_bytes, bucket_pad_multiple(mesh))


def _opt_params(cfg: ArchConfig, rc: RunConfig, lm):
    """What ``opt_init`` takes for this config: the plan's leaves
    (bucketed), the parameters by name (per tensor), or zero-storage
    stand-ins of the stacked leaves (Adafactor: only shapes matter)."""
    if cfg.optimizer == "adafactor":
        return {leaf.key: torch.empty(((len(ts),) if leaf.stacked else ())
                                      + tuple(ts[0].shape), device="meta")
                for leaf, ts in reference_groups(cfg, lm)}
    if rc.bucketed_updates:
        return [ts for _, ts in reference_groups(cfg, lm)]
    return dict(lm.named_parameters())


def state_for(cfg: ArchConfig, rc: RunConfig, lm, mesh=None) -> dict:
    """A fresh state around ``lm`` (made trainable): zero moments, step 0,
    zero residuals, on ``lm``'s device."""
    lm.trainable(True)
    dev = next(lm.parameters()).device
    bucketed = rc.bucketed_updates and cfg.optimizer != "adafactor"
    o = opt.opt_init(cfg.optimizer, _opt_params(cfg, rc, lm),
                     bucketed=bucketed, bucket_bytes=rc.bucket_bytes,
                     pad_multiple=bucket_pad_multiple(mesh))
    if cfg.optimizer == "adafactor":
        o = {"per": {k: {n: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                         for n, t in s.items()}
                     for k, s in o["per"].items()}}
    state = {"params": lm, "biases": biases_of(lm), "opt": o,
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if rc.compress_grads:
        plan = make_bucket_plan(cfg, rc, mesh, lm)
        state["ef"] = (bk.zeros_like_buckets(plan, device=dev)
                       if plan is not None else
                       {n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in lm.named_parameters()})
    return state


def init_state(cfg: ArchConfig, rc: RunConfig, seed: int | None = None,
               mesh=None, *, device=None, dtype=None) -> dict:
    """A concrete state: the LM drawn from ``seed`` (``rc.seed`` by
    default) on ``device`` (None: the card), in ``dtype`` (None: the
    schema's)."""
    lm = mdl.init(cfg, rc.seed if seed is None else seed, device=device,
                  dtype=dtype)
    return state_for(cfg, rc, lm, mesh)


def abstract_state(cfg: ArchConfig, rc: RunConfig, mesh=None, *,
                   dtype=None) -> dict:
    """The state's tree on the ``meta`` device (no allocation)."""
    return state_for(cfg, rc, mdl.LM(cfg, device="meta", dtype=dtype), mesh)
