"""Train step builder (the port of ``repro.training.step``).

Two distribution regimes, as in the reference:

- ``pod_param_mode in ("sharded", "data")``: the production path, FSDP
  (ZeRO-3) over the data axes (``pod`` and ``data``, or ``data`` alone
  with the pods as replicas). On one device (no mesh, or one FSDP rank)
  that is the plain step: gradients, the optimizer (bucketed AdamW by
  default), the router-bias update. On more ranks the state holds this
  rank's shards (``training/state.py``): the forward gathers each unit's
  weights as it runs it and the backward reduce-scatters their gradients
  (``parallel/fsdp.py``), so the step gets this rank's shard of the
  gradients' sum over the data-parallel ranks, divides it by their number
  once, takes the gradient norm from an all-reduced sum of squares (the
  padding adds zeros), and runs the optimizer on the shards (Adafactor's
  means all-reduced, ``optim/optimizers.py``). The expert loads are summed
  over the data-parallel ranks before the router-bias update and the
  metrics averaged, as in the replicated step. ``compress_grads`` builds
  ``ef``, which this path carries unchanged, as the reference's GSPMD
  step does. What it computes is the reference's GSPMD step on the same
  mesh: each rank's MoE layers chunk that rank's tokens, as the
  reference's do.

- ``pod_param_mode == "replicated"``: pure data parallelism (the
  paper-faithful Hadoop-shaped baseline: every rank holds the whole model,
  gradients are the shuffle). With ``hierarchical_sync``/``compress_grads``
  the gradient all-reduce is explicit: each rank's gradients are flattened
  into the optimizer's buckets, compressed with error feedback
  (``ef_compress``, residuals carried in ``state["ef"]``) under
  ``compress_grads``, and summed over the data axes
  (``hierarchical_psum_1d``, int8 on the cross-pod phase under
  ``compress_grads``; ``compressed_psum_1d`` or a plain all-reduce without
  ``hierarchical_sync``), then divided by the data-parallel size. The
  expert loads are summed before the router-bias update, and the metrics
  averaged. Without either knob, the gradients are all-reduced tensor by
  tensor.

The step is SPMD over a ``launch/mesh.py`` mesh: every rank calls it with
the whole global batch and takes its rows (``parallel/sharding.py::
batch_spec``). On a mesh whose ``model`` axis is larger than 1 each tensor
that the axis cuts is this rank's part (``parallel/tp.py``): the GQA
transformer runs tensor parallel (each rank its heads, hidden units and
vocabulary rows, the blocks' all-reduces explicit, the vocab-parallel
loss), and a MoE layer's experts are split over the model ranks, the
tokens dispatched by all-to-all (``parallel/ep.py``); a MoE config whose
mixers tensor parallelism does not cover (MLA) keeps its dense layers as
copies over ``model``. Every model rank computes the same loss, and the
gradient of a tensor that is a copy over ``model`` is whole and the same
on each. The data-parallel machinery above runs unchanged within each
model coordinate: FSDP over the data ranks of this rank's model
coordinate, and the explicit sync sums each bucket of this rank's plan
(its parts of the cut tensors, the copies whole; ``ef`` laid out on that
plan) over the data axes only. The gradient norm adds the cut tensors'
squares over ``model`` and counts the copies once, the loads arrive
summed over ``model`` from the layers, and the metrics are averaged over
the data axes only. With
``donate_state`` (the direct-I/O analogue) the state is updated in place:
the LM's parameters (or shards) and biases in their storage, the moments
too, the step counter incremented; without it the step returns a new
state (a new ``LM``) and leaves its argument as it was.

Gradients come from ``torch.autograd.grad`` over the parameters (or their
shards) in the reference's leaf order. Micro-batches (``rc.microbatch``)
accumulate in the parameters' dtype and are divided by their number, as
the reference does; under FSDP each micro-batch's gradients are
reduce-scattered and the shards accumulated.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import buckets as bk
from repro_torch.core.collectives import hierarchical_psum_1d
from repro_torch.core.compression import (all_reduce, axis_group,
                                          compressed_psum_1d, ef_compress,
                                          psum_1d)
from repro_torch.models import model as mdl
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import schema_leaves
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel.ep import Ep
from repro_torch.parallel.fsdp import Fsdp
from repro_torch.parallel.tp import Tp
from repro_torch.parallel.sharding import (batch_axes, batch_size,
                                           batch_spec, make_rules)
from repro_torch.training import state as st


def _opt_kind(cfg: ArchConfig, rc: RunConfig) -> str:
    if cfg.optimizer == "adafactor":
        return "adafactor"
    b = rc.bucketed_updates
    return {"adamw": "adamw_b" if b else "adamw",
            "sgdm": "sgdm_b" if b else "sgdm"}[cfg.optimizer]


def _update_biases(cfg: ArchConfig, biases: dict, aux: list) -> dict:
    """Aux-loss-free router-bias update from each MoE layer's observed
    load (DeepSeek's sigmoid router only). -> the new biases by name."""
    if cfg.moe is None or cfg.moe.router != "sigmoid_bias" or not biases:
        return biases
    new = dict(biases)
    for i, a in enumerate(aux):
        name = f"stack.{i}.moe.bias"
        if "load" in a and name in biases:
            new[name] = moe_mod.update_router_bias(cfg.moe, biases[name],
                                                   a["load"])
    return new


def _to_batch(batch: dict, rows: slice, device) -> dict:
    """This rank's rows of the batch, as tensors on ``device`` (``cond``
    and ``prefix`` in bf16, as the reference's inputs)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v[rows], device=device)
        out[k] = t if k == "tokens" else t.to(torch.bfloat16)
    return out


def make_train_step(cfg: ArchConfig, rc: RunConfig, mesh=None):
    """-> ``step_fn(state, batch) -> (state, metrics)``. ``batch``: the
    global batch, ``{"tokens": [B, S]}`` and ``cond``/``prefix`` where the
    config reads them (numpy or tensors); metrics are f32 scalars on the
    device: ``ce_loss``, ``moe_aux_loss``, ``mtp_loss`` where present,
    ``loss`` and ``grad_norm``."""
    make_rules(mesh, pod_param_mode=rc.pod_param_mode)    # validates the mode
    st.check_mesh(cfg, mesh, rc)
    kind = _opt_kind(cfg, rc)
    dp_axes = batch_axes(mesh)
    dp = batch_size(mesh)
    tp = Tp.of(mesh, cfg)
    fs = Fsdp.of(mesh, rc.pod_param_mode, tp)
    ep = Ep.of(mesh)
    explicit = st.explicit_sync(rc)
    if explicit and (not rc.bucketed_updates or cfg.optimizer == "adafactor"):
        raise ValueError("explicit sync requires bucketed_updates (and a "
                         "non-adafactor optimizer)")
    inner = "data" if "data" in dp_axes else None
    outer = "pod" if "pod" in dp_axes else None
    codec = "int8" if rc.compress_grads else "none"
    names = st.ordered_names(cfg)
    layouts: dict = {}
    leaves = schema_leaves(mdl.model_schema(cfg))
    # by name in ``names``: whether the tensor is cut over ``model``
    cut = [tp is not None and tp.cut_axis(leaves[n].shape,
                                          leaves[n].dims) is not None
           for n in names]

    def layout_for(lm) -> st.Layout:
        key = tuple((tuple(p.shape), p.dtype) for p in lm.parameters())
        if key not in layouts:
            if (fs is not None or tp is not None) and not st.is_sharded(lm):
                raise ValueError("this mesh needs an LM of shards: build "
                                 "the state with init_state(..., mesh)")
            layouts[key] = st.make_layout(cfg, rc, mesh, lm)
        return layouts[key]

    def sq_norm(grads) -> torch.Tensor:
        """The gradients' (or, without a model axis, buckets') sum of
        squares in f32; on a model axis the copies' counted once plus,
        summed over the model ranks, the cut tensors' parts."""
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        zero = torch.zeros((), device=sq[0].device)
        if tp is None:
            return sum(sq, zero)
        whole = sum((q for q, c in zip(sq, cut, strict=True) if not c),
                    zero)
        local = sum((q for q, c in zip(sq, cut) if c), zero)
        return whole + all_reduce(local.reshape(1), tp.group)[0]

    def psum(x):
        return psum_1d(x, dp_axes, mesh=mesh) if dp > 1 else x

    # ------------------------------------------------------------------
    def value_and_grad(lm, params, mb):
        loss, (mets, aux) = mdl.loss_fn(cfg, rc, lm, mb, fsdp=fs, ep=ep,
                                        tp=tp)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if fs is not None:      # the backward's reduce-scatters summed them
            grads = [g / dp for g in grads]
        return ({k: v.detach() for k, v in mets.items()},
                [{k: v.detach() for k, v in a.items()} for a in aux], grads)

    def grads_and_metrics(lm, params, batch):
        n = rc.microbatch
        if not (n and n > 1):
            mets, aux, g = value_and_grad(lm, params, batch)
            return g, mets, aux
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} microbatches")
        m = B // n
        # accumulate in the param dtype (bf16), as the reference does
        acc = [torch.zeros_like(p) for p in params]
        all_mets, aux = [], None
        for i in range(n):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            mets, a, g = value_and_grad(lm, params, mb)
            acc = [x + y.to(x.dtype) for x, y in zip(acc, g)]
            del g
            all_mets.append(mets)
            aux = a if aux is None else [
                {k: v + a[j][k] for k, v in layer.items()}
                for j, layer in enumerate(aux)]
        grads = [x / n for x in acc]
        mets = {k: torch.stack([d[k] for d in all_mets]).mean(0)
                for k in all_mets[0]}
        return grads, mets, aux

    # ------------------------------------------------------------------
    def optimizer_stage(state, grads, lay, *, grads_are_buckets=False):
        """-> (new parameters by name, new optimizer state)."""
        lm, step = state["params"], state["step"]
        lr = warmup_cosine(step, base_lr=rc.learning_rate,
                           warmup=rc.warmup_steps, total=rc.steps)
        named = {n: p.detach() for n, p in lm.named_parameters()}
        kw = dict(lr=lr, wd=rc.weight_decay, step=step,
                  inplace=rc.donate_state)
        plan = lay.splan or lay.plan
        if kind == "adafactor" and lay.fsdp is not None:
            g = dict(zip(names, grads))
            new, per = {}, {}
            for leaf in mdl.reference_leaves(cfg):
                p = torch.stack([named[n] for n in leaf.names])
                u, per[leaf.key] = opt.adafactor_shard_update(
                    torch.stack([g[n] for n in leaf.names]),
                    state["opt"]["per"][leaf.key], p,
                    lay.factored[leaf.key], lr=lr, wd=rc.weight_decay,
                    step=step.float() + 1.0)
                new.update(zip(leaf.names,
                               (p.float() + u).to(p.dtype).unbind(0)))
            return new, {"per": per}
        if plan is not None:
            params = [named[n] for n in names]
            upd, new_opt = opt.opt_update(
                kind, state["opt"], grads, params, plan=plan,
                grads_are_buckets=grads_are_buckets, **kw)
            new = opt.apply_updates(params, upd, plan=plan)
            return dict(zip(names, new)), new_opt
        g = dict(zip(names, grads))
        if kind == "adafactor":
            sp, sg = st.stacked_params(cfg, lm, named), \
                st.stacked_params(cfg, lm, g)
            upd, new_opt = opt.opt_update(kind, state["opt"], sg, sp,
                                          rms_over=lay.rms_over, **kw)
            stacked = opt.apply_updates(sp, upd)
            new = {}
            for leaf in mdl.reference_leaves(cfg):
                parts = (stacked[leaf.key].unbind(0) if leaf.stacked
                         else (stacked[leaf.key],))
                new.update(zip(leaf.names, parts))
            return new, new_opt
        params = {n: named[n] for n in names}
        upd, new_opt = opt.opt_update(kind, state["opt"], g, params, **kw)
        return opt.apply_updates(params, upd), new_opt

    # ------------------------------------------------------------------
    def global_loads(aux):
        """Expert loads are per data rank (each MoE layer has summed them
        over ``model``): globalize them so the router-bias update stays
        replica-consistent."""
        if dp == 1:
            return aux
        return [{k: (psum(v) if k == "load" else v) for k, v in a.items()}
                for a in aux]

    def sync(state, grads, aux, lay):
        """The explicit (or per-tensor) data-parallel sync over the data
        axes (within this rank's model coordinate, on this rank's bucket
        plan; on a model axis each bucket's copies and cut parts as two
        vectors, ``Layout.copies``). -> (grads or buckets, aux, new
        residuals or None, whether buckets)."""
        aux = global_loads(aux)
        if not explicit:
            grads = [psum(g.reshape(-1)).view(g.shape) / dp for g in grads] \
                if dp > 1 else grads
            return grads, aux, None, False
        gb = bk.flatten(lay.splan or lay.plan, grads)
        del grads
        ef = state.get("ef")
        new_ef, synced = [], []
        for i, g in enumerate(gb):
            n = g.numel()
            parts = [k for k in ([n] if lay.copies is None else
                                 [lay.copies[i], n - lay.copies[i]]) if k]
            efs = ef[i].split(parts) if ef else [None] * len(parts)
            outs, es = [], []
            for r, e in zip(g.split(parts), efs):
                if rc.compress_grads:
                    r, e = ef_compress(r, e)
                    es.append(e)
                if dp > 1:
                    if rc.hierarchical_sync:
                        r = hierarchical_psum_1d(r, inner, outer,
                                                 codec=codec, mesh=mesh)
                    elif rc.compress_grads:
                        r = compressed_psum_1d(r, dp_axes, mesh=mesh)
                    else:
                        r = psum(r)
                outs.append(r)
            if rc.compress_grads:
                new_ef.append(es[0] if len(es) == 1 else torch.cat(es))
            synced.append((outs[0] if len(outs) == 1 else torch.cat(outs))
                          / float(dp))
        return synced, aux, (new_ef if rc.compress_grads else None), True

    def pmean(mets):
        if dp == 1:
            return mets
        group = axis_group(dp_axes, mesh=mesh)
        keys = sorted(mets)
        v = all_reduce(torch.stack([mets[k].float() for k in keys]), group)
        return {k: v[i] / dp for i, k in enumerate(keys)}

    # ------------------------------------------------------------------
    def step_fn(state, batch):
        lm = state["params"]
        dev = state["step"].device
        lay = layout_for(lm)
        rows = batch_spec(len(batch["tokens"]), mesh)
        named = dict(lm.named_parameters())
        params = [named[n] for n in names]
        grads, mets, aux = grads_and_metrics(lm, params,
                                             _to_batch(batch, rows, dev))
        mets = dict(mets)
        new_ef, buckets = None, False
        with torch.no_grad():
            if fs is not None:
                aux = global_loads(aux)
                mets["grad_norm"] = torch.sqrt(
                    all_reduce(sq_norm(grads).reshape(1), fs.group)[0])
            else:
                if explicit or dp > 1:
                    grads, aux, new_ef, buckets = sync(state, grads, aux,
                                                       lay)
                mets["grad_norm"] = torch.sqrt(sq_norm(
                    bk.unflatten(lay.splan, grads)
                    if buckets and tp is not None else grads))
            mets = pmean(mets)
            new_params, new_opt = optimizer_stage(
                state, grads, lay, grads_are_buckets=buckets)
            del grads
            biases = _update_biases(cfg, state["biases"], aux)
            if rc.donate_state:
                for n, p in named.items():
                    p.copy_(new_params[n])
                for n, b in state["biases"].items():
                    if biases[n] is not b:
                        b.copy_(biases[n])
                state["opt"] = new_opt
                state["step"].add_(1)
                if new_ef is not None:
                    state["ef"] = new_ef
                return state, mets
            new_lm = mdl.LM(cfg, device="meta")
            if fs is not None or tp is not None:
                (fs or tp).shard_module(new_lm)
            new_lm.load_state_dict({**new_params, **biases}, strict=True,
                                   assign=True)
            new_lm.trainable(True)
            new_state = dict(state)
            new_state.update(params=new_lm, biases=st.biases_of(new_lm),
                             opt=new_opt, step=state["step"] + 1)
            if new_ef is not None:
                new_state["ef"] = new_ef
            return new_state, mets

    return step_fn
