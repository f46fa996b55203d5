"""Train state construction: concrete and abstract (the port of
``repro.training.state``).

A state is ``{"params", "biases", "opt", "step", "layout"}``, plus ``"ef"``
(the error-feedback residuals) under ``compress_grads``:

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
- ``ef``: f32 buckets, or one f32 tensor per parameter, by name;
- ``layout``: a ``Layout``, what the tensors mean: the FSDP layout, the
  bucket plans (checkpoints read it, ``checkpoint_leaves``).

Under FSDP (``pod_param_mode`` "sharded" or "data" on more than one FSDP
rank, ``parallel/fsdp.py``) every tensor but the biases and the step is
this rank's shard: each parameter its rows (every rank draws the same full
weights from the seed, one parameter at a time, and keeps its rows), a
bucket its shards of the bucket's tensors (``core/buckets.py::
shard_plan``), a per-tensor moment or residual the parameter's shard, an
Adafactor state as ``optim/optimizers.py::FactoredLeaf`` lays it out. The
state is then a one-rank state cut up.

``abstract_state`` is the same tree on the ``meta`` device: shapes and
dtypes without storage (the reference's ``ShapeDtypeStruct`` tree, which
the dry run reads), this rank's shards under FSDP.

On a mesh with a ``model`` axis (``parallel/tp.py::Tp``) each tensor that
the axis cuts is this rank's part, then, under FSDP, its rows of that:
the heads of the attention weights, the hidden units of the dense FFNs,
the vocabulary rows of the embedding and head (tensor parallelism, where
every mixer is GQA attention whose heads the model ranks divide), and the
``E_pad / tp`` experts of each MoE tensor (``parallel/ep.py``). Every
other tensor (the norms, the router, KV projections whose heads the ranks
do not divide; every dense tensor of a MoE config that tensor
parallelism does not cover, such as MLA's) is laid out as on the data
axes alone and is a copy over ``model``. Buckets, moments, residuals and
Adafactor's states follow the parameters. A rank's slice equals the
one-rank state's slice for the same seed.

``checkpoint_leaves`` is the state as the reference's checkpoint leaves
(its key paths, stacked shapes, whole buckets without padding), gathered
from the shards (and the model ranks' experts) where the state is
sharded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import buckets as bk
from repro_torch.core.device import resolve_device
from repro_torch.models import model as mdl
from repro_torch.models.attention import unported
from repro_torch.models.transformer import plan_layers
from repro_torch.optim import optimizers as opt
from repro_torch.parallel.ep import Ep
from repro_torch.parallel.fsdp import Fsdp
from repro_torch.parallel.sharding import axis_sizes
from repro_torch.parallel.tp import Tp, uncovered


def explicit_sync(rc: RunConfig) -> bool:
    """Whether ``rc`` syncs the gradients by hand (the replicated mode's
    ``hierarchical_sync``/``compress_grads``)."""
    return (rc.pod_param_mode == "replicated" and
            (rc.hierarchical_sync or rc.compress_grads))


def check_mesh(cfg: ArchConfig, mesh, rc: RunConfig | None = None) -> None:
    """Raise for what a ``model`` axis larger than 1 does not run: a config
    without MoE layers whose mixers tensor parallelism does not cover
    (``parallel/tp.py::uncovered``: SSM and RG-LRU state, MLA's heads,
    heads the model ranks do not divide), experts that do not split over
    the model ranks. A MoE config that tensor parallelism does not cover
    runs its experts over ``model`` and the rest as copies."""
    tp = axis_sizes(mesh).get("model", 1)
    if tp <= 1:
        return
    left = uncovered(cfg, tp)
    if left is not None and cfg.moe is None:
        raise unported(f"tensor parallelism over the model axis ({tp} "
                       f"ranks) for {left}", 5)
    if cfg.moe is not None:
        Ep(mesh).check(cfg.moe.n_experts_padded)


def bucket_pad_multiple(mesh) -> int:
    """Ranks in the mesh (1 without one): buckets split evenly over them."""
    return math.prod(axis_sizes(mesh).values())


def biases_of(lm) -> dict:
    """The LM's router-bias buffers by name."""
    return {n: b for n, b in lm.named_buffers() if n.endswith("moe.bias")}


def param_shapes(lm) -> dict:
    """Each parameter's full (schema) shape by name, shards or not."""
    return {f"{mn}.{n}" if mn else n: m.shapes[n]
            for mn, m in lm.named_modules() for n in m._parameters}


def param_dims(lm) -> dict:
    """Each parameter's logical dimensions by name."""
    return {f"{mn}.{n}" if mn else n: m.dims[n]
            for mn, m in lm.named_modules() for n in m._parameters}


def local_shapes(lm, tp) -> dict:
    """Each parameter's shape on this model rank of ``tp`` (a
    ``parallel/tp.py::Tp``; the full one where ``tp`` is None), before any
    FSDP cut."""
    shapes = param_shapes(lm)
    if tp is None:
        return shapes
    dims = param_dims(lm)
    return {n: tp.local_shape(s, dims[n]) for n, s in shapes.items()}


def _full_meta(lm) -> dict:
    """Zero-storage tensors of the parameters' full shapes and dtypes."""
    shapes = param_shapes(lm)
    return {n: torch.empty(shapes[n], dtype=p.dtype, device="meta")
            for n, p in lm.named_parameters()}


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
    updates and for Adafactor) over ``lm``'s parameters at their full
    shapes (a ``meta`` LM in the schema's dtypes by default). Byte counts
    use the parameters' own dtypes, as the reference's ``opt_init`` plans;
    its step plans from the schema's dtypes, the same plan for a model in
    those dtypes."""
    if not rc.bucketed_updates or cfg.optimizer == "adafactor":
        return None
    lm = lm if lm is not None else mdl.LM(cfg, device="meta")
    meta = _full_meta(lm)
    return bk.make_plan([tuple(meta[n] for n in leaf.names)
                         for leaf in mdl.reference_leaves(cfg)],
                        rc.bucket_bytes, bucket_pad_multiple(mesh))


@dataclasses.dataclass
class Layout:
    """What a state's tensors are: ``fsdp`` (a ``parallel/fsdp.py::Fsdp``,
    or None: whole tensors), ``tp`` (a ``parallel/tp.py::Tp``, or None:
    nothing cut over ``model``), ``plan`` (the bucket plan at full shapes,
    or None), ``splan`` (this rank's ``bk.shard_plan`` under FSDP or a
    model axis: its tensors' parts, each in its bucket of ``plan``),
    ``factored`` (Adafactor's ``FactoredLeaf`` by reference key under
    FSDP) and ``rms_over`` (Adafactor without FSDP: by reference key of a
    leaf the model axis cuts, ``(tp, the factored dimension cut)``);
    ``copies``: on a model axis without FSDP, each bucket's elements of
    the tensors that are copies over ``model`` (they lead the bucket)."""
    cfg: ArchConfig
    fsdp: Fsdp | None
    plan: bk.BucketPlan | None
    splan: bk.BucketPlan | None = None
    factored: dict | None = None
    tp: Tp | None = None
    mesh: object = None
    rms_over: dict | None = None
    copies: tuple | None = None


def factored_cut(shape, axis) -> int:
    """Which of Adafactor's factored dimensions (the last two) the model
    axis cuts in a tensor of ``shape`` at ``axis``: -1, -2, or 0 for
    another (or none)."""
    if axis is None:
        return 0
    d = axis - len(shape)
    return d if len(shape) >= 2 and d in (-1, -2) else 0


def make_layout(cfg: ArchConfig, rc: RunConfig, mesh, lm) -> Layout:
    """The layout of ``rc``'s state on ``mesh`` for ``lm``'s dtypes."""
    tp = Tp.of(mesh, cfg)
    fs = Fsdp.of(mesh, rc.pod_param_mode, tp)
    plan = make_bucket_plan(cfg, rc, mesh, lm)
    if fs is None and tp is None:
        return Layout(cfg, None, plan)
    shapes = local_shapes(lm, tp)
    full = param_shapes(lm)
    part = (lambda n: fs.spec(shapes[n]).numel) if fs else \
        (lambda n: shapes[n])
    names = ordered_names(cfg)
    # without FSDP the copies over ``model`` lead each bucket (the
    # explicit sync compresses them apart from the cut parts)
    front = [shapes[n] == full[n] for n in names] if fs is None else None
    splan = plan and bk.shard_plan(plan, [part(n) for n in names], front)
    dims = param_dims(lm)

    def model(leaf):
        """(``tp``, the factored dimension cut) where the model axis cuts
        the leaf, else (None, 0)."""
        n = leaf.names[0]
        ax = tp.cut_axis(full[n], dims[n]) if tp is not None else None
        if ax is None:
            return None, 0
        return tp, factored_cut(full[n], ax)

    factored = rms_over = None
    if cfg.optimizer == "adafactor" and fs is not None:
        factored = {leaf.key: opt.FactoredLeaf(
            len(leaf.names), tuple(shapes[leaf.names[0]]), leaf.stacked, fs,
            *model(leaf)) for leaf in mdl.reference_leaves(cfg)}
    elif cfg.optimizer == "adafactor":
        rms_over = {leaf.key: model(leaf)
                    for leaf in mdl.reference_leaves(cfg)
                    if model(leaf)[0] is not None}
    copies = splan and front and tuple(bk.front_sizes(splan, front))
    return Layout(cfg, fs, plan, splan, factored, tp, mesh, rms_over,
                  copies)


def is_sharded(lm) -> bool:
    """Whether ``lm`` holds FSDP shards or a model rank's parts (any
    parameter not of its full shape)."""
    shapes = param_shapes(lm)
    return any(tuple(p.shape) != tuple(shapes[n])
               for n, p in lm.named_parameters())


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
    zero residuals, on ``lm``'s device. Under FSDP on ``mesh`` ``lm``
    holds this rank's shards (``Fsdp.shard_module``) and so does the
    state; on a ``model`` axis it holds this rank's parts
    (``Tp.shard_module``)."""
    check_mesh(cfg, mesh, rc)
    lay = make_layout(cfg, rc, mesh, lm)
    fs = lay.fsdp
    if (fs is not None or lay.tp is not None) and not is_sharded(lm):
        raise ValueError("this mesh needs an LM of shards: build the state "
                         "with init_state(..., mesh)")
    lm.trainable(True)
    dev = next(lm.parameters()).device
    bucketed = rc.bucketed_updates and cfg.optimizer != "adafactor"
    if fs is not None and cfg.optimizer == "adafactor":
        o = {"per": {k: f.init(dev) for k, f in lay.factored.items()}}
    else:
        o = opt.opt_init(cfg.optimizer, _opt_params(cfg, rc, lm),
                         bucketed=bucketed, bucket_bytes=rc.bucket_bytes,
                         pad_multiple=bucket_pad_multiple(mesh),
                         plan=lay.splan or lay.plan)
    if cfg.optimizer == "adafactor" and fs is None:
        o = {"per": {k: {n: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                         for n, t in s.items()}
                     for k, s in o["per"].items()}}
    state = {"params": lm, "biases": biases_of(lm), "opt": o,
             "step": torch.zeros((), dtype=torch.int32, device=dev),
             "layout": lay}
    if rc.compress_grads:
        plan = lay.splan or lay.plan
        state["ef"] = (bk.zeros_like_buckets(plan, device=dev)
                       if plan is not None else
                       {n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in lm.named_parameters()})
    return state


def init_state(cfg: ArchConfig, rc: RunConfig, seed: int | None = None,
               mesh=None, *, device=None, dtype=None) -> dict:
    """A concrete state: the LM drawn from ``seed`` (``rc.seed`` by
    default) on ``device`` (None: the card; this rank's card under a
    mesh), in ``dtype`` (None: the schema's). Under FSDP, or on a
    ``model`` axis, each parameter is drawn whole and cut to this rank's
    part and rows at once, so a rank never holds more than one whole
    parameter beyond its own."""
    check_mesh(cfg, mesh, rc)
    seed = rc.seed if seed is None else seed
    tp = Tp.of(mesh, cfg)
    fs = Fsdp.of(mesh, rc.pod_param_mode, tp)
    if fs is None and tp is None:
        lm = mdl.init(cfg, seed, device=device, dtype=dtype)
        return state_for(cfg, rc, lm, mesh)
    lm = mdl.init(cfg, seed, device=resolve_device(device, mesh),
                  dtype=dtype, part=fs or tp)
    return state_for(cfg, rc, lm, mesh)


def abstract_state(cfg: ArchConfig, rc: RunConfig, mesh=None, *,
                   dtype=None) -> dict:
    """The state's tree on the ``meta`` device (no allocation); under FSDP
    this rank's shard shapes, on a ``model`` axis its parts (``mesh`` may
    be a stand-in that answers ``mesh_dim_names`` and ``size``)."""
    check_mesh(cfg, mesh, rc)
    lm = mdl.LM(cfg, device="meta", dtype=dtype)
    tp = Tp.of(mesh, cfg)
    fs = Fsdp.of(mesh, rc.pod_param_mode, tp)
    if fs is not None or tp is not None:
        (fs or tp).shard_module(lm)
    return state_for(cfg, rc, lm, mesh)


# ---------------------------------------------------------------------------
# The reference's checkpoint leaves
# ---------------------------------------------------------------------------

class Leaf(NamedTuple):
    """One checkpoint leaf: its full ``shape``, ``get()`` -> the whole
    tensor (a collective under FSDP: every rank calls the leaves' ``get``
    in key order), ``put(x)`` fills the state from the whole tensor."""
    shape: tuple
    get: Callable[[], torch.Tensor]
    put: Callable[[torch.Tensor], None]


def _bias_groups(cfg: ArchConfig) -> list:
    """``[(reference biases key, port bias names, stacked)]``."""
    groups, tail = plan_layers(cfg)
    out, first = [], 0
    for gi, (sig, cnt) in enumerate(groups):
        u = len(sig)
        for li, (_, ffn) in enumerate(sig):
            if ffn == "moe":
                out.append((f"g{gi}/l{li}",
                            [f"stack.{first + j * u + li}.moe.bias"
                             for j in range(cnt)], True))
        first += u * cnt
    for li, (_, ffn) in enumerate(tail or ()):
        if ffn == "moe":
            out.append((f"tail/l{li}", [f"stack.{first + li}.moe.bias"],
                        False))
    return out


def checkpoint_leaves(state: dict) -> dict:
    """``{reference key: Leaf}`` of a train state, sorted by key: the
    parameters, per-tensor moments and residuals as the reference's
    stacked leaves (``params/stack/g0/l0/attn/w_q``), the router biases as
    its biases tree, buckets whole in its element order without padding
    (``opt/m/0``), Adafactor's states in its shapes, the step. Tensors
    the model axis cuts are gathered over the model ranks too (the FSDP
    ranks of each model coordinate first)."""
    lm = state["params"]
    cfg = lm.cfg
    lay = state.get("layout") or make_layout(cfg, RunConfig(), None, lm)
    fs, tp = lay.fsdp, lay.tp
    shapes = param_shapes(lm)
    dims = param_dims(lm)
    local = local_shapes(lm, tp)
    out: dict = {}

    def whole(t, n):
        """Parameter ``n``'s whole tensor from this rank's ``t`` (its
        shard under FSDP, else its local tensor)."""
        t = fs.full(t.detach(), local[n]) if fs else t.detach()
        return tp.whole(t, dims[n], shapes[n]) if tp else t

    def mine(x, n):
        """This rank's part of parameter ``n``'s whole ``x``."""
        if tp:
            x = tp.own(x, dims[n])
        return fs.shard(x) if fs else x

    @torch.no_grad()
    def fill(t, x, n):
        t.copy_(mine(x, n))

    def by_leaf(prefix, tensors):
        for leaf in mdl.reference_leaves(cfg):
            ts = [tensors[n] for n in leaf.names]
            s = tuple(shapes[leaf.names[0]])

            def get(ts=ts, names=leaf.names, stacked=leaf.stacked):
                fulls = [whole(t, n) for t, n in zip(ts, names)]
                return torch.stack(fulls) if stacked else fulls[0]

            def put(x, ts=ts, names=leaf.names, stacked=leaf.stacked):
                for t, n, part in zip(ts, names,
                                      x.unbind(0) if stacked else [x]):
                    fill(t, part, n)

            out[f"{prefix}/{leaf.key}"] = Leaf(
                ((len(ts),) if leaf.stacked else ()) + s, get, put)

    names = ordered_names(cfg)

    def bucket_parts(bi):
        """(name, offset and size in the whole bucket, offset and size in
        this rank's) of bucket ``bi``'s tensors."""
        return [(names[j], off, n, soff, k) for j, ((b, off), n, (_, soff), k)
                in enumerate(zip(lay.plan.assign, lay.plan.sizes,
                                 lay.splan.assign, lay.splan.sizes))
                if b == bi]

    def buckets(prefix, bs):
        real = bk.real_sizes(lay.plan)
        for bi, b in enumerate(bs):
            def get(bi=bi, b=b):
                if fs is None and tp is None:
                    return b[:real[bi]]
                if tp is None:
                    return bk.unshard_bucket(
                        lay.plan, lay.splan, bi,
                        fs.gather_last(b).view(fs.ranks, -1))
                parts = []
                for n, off, _, soff, k in bucket_parts(bi):
                    piece = b[soff:soff + k]
                    parts.append(whole(piece if fs else
                                       piece.view(local[n]), n).reshape(-1))
                return torch.cat(parts)

            @torch.no_grad()
            def put(x, bi=bi, b=b):
                if fs is None and tp is None:
                    b.zero_()
                    b[:real[bi]].copy_(x)
                elif tp is None:
                    b.copy_(bk.shard_bucket(lay.plan, lay.splan, bi, x,
                                            fs.index))
                else:
                    for n, off, size, soff, k in bucket_parts(bi):
                        b[soff:soff + k].copy_(mine(
                            x[off:off + size].view(shapes[n]), n).reshape(-1))

            out[f"{prefix}/{bi}"] = Leaf((real[bi],), get, put)

    def moments(prefix, tree):
        if isinstance(tree, list):
            buckets(prefix, tree)
        else:
            by_leaf(prefix, tree)

    by_leaf("params", dict(lm.named_parameters()))
    biases = state["biases"]
    for key, bnames, stacked in _bias_groups(cfg):
        bs = [biases[n] for n in bnames]

        def get_b(bs=bs, stacked=stacked):
            return torch.stack(bs) if stacked else bs[0]

        @torch.no_grad()
        def put_b(x, bs=bs, stacked=stacked):
            for b, part in zip(bs, x.unbind(0) if stacked else [x]):
                b.copy_(part)

        out[f"biases/{key}"] = Leaf(
            ((len(bs),) if stacked else ()) + tuple(bs[0].shape), get_b,
            put_b)
    o = state["opt"]
    if "per" in o:
        leaves = {leaf.key: leaf for leaf in mdl.reference_leaves(cfg)}
        for key, st in o["per"].items():
            f = (lay.factored or {}).get(key)
            leaf = leaves[key]
            p0 = leaf.names[0]
            for n, t in st.items():
                # the axis of state n (in the reference's shape) that the
                # model axis cuts, or None: a mean over the cut dimension
                # is a copy on every model rank
                ax = _state_cut(n, shapes[p0], tp.cut_axis(
                    shapes[p0], dims[p0]) if tp else None, leaf.stacked)

                def get_f(t=t, f=f, n=n, ax=ax):
                    x = f.full(n, t) if f else t
                    return tp.whole_at(x, ax) if ax is not None else x

                @torch.no_grad()
                def put_f(x, t=t, f=f, n=n, ax=ax):
                    if ax is not None:
                        x = tp.own_at(x, ax)
                    t.copy_(f.shard(n, x) if f else x)

                shape = list(_factored_shape(f, n, t))
                if ax is not None:
                    shape[ax] *= tp.tp
                out[f"opt/per/{key}/{n}"] = Leaf(tuple(shape), get_f, put_f)
    else:
        for mk, tree in o.items():
            moments(f"opt/{mk}", tree)
    step = state["step"]

    @torch.no_grad()
    def put_step(x):
        step.copy_(x)

    out["step"] = Leaf((), lambda: step, put_step)
    if "ef" in state:
        moments("ef", state["ef"])
    return dict(sorted(out.items()))


def _state_cut(name: str, shape, axis, stacked: bool):
    """The axis of Adafactor's state ``name`` (``vr``: the parameter's
    shape without its last dimension; ``vc``: without its second last;
    ``v``: the shape; a stacked leaf's state has the layer axis first)
    that holds the model axis's cut at ``axis`` of the parameter, or None
    (no cut, or the state is a mean over the cut dimension)."""
    if axis is None:
        return None
    k = len(shape)
    if k >= 2 and ((name == "vr" and axis == k - 1)
                   or (name == "vc" and axis == k - 2)):
        return None
    if name == "vc" and k >= 2 and axis == k - 1:
        axis = k - 2
    return axis + (1 if stacked else 0)


def _factored_shape(f, name: str, t) -> tuple:
    """The reference's shape of Adafactor state ``name`` (``t`` this rank's,
    whole without FSDP)."""
    if f is None:
        return tuple(t.shape)
    L, s = f.layers, f.shape
    lead = (L,) if f.stacked else ()
    if f.kind == "rows":
        return lead + (s[:-1] if name == "vr" else s[:-2] + s[-1:])
    if f.kind == "layers":
        return (L,) if name == "vr" else s
    return lead + s
