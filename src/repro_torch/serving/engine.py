"""Serving: prefill/decode steps + a slot-based continuous-batching engine
(the JAX package's ``serving/engine.py``).

The steps run under ``torch.inference_mode``. The decode step writes the new
keys and values into its cache in place, as the reference's jitted step
donates its cache buffer. On the card, prefill's attention is the flash
kernel (MLA's the chunked formula); decode's is the plain masked formula
(``models/attention.py``). The parameters are the ``LM`` module, so a MoE
layer's router bias (a buffer) travels with them. A prefill batch may carry
``cond`` and ``prefix`` beside ``tokens``; ``ServeEngine`` runs no prefill
(as the reference's), so a cross-attention cache stays its zeros there.

On a mesh (``mesh=``, as the reference's steps take one; SPMD: every rank
calls with the same arguments) the weights take the reference's serving
layout, ``make_rules(mesh, pod_param_mode=rc.pod_param_mode)``:

- the model axis runs tensor parallel (``parallel/tp.py``: each rank its
  heads, KV heads, SSM heads or RG-LRU channels, hidden units and
  vocabulary rows, and a MoE layer's experts over ``parallel/ep.py``);
- under "sharded" (the default, as the reference's ``RunConfig`` and serve
  CLI) each tensor of that part is cut into FSDP row shards over pod x
  data, under "data" over ``data`` alone (``parallel/fsdp.py``, as the
  train state is); the steps gather the embedding, head and final norm
  once a call and each unit's weights just before it runs, decode every
  step, as the reference's GSPMD step does; "replicated" keeps the part
  whole over the data axes. The router biases stay whole buffers.

The slots go over the data axes where those divide them
(``parallel/sharding.py::rank_rows``; else every data rank runs every
slot). Each rank's cache holds its slots and its part of every layer's
cache: the KV heads, the head dim or the positions that the model axis
cuts (``models/attention.py::cache_cut``), MLA's ``kv_lora / tp`` of the
latent, its SSM heads or RG-LRU channels. The steps return the whole
logits of every slot on every rank (gathered over ``model``, then over the
data axes), so every rank of the engine takes the same greedy tokens and
runs the same schedule. The steps take ``params`` in the layout of
``rc.pod_param_mode`` alone (``mdl.init(..., part=rank_part(cfg, mesh,
rc))``, ``convert.params_from_numpy(..., tp=, fsdp=)``) and raise on
another; a caller that holds this rank's model part whole over the data
axes passes ``RunConfig(pod_param_mode="replicated")``. ``ServeEngine``
takes the layout, a whole ``LM`` or that whole model part, and cuts it
into the layout. Every mixer
runs on a model axis (``models/attention.py``, ``models/rglru.py``,
``models/ssm.py``); a config whose experts do not split over it raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.compression import all_gather, axis_group
from repro_torch.core.device import resolve_device
from repro_torch.models import model as mdl
from repro_torch.parallel.ep import Ep
from repro_torch.parallel.fsdp import Fsdp
from repro_torch.parallel.sharding import (axis_sizes, batch_axes,
                                           batch_size, rank_rows)
from repro_torch.parallel.tp import Tp, uncovered


def rank_part(cfg: ArchConfig, mesh, rc: RunConfig):
    """The layout of a rank's serving parameters on ``mesh`` under
    ``rc.pod_param_mode``: its ``Fsdp`` (the model axis's ``Tp`` inside)
    where the mode shards over more than one data rank, else the ``Tp``,
    else None. ``mdl.init(..., part=)`` builds a rank's parameters in it
    (``convert.params_from_numpy`` takes it as ``fsdp=`` or ``tp=``)."""
    tp = Tp.of(mesh, cfg)
    return Fsdp.of(mesh, rc.pod_param_mode, tp) or tp


def _flat(params) -> bool:
    """Whether ``params`` are FSDP row shards (flat tensors)."""
    return params["embed"]["tok"].dim() == 1


class _Mesh:
    """What a serving step needs of ``mesh``: the model axis's layouts
    (``tp``, ``ep``), the FSDP layout of ``pod_param_mode`` (``fsdp``;
    None: the weights whole over the data axes) and the slots' split over
    the data axes."""

    def __init__(self, cfg: ArchConfig, mesh, pod_param_mode: str):
        self.mesh, self.mode = mesh, pod_param_mode
        tp = axis_sizes(mesh).get("model", 1)
        left = uncovered(cfg, tp) if tp > 1 else None
        if left is not None:
            raise ValueError(left)
        self.tp = Tp.of(mesh, cfg)
        self.ep = Ep.of(mesh) if cfg.moe is not None else None
        self.fsdp = Fsdp.of(mesh, pod_param_mode, self.tp)
        self.dp = batch_size(mesh)

    def rows(self, n: int) -> slice:
        """This rank's slots of ``n`` (``rank_rows``)."""
        return rank_rows(n, self.mesh)

    def gather(self, x, n: int):
        """Every data rank's rows of ``x`` in order (``n`` rows in all)."""
        if self.dp == 1 or x.shape[0] == n:
            return x
        return all_gather(x.contiguous(),
                          axis_group(batch_axes(self.mesh), mesh=self.mesh))

    def check(self, params):
        """-> ``fsdp``, once ``params`` are in its layout: FSDP row shards
        (flat) where ``pod_param_mode`` shards over the data ranks, else
        tensors whole over them; another layout raises."""
        if _flat(params) != (self.fsdp is not None):
            held = "FSDP row shards" if _flat(params) else "whole"
            raise ValueError(
                f"params are {held} over the data ranks; pod_param_mode "
                f"{self.mode!r} on this mesh wants "
                f"{'FSDP row shards' if self.fsdp else 'whole'}")
        return self.fsdp

    def params(self, cfg: ArchConfig, params):
        """``params`` in this layout: as they are where they are in it
        (``check`` raises on shards the mode does not take); a whole
        ``LM``, or this rank's model part whole over the data axes, cut
        into a new ``LM`` (buffers shared)."""
        from repro_torch.training.state import is_sharded
        part = self.fsdp or self.tp
        whole = not is_sharded(params)
        if _flat(params) or part is None or (self.fsdp is None
                                             and not whole):
            self.check(params)
            return params
        named = {n: p.detach() for n, p in params.named_parameters()}
        lm = mdl.LM(cfg, device="meta")
        if whole:
            part.shard_module(lm, lambda name, p: named[name])
        else:
            for name, _ in list(lm.named_parameters()):
                mod_name, _, leaf = name.rpartition(".")
                lm.get_submodule(mod_name)._parameters[leaf] = \
                    torch.nn.Parameter(self.fsdp.shard(named[name]),
                                       requires_grad=False)
        for mname, mod in lm.named_modules():
            src = params.get_submodule(mname) if mname else params
            for n in list(mod._buffers):
                mod._buffers[n] = src._buffers[n]
        return lm.trainable(False)


def _step_device(device, mesh) -> torch.device:
    """``resolve_device``, but ``meta`` over any mesh: the dry run's steps
    hold shapes only, over a fake process group
    (``launch/mesh.py::fake_world``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device, mesh)


def make_prefill_step(cfg: ArchConfig, rc: RunConfig, max_len: int, *,
                      device=None, mesh=None, batch_rows: int | None = None):
    """-> ``prefill(params, batch) -> (cache, last_logits)``, with the
    batch's tokens moved to ``device`` (None: the card; this rank's card
    under ``mesh``). On a mesh ``params`` is this rank's part (module
    docstring), the cache this rank's slots and part, the logits whole
    (every slot); ``batch`` the global batch (``batch_rows`` None), or
    this rank's rows (``rank_rows``) of a global batch of ``batch_rows``
    rows, as a per-rank loader gives them; ``device="meta"`` (the dry
    run) over any mesh."""
    device = _step_device(device, mesh)
    m = _Mesh(cfg, mesh, rc.pod_param_mode) if mesh is not None else None

    @torch.inference_mode()
    def prefill_fn(params, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if m is None:
            return mdl.prefill(cfg, rc, params, batch, max_len)
        n = batch_rows or batch["tokens"].shape[0]
        if batch_rows is None:
            batch = {k: v[m.rows(n)] for k, v in batch.items()}
        cache, logits = mdl.prefill(cfg, rc, params, batch, max_len,
                                    fsdp=m.check(params), ep=m.ep, tp=m.tp)
        return cache, m.gather(logits, n)

    return prefill_fn


def make_decode_step(cfg: ArchConfig, rc: RunConfig, *, device=None,
                     mesh=None, batch_rows: int | None = None):
    """-> ``decode(params, cache, token, pos) -> (logits, cache)``; the
    cache is updated in place. On a mesh ``token`` is every slot's
    [slots, 1] (with ``batch_rows`` this rank's, as in
    ``make_prefill_step``), the cache this rank's (``init_rank_cache``),
    the logits every slot's, whole."""
    device = _step_device(device, mesh)
    m = _Mesh(cfg, mesh, rc.pod_param_mode) if mesh is not None else None

    @torch.inference_mode()
    def decode_fn(params, cache, token, pos):
        token = torch.as_tensor(token, device=device)
        if m is None:
            return mdl.decode_step(cfg, rc, params, cache, token, int(pos))
        n = batch_rows or token.shape[0]
        if batch_rows is None:
            token = token[m.rows(n)]
        logits, cache = mdl.decode_step(cfg, rc, params, cache, token,
                                        int(pos), fsdp=m.check(params),
                                        ep=m.ep, tp=m.tp)
        return m.gather(logits, n), cache

    return decode_fn


def init_rank_cache(cfg: ArchConfig, slots: int, max_len: int, *, device,
                    mesh=None, dtype=None) -> list:
    """This rank's cache of ``slots`` slots (``mdl.init_cache``): on a mesh
    its rows of them (``rank_rows``) and its part of each layer's cache;
    ``device="meta"`` builds it without storage (the dry run)."""
    rows = rank_rows(slots, mesh)
    return mdl.init_cache(cfg, rows.stop - rows.start, max_len,
                          device=device,
                          tp=Tp.of(mesh, cfg) if mesh is not None else None,
                          dtype=dtype)


def rank_params(cfg: ArchConfig, mesh=None, rc: RunConfig | None = None):
    """An ``LM`` on ``meta`` as this rank's serving steps take it under
    ``rc.pod_param_mode`` (None: ``RunConfig()``'s "sharded"; the dry run,
    ``launch/dryrun.py``): the model axis's part of each tensor
    (``Tp.shard_module``), cut into FSDP row shards where the mode shards
    (``Fsdp.shard_module``)."""
    lm = mdl.LM(cfg, device="meta")
    part = rank_part(cfg, mesh, rc or RunConfig()) if mesh is not None \
        else None
    if part is not None:
        part.shard_module(lm)
    return lm.trainable(False)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot continuous batching: finished slots are refilled from the queue
    without stopping the running batch (slot-level, not token-level, scheduling).
    ``mesh``: SPMD over its ranks (module docstring); every rank submits
    the same requests and runs the same ``run``. ``cache_dtype``: the KV
    cache's dtype (None: bf16, as the reference's engine keeps it)."""

    def __init__(self, cfg: ArchConfig, rc: RunConfig, params, *,
                 slots: int = 4, max_len: int = 256, eos: int = -1,
                 device=None, mesh=None, cache_dtype=None):
        self.device = resolve_device(device, mesh)
        on = params["embed"]["tok"].device
        if on.type != self.device.type:
            raise ValueError(f"params are on {on}, the engine on "
                             f"{self.device}")
        self.cfg, self.rc = cfg, rc
        self.mesh = mesh
        m = _Mesh(cfg, mesh, rc.pod_param_mode) if mesh is not None else None
        self.params = m.params(cfg, params) if m is not None else params
        self.slots = slots
        self.max_len = max_len
        self.eos = eos
        self.decode = make_decode_step(cfg, rc, device=self.device,
                                       mesh=mesh)
        self.queue: list[Request] = []
        self.active: list[Request | None] = [None] * slots
        with torch.inference_mode():
            self.cache = init_rank_cache(cfg, slots, max_len,
                                         device=self.device, mesh=mesh,
                                         dtype=cache_dtype)
        self.pos = 0
        self.closed = False

    def submit(self, req: Request):
        if self.closed:
            raise RuntimeError(
                "ServeEngine is closed: run() drained its queue (or the KV "
                "cache is full) — a submission now would silently never be "
                "served")
        self.queue.append(req)

    def _fill_slots(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                self.active[i] = self.queue.pop(0)

    def run(self, max_steps: int = 512):
        """Greedy decoding. Prefill is emulated by feeding prompt tokens
        through decode (slot-wise simplicity; the batched prefill path is
        exercised separately)."""
        self._fill_slots()
        # position cursor is shared across slots (simplification: left-aligned)
        feed = [list(r.prompt) if r else [] for r in self.active]
        steps = 0
        while steps < max_steps and (any(self.active) or self.queue):
            tok = np.zeros((self.slots, 1), np.int64)
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                if feed[i]:
                    tok[i, 0] = feed[i].pop(0)
                elif r.out:
                    tok[i, 0] = r.out[-1]
                elif r.prompt:
                    tok[i, 0] = r.prompt[-1]
            logits, self.cache = self.decode(self.params, self.cache, tok,
                                             self.pos)
            self.pos += 1
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for i, r in enumerate(self.active):
                if r is None or feed[i]:
                    continue
                t = int(nxt[i])
                r.out.append(t)
                if len(r.out) >= r.max_new or t == self.eos:
                    r.done = True
                    self.active[i] = None
            self._fill_slots()
            for i, r in enumerate(self.active):
                if r is not None and not r.out and not feed[i] and r.prompt:
                    feed[i] = list(r.prompt)       # newly seated request
            steps += 1
            if self.pos >= self.max_len - 1:
                break
        # drained (or cache exhausted): later submissions could never be
        # served by this engine instance, so reject them at the door
        if self.pos >= self.max_len - 1 or not (any(self.active)
                                                or self.queue):
            self.closed = True
        return steps
