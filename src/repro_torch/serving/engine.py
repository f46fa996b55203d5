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
calls with the same arguments) the model axis runs tensor parallel
(``parallel/tp.py``: each rank its heads, KV heads, SSM heads or RG-LRU
channels, hidden units and vocabulary rows, and a MoE layer's experts over
``parallel/ep.py``), and the slots go over the data axes where those
divide them (else every data rank runs every slot). Each rank's cache
holds its slots and its KV heads, SSM heads or RG-LRU channels (MLA's
latent whole);
the steps return the whole logits of every slot on every rank (gathered
over ``model``, then over the data axes), so every rank of the engine
takes the same greedy tokens and runs the same schedule. ``params``: this
rank's part (``mdl.init(..., part=Tp.of(mesh, cfg))``,
``convert.params_from_numpy(..., tp=)``), or a whole ``LM``, which the
engine cuts into a new one. Every mixer runs on a model axis
(``models/attention.py``, ``models/rglru.py``, ``models/ssm.py``); a
config whose experts do not split over it raises.
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
from repro_torch.parallel.sharding import (axis_sizes, batch_axes,
                                           batch_size, batch_spec)
from repro_torch.parallel.tp import Tp, uncovered


class _Mesh:
    """What a serving step needs of ``mesh``: the model axis's layouts
    (``tp``, ``ep``) and the slots' split over the data axes."""

    def __init__(self, cfg: ArchConfig, mesh):
        self.mesh = mesh
        tp = axis_sizes(mesh).get("model", 1)
        left = uncovered(cfg, tp) if tp > 1 else None
        if left is not None:
            raise ValueError(left)
        self.tp = Tp.of(mesh, cfg)
        self.ep = Ep.of(mesh) if cfg.moe is not None else None
        self.dp = batch_size(mesh)

    def rows(self, n: int) -> slice:
        """This rank's slots of ``n``: its block over the data axes where
        they divide ``n``, else all, as the reference's ``spec_for``
        replicates an axis the mesh does not divide (``long_500k``'s one
        row runs on every data rank; ``prefill_32k``'s 32 rows split one a
        rank over 2x16x16's 32 data ranks)."""
        if self.dp > 1 and n % self.dp == 0:
            return batch_spec(n, self.mesh)
        return slice(0, n)

    def gather(self, x, n: int):
        """Every data rank's rows of ``x`` in order (``n`` rows in all)."""
        if self.dp == 1 or x.shape[0] == n:
            return x
        return all_gather(x.contiguous(),
                          axis_group(batch_axes(self.mesh), mesh=self.mesh))

    def params(self, cfg: ArchConfig, params):
        """``params`` as this rank's part: cut into a new ``LM`` where it
        is whole."""
        from repro_torch.training.state import is_sharded
        if self.tp is None or is_sharded(params):
            return params
        named = dict(params.named_parameters())
        lm = mdl.LM(cfg, device="meta")
        self.tp.shard_module(lm, lambda name, p: named[name].detach())
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
                      device=None, mesh=None):
    """-> ``prefill(params, batch) -> (cache, last_logits)``, with the
    batch's tokens moved to ``device`` (None: the card; this rank's card
    under ``mesh``). On a mesh ``params`` is this rank's part, the cache
    this rank's slots and KV heads, the logits whole; ``device="meta"``
    (the dry run) over any mesh."""
    device = _step_device(device, mesh)
    m = _Mesh(cfg, mesh) if mesh is not None else None

    @torch.inference_mode()
    def prefill_fn(params, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if m is None:
            return mdl.prefill(cfg, rc, params, batch, max_len)
        n = batch["tokens"].shape[0]
        rows = m.rows(n)
        cache, logits = mdl.prefill(cfg, rc, params,
                                    {k: v[rows] for k, v in batch.items()},
                                    max_len, ep=m.ep, tp=m.tp)
        return cache, m.gather(logits, n)

    return prefill_fn


def make_decode_step(cfg: ArchConfig, rc: RunConfig, *, device=None,
                     mesh=None):
    """-> ``decode(params, cache, token, pos) -> (logits, cache)``; the
    cache is updated in place. On a mesh ``token`` is every slot's
    [slots, 1], the cache this rank's (``make_prefill_step``), the logits
    every slot's, whole."""
    device = _step_device(device, mesh)
    m = _Mesh(cfg, mesh) if mesh is not None else None

    @torch.inference_mode()
    def decode_fn(params, cache, token, pos):
        token = torch.as_tensor(token, device=device)
        if m is None:
            return mdl.decode_step(cfg, rc, params, cache, token, int(pos))
        n = token.shape[0]
        logits, cache = mdl.decode_step(cfg, rc, params, cache,
                                        token[m.rows(n)], int(pos), ep=m.ep,
                                        tp=m.tp)
        return m.gather(logits, n), cache

    return decode_fn


def init_rank_cache(cfg: ArchConfig, slots: int, max_len: int, *, device,
                    mesh=None, dtype=None) -> list:
    """This rank's cache of ``slots`` slots (``mdl.init_cache``): on a mesh
    its rows of them (``_Mesh.rows``) and its KV heads, SSM heads or RG-LRU
    channels; ``device="meta"`` builds it without storage (the dry run)."""
    m = _Mesh(cfg, mesh) if mesh is not None else None
    rows = m.rows(slots) if m is not None else slice(0, slots)
    return mdl.init_cache(cfg, rows.stop - rows.start, max_len,
                          device=device, tp=m.tp if m is not None else None,
                          dtype=dtype)


def rank_params(cfg: ArchConfig, mesh=None):
    """An ``LM`` on ``meta`` as this rank's serving steps take it (the dry
    run, ``launch/dryrun.py``): on a mesh the model axis's part of each
    tensor (``Tp.shard_module``), whole over the data axes."""
    lm = mdl.LM(cfg, device="meta")
    tp = Tp.of(mesh, cfg) if mesh is not None else None
    if tp is not None:
        tp.shard_module(lm)
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
        m = _Mesh(cfg, mesh) if mesh is not None else None
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
