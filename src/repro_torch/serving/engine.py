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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import model as mdl


def make_prefill_step(cfg: ArchConfig, rc: RunConfig, max_len: int, *,
                      device=None):
    """-> ``prefill(params, batch) -> (cache, last_logits)``, with the
    batch's tokens moved to ``device`` (None: the card)."""
    device = resolve_device(device)

    @torch.inference_mode()
    def prefill_fn(params, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        return mdl.prefill(cfg, rc, params, batch, max_len)

    return prefill_fn


def make_decode_step(cfg: ArchConfig, rc: RunConfig, *, device=None):
    """-> ``decode(params, cache, token, pos) -> (logits, cache)``; the
    cache is updated in place."""
    device = resolve_device(device)

    @torch.inference_mode()
    def decode_fn(params, cache, token, pos):
        token = torch.as_tensor(token, device=device)
        return mdl.decode_step(cfg, rc, params, cache, token, int(pos))

    return decode_fn


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot continuous batching: finished slots are refilled from the queue
    without stopping the running batch (slot-level, not token-level, scheduling)."""

    def __init__(self, cfg: ArchConfig, rc: RunConfig, params, *,
                 slots: int = 4, max_len: int = 256, eos: int = -1,
                 device=None):
        self.device = resolve_device(device)
        on = params["embed"]["tok"].device
        if on.type != self.device.type:
            raise ValueError(f"params are on {on}, the engine on "
                             f"{self.device}")
        self.cfg, self.rc = cfg, rc
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos = eos
        self.decode = make_decode_step(cfg, rc, device=self.device)
        self.queue: list[Request] = []
        self.active: list[Request | None] = [None] * slots
        with torch.inference_mode():
            self.cache = mdl.init_cache(cfg, slots, max_len,
                                        device=self.device)
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
