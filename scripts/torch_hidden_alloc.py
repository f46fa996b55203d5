"""Bytes each operator of a train step allocates beneath the dispatcher on
the card, where no ``TorchDispatchMode`` (the operation census's live-bytes
tracker, ``core/op_census.py``) sees them.

    python3 scripts/torch_hidden_alloc.py [--layers 2] [--batch 4] [--seq 2048]

TinyLlama-1.1B cut to ``--layers``, bf16, ``RunConfig()``: one warm-up step,
then one step under a dispatch mode that resets the allocator's peak before
each operator and prints, for every operator (and its inputs' shapes, dtypes
and contiguity) whose peak inside the call exceeded both the bytes
allocated before and after it by more than 1 MiB, the largest such excess
and its count. ``core/op_census.py::_scratch_bytes`` charges what this
finds. Needs a CUDA device; imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.training import init_state, make_train_step  # noqa: E402


class Hidden(TorchDispatchMode):
    """Per operator: the allocator's peak inside the call above what was
    allocated before and after it."""

    def __init__(self):
        super().__init__()
        self.worst = collections.defaultdict(lambda: [0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = func(*args, **(kwargs or {}))
        hidden = torch.cuda.max_memory_allocated() - max(
            before, torch.cuda.memory_allocated())
        if hidden > 1 << 20:
            key = (func.name(), str([(tuple(a.shape), str(a.dtype),
                                      a.is_contiguous()) for a in args
                                     if isinstance(a, torch.Tensor)]))
            w = self.worst[key]
            w[0] += 1
            w[1] = max(w[1], hidden)
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"),
                              n_layers=args.layers)
    rc = RunConfig()
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.seq), dtype=np.int32)
    state = init_state(cfg, rc, 0)
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    step = make_train_step(cfg, rc)
    step(state, batch)
    torch.cuda.synchronize()
    mode = Hidden()
    with mode:
        step(state, batch)
    torch.cuda.synchronize()
    print(torch.cuda.get_device_name(0), torch.__version__)
    for (name, shapes), (n, worst) in sorted(mode.worst.items(),
                                             key=lambda kv: -kv[1][1]):
        print(f"{worst / 1e9:.4f} GB x{n} {name} {shapes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
