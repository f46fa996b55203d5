"""Profile the PyTorch port's LM prefill and decode steps on the card.

    python3 scripts/torch_lm_profile.py [--arch tinyllama-1.1b] [--batch 8]
        [--prompt 2048] [--steps 4] [--seed 0]

Builds ``--arch`` (any ported architecture) at its published widths (bf16
weights drawn from ``--seed``), then for one prefill of ``batch`` x ``prompt`` tokens and for
``steps`` decode steps from its cache prints one JSON line each: the wall
without the profiler (host clock around synchronised work), and under
``torch.profiler`` (CPU and CUDA activities) the wall, the device busy time
(the sum of the kernels' durations: one stream, so they do not overlap),
the idle share (1 - busy / wall), the number of kernel launches, and the
top operators by self CPU time and the top kernels by device time. Needs a
CUDA device; imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def summary(prof, wall: float) -> dict:
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e6      # us -> s
    avg = prof.key_averages()
    top_cpu = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)
    top_dev = sorted(avg, key=lambda e: e.self_device_time_total,
                     reverse=True)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall, "kernel_launches": len(kernels),
            "top_self_cpu_ms": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                                for e in top_cpu[:12]],
            "top_device_ms": [(e.key, e.count,
                               e.self_device_time_total / 1e3)
                              for e in top_dev[:12]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lm_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import model as mdl
    from repro_torch.serving import make_decode_step, make_prefill_step

    cfg, rc = get_arch(args.arch), RunConfig()
    B, S, n = args.batch, args.prompt, args.steps
    lm = mdl.init(cfg, args.seed, device="cuda")
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, S + 1))
    prefill = make_prefill_step(cfg, rc, S + 2 * n)
    decode = make_decode_step(cfg, rc)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "arch": args.arch}),
          flush=True)

    def run_prefill():
        return prefill(lm, {"tokens": toks[:, :S]})

    def run_decode(cache, start):
        tok = torch.as_tensor(toks[:, S:], device="cuda")
        for i in range(n):
            logits, cache = decode(lm, cache, tok, start + i)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
        return cache

    run_prefill()                                    # warm-up
    (cache, _), plain = timed(run_prefill)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (cache, _), wall = timed(run_prefill)
    print(json.dumps({"phase": "prefill", "batch": B, "prompt": S,
                      "wall_unprofiled_s": plain, **summary(prof, wall)}),
          flush=True)

    run_decode(cache, S)                             # warm-up
    _, plain = timed(lambda: run_decode(cache, S))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: run_decode(cache, S + n))
    print(json.dumps({"phase": "decode", "batch": B, "steps": n,
                      "ms_per_step_unprofiled": plain / n * 1e3,
                      **summary(prof, wall)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
