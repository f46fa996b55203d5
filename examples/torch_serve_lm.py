"""Serve a small model with batched requests (continuous slot batching)
on the PyTorch port: the counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch tinyllama-1.1b]
        [--requests 16] [--slots 4] [--max-new 24] [--device cpu]

Builds ``get_arch(--arch).reduced()`` (any of the ten architectures) with
weights drawn from seed 0 and serves ``--requests`` random prompts through
``ServeEngine``'s slots. Runs on the card unless ``--device cpu``. The last
line printed is a JSON object of the run's figures (``main`` returns it,
with each request's generated tokens).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    params = mdl.init(cfg, 0, device=device)
    eng = ServeEngine(cfg, RunConfig(), params, slots=args.slots,
                      max_len=256, device=device)
    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        r = Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, rng.integers(4, 16)).tolist(), max_new=args.max_new)
        reqs.append(r)
        eng.submit(r)
    t0 = time.perf_counter()
    steps = eng.run(max_steps=250)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    finished = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    print(f"[serve] {finished}/{args.requests} requests, {toks} tokens, "
          f"{steps} steps in {dt:.1f}s -> {toks / dt:.1f} tok/s "
          f"(slot util {toks / max(steps * args.slots, 1):.0%})")
    out = {"arch": args.arch, "device": str(device), "requests":
           args.requests, "finished": finished, "tokens": toks,
           "steps": steps, "wall_s": dt}
    print(json.dumps(out), flush=True)
    return {**out, "outputs": [r.out for r in reqs]}


if __name__ == "__main__":
    main()
