"""The serving CLI: batched requests through the slot-based engine.

    python -m repro_torch.launch.serve [--arch tinyllama-1.1b] [--reduced]
        [--layers N] [--requests 8] [--slots 4] [--max-new 16]
        [--max-len 128] [--mesh DxM] [--device cuda]

Weights are drawn from seed 0 (no checkpoint is loaded yet). ``--mesh
1x2`` serves on a spawned world of data x model ranks
(``launch/mesh.py::run_on_mesh``): the model tensor parallel over the model
ranks, the slots over the data ranks (``serving/engine.py``), every rank
running the same schedule; the first rank prints. ``--layers``
cuts the depth (deepseek-v3-671b's 61 layers do not fit one card; its first
4 are the 3 dense layers and one MoE layer). Every architecture serves. The
engine feeds prompts through decode, as the reference's does, so no prefill
runs: musicgen-medium's cross-attention cache stays the zeros of
``init_cache`` (its requests are unconditioned) and internvl2-2b's requests
carry no patch embeddings, in both packages.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import RunConfig, get_arch
from repro_torch.core.device import resolve_device
from repro_torch.models import model as mdl
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--mesh", default="",
                    help="serve on a spawned world: DxM (data x model) "
                         "ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        from repro_torch.launch.mesh import run_on_mesh
        return run_on_mesh(_serve_on_mesh, args.mesh, args,
                           device=args.device)[0]
    return _serve(args)


def _serve_on_mesh(mesh, args):
    """``main`` on one rank of ``--mesh``'s world; the first rank prints.
    -> (None, the requests, steps, seconds)."""
    import contextlib
    import io

    import torch.distributed as dist
    quiet = (contextlib.redirect_stdout(io.StringIO()) if dist.get_rank()
             else contextlib.nullcontext())
    with quiet:
        _, reqs, steps, dt = _serve(args, mesh)
    return None, reqs, steps, dt


def _serve(args, mesh=None):
    from repro_torch.parallel.tp import Tp
    device = resolve_device(None if mesh is not None and
                            torch.device(args.device).type == "cuda"
                            else args.device, mesh)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rc = RunConfig()
    params = mdl.init(cfg, 0, device=device,
                      part=Tp.of(mesh, cfg) if mesh is not None else None)
    eng = ServeEngine(cfg, rc, params, slots=args.slots, max_len=args.max_len,
                      device=device, mesh=mesh)
    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 12)).tolist()
        reqs.append(Request(rid=rid, prompt=prompt, max_new=args.max_new))
        eng.submit(reqs[-1])
    t0 = time.perf_counter()
    steps = eng.run(max_steps=args.max_len - 1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    print(f"[serve] {steps} decode steps, {done}/{args.requests} finished, "
          f"{dt:.2f}s ({steps/max(dt,1e-9):.1f} steps/s) on {device}")
    return eng, reqs, steps, dt


if __name__ == "__main__":
    main()
