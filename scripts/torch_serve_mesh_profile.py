"""Profile the serving decode step on a mesh of cards over NCCL.

    python3 scripts/torch_serve_mesh_profile.py [--arch tinyllama-1.1b]
        [--mesh 2x2] [--steps 8] [--seed 0]

Spawns one NCCL rank a card (``launch/mesh.py::run_on_mesh``; the machine
needs as many cards as the mesh has ranks). On every rank, for
``pod_param_mode`` "sharded" and "replicated": ``--arch`` at its
published widths and depth, this rank's f32 part drawn from ``--seed``
(``serving.rank_part``), a prefill of 2 x 1,024 tokens (a row a data
rank), one uncounted decode step, then ``--steps`` greedy decode steps
timed on the host clock between synchronizes, and as many again under
``torch.profiler``: the device time of the NCCL kernels by collective (a
kernel's time includes its wait for the peer) and of the other kernels
(the union of their intervals), the share of the wall in which no compute
kernel ran, the kernels launched and the ATen operators called a step;
the sharded line names the operators it calls more often than the
replicated step. Beside it, each unit's all-gather alone, as a sharded step
issues it (this rank's shards of a unit's tensors, one per dtype, over
the FSDP ranks): its device ms and bus GB/s (bytes received over time),
CUDA events, median of 5; and whether each card reaches the others'
memory (``torch.cuda.can_device_access_peer``). Prints one JSON line per
mode (rank 0's figures, the ranks' decode ms beside them), the card's
name and power limit first. Imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PREFILL = (2, 1024)
MODES = ("sharded", "replicated")


def synced(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def kernel_split(prof, wall: float, steps: int) -> dict:
    """A step's device ms of the NCCL kernels by collective and of the
    other kernels (the union of their intervals), its kernel launches and
    ATen operator calls, and the share of ``wall`` with no compute kernel
    running. The profiler's ``nccl:*`` annotations on the device are not
    kernels."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("nccl:")]
    nccl, spans = {}, []
    for e in kernels:
        if "nccl" in e.name.lower():
            op = ("all_gather" if "AllGather" in e.name else
                  "all_reduce" if "AllReduce" in e.name else e.name)
            nccl[op] = nccl.get(op, 0.0) + e.device_time / 1e3 / steps
        else:
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):                  # union, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    ops = {e.key: e.count / steps for e in prof.key_averages()
           if e.key.startswith("aten::")}
    return {"nccl_ms": nccl, "compute_busy_ms": busy / 1e3 / steps,
            "compute_idle_share": 1.0 - busy / 1e6 / wall,
            "launches": len(kernels) / steps, "aten_calls": ops}


def unit_gathers(lm, fs) -> dict:
    """Each decode unit's all-gather alone (``Fsdp._Gather``'s: this rank's
    shards of the unit's tensors laid end to end, one per dtype): the
    median device ms of 5 and bus GB/s over the units."""
    from repro_torch.core.compression import all_gather
    layers, u = list(lm.stack), len(lm.cfg.pattern)
    shards = [torch.cat([p.reshape(-1) for m in layers[i:i + u]
                         for p in m.parameters()])
              for i in range(0, len(layers), u)]
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ms = []
    for buf in shards:
        all_gather(buf.reshape(1, -1), fs.group)
        reps = []
        for _ in range(5):
            start.record()
            all_gather(buf.reshape(1, -1), fs.group)
            stop.record()
            stop.synchronize()
            reps.append(start.elapsed_time(stop))
        ms.append(statistics.median(reps))
    got = sum(b.numel() * b.element_size() for b in shards) * (fs.ranks - 1)
    return {"units": len(shards), "shard_gb": sum(
        b.numel() * b.element_size() for b in shards) / 1e9,
        "ms": sum(ms), "unit_ms_median": statistics.median(ms),
        "bus_gb_s": got / (sum(ms) / 1e3) / 1e9}


def rank_profile(mesh, args) -> dict:
    import torch.distributed as dist
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import model as mdl
    from repro_torch.parallel.fsdp import Fsdp
    from repro_torch.serving import (make_decode_step, make_prefill_step,
                                     rank_part)
    cfg = get_arch(args.arch)
    dev = torch.device("cuda", torch.cuda.current_device())
    n = torch.cuda.device_count()
    out = {"rank": dist.get_rank(), "peer_access": all(
        torch.cuda.can_device_access_peer(i, j)
        for i in range(n) for j in range(n) if i != j)}
    toks = torch.as_tensor(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, PREFILL), device=dev)
    S = PREFILL[1]
    for mode in MODES:
        rc = RunConfig(pod_param_mode=mode)
        part = rank_part(cfg, mesh, rc)
        lm = mdl.init(cfg, args.seed, device=dev, dtype=torch.float32,
                      part=part)
        pre = make_prefill_step(cfg, rc, S + 2 * args.steps + 1, mesh=mesh)
        dec = make_decode_step(cfg, rc, mesh=mesh)
        cache, last = pre(lm, {"tokens": toks})
        first = last.argmax(-1, keepdim=True)
        dec(lm, cache, first, S)

        def steps(p0):
            tok = first
            for i in range(args.steps):
                logits, _ = dec(lm, cache, tok, p0 + i)
                tok = logits.argmax(-1, keepdim=True)

        wall = synced(lambda: steps(S + 1))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pwall = synced(lambda: steps(S + 1 + args.steps))
        out[mode] = {"decode_ms": 1e3 * wall / args.steps,
                     "profiled_decode_ms": 1e3 * pwall / args.steps,
                     **kernel_split(prof, pwall, args.steps)}
        if isinstance(part, Fsdp):
            out[mode]["unit_gathers"] = unit_gathers(lm, part)
        del lm, cache, pre, dec
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import mesh_backend, parse_mesh, run_on_mesh
    ranks = int(np.prod(parse_mesh(args.mesh)[0]))
    if mesh_backend("cuda", ranks) != "nccl":
        print(f"{args.mesh} needs {ranks} cards, one a rank; this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    got = run_on_mesh(rank_profile, args.mesh, args)
    calls = {m: got[0][m].pop("aten_calls") for m in MODES}
    more = {k: n - calls["replicated"].get(k, 0.0)
            for k, n in calls["sharded"].items()}
    for mode in MODES:
        extra = ({"aten_calls_over_replicated": dict(sorted(
            ((k, v) for k, v in more.items() if v > 0),
            key=lambda kv: -kv[1])[:12])} if mode == "sharded" else {})
        print(json.dumps({"arch": args.arch, "mesh": args.mesh, "mode": mode,
                          "steps": args.steps,
                          "peer_access": got[0]["peer_access"],
                          "ranks_decode_ms": [r[mode]["decode_ms"]
                                              for r in got],
                          **got[0][mode], **extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
