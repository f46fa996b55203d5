"""Profile the PyTorch port's LM prefill and decode steps on the card.

    python3 scripts/torch_lm_profile.py [--arch tinyllama-1.1b] [--batch 8]
        [--prompt 2048] [--steps 4] [--seed 0] [--layers N] [--train]

Builds ``--arch`` (any of the ten architectures) at its published widths
(bf16 weights drawn from ``--seed``; ``--layers`` cuts the depth, as
deepseek-v3-671b needs on one card), then for one prefill of ``batch`` x
``prompt`` tokens (with musicgen-medium's ``cond [B, cond_len, D]`` and
internvl2-2b's ``prefix [B, prefix_embeds, D]`` drawn in bf16 from
``--seed``: their EnCodec/T5 and InternViT frontends are stubs) and for
``steps`` decode steps from its cache prints one JSON line each: the wall
without the profiler (host clock around synchronised work), and under
``torch.profiler`` (CPU and CUDA activities) the wall, the device busy time (the sum of the kernels' durations: one
stream, so they do not overlap), the idle share (1 - busy / wall), the
number of kernel launches, and the top operators by self CPU time and the
top kernels by device time. For a MoE architecture a third line profiles
the first MoE layer alone on its prefill input (``models/moe.py``'s
``_moe_body``) and splits its device time by operator: the expert GEMMs
(``bmm``/``mm``), the router and the gates' elementwise work, and the
dispatch (one-hot, cumulative sums, the buffer's scatter and the gather
back). With ``--train`` it profiles the train step instead (bucketed
AdamW, remat "full", a repeated batch of ``batch`` x ``prompt`` tokens):
the first step cold under the profiler, then a warm step's wall, the
forward and backward alone (``loss_fn`` and ``torch.autograd.grad``; the
rest of the step is the optimizer, the bias update and the metrics), and
a warm step under the profiler. Needs a CUDA device; imports nothing of
``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
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


# operator -> part of a MoE layer's device time (the rest is elementwise)
MOE_GEMM = ("aten::bmm", "aten::mm", "aten::addmm", "aten::matmul")
MOE_DISPATCH = ("aten::one_hot", "aten::cumsum", "aten::index_copy_",
                "aten::index", "aten::index_select", "aten::scatter_",
                "aten::zeros", "aten::zero_", "aten::fill_", "aten::where",
                "aten::cat", "aten::lt", "aten::bitwise_and", "aten::sum",
                "aten::bincount", "aten::copy_", "aten::arange",
                "aten::repeat_interleave", "aten::constant_pad_nd",
                "aten::sort")


def moe_split(prof) -> dict:
    """Self device ms by ATen operator of a profiled MoE layer (the
    kernels' own events, which repeat the same time, are left out), grouped
    into expert GEMMs, dispatch and the rest."""
    parts = {"gemm_ms": 0.0, "dispatch_ms": 0.0, "other_ms": 0.0}
    ops = {}
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if not ms or not e.key.startswith("aten::"):
            continue
        ops[e.key] = ms
        part = "gemm_ms" if e.key in MOE_GEMM else \
            "dispatch_ms" if e.key in MOE_DISPATCH else "other_ms"
        parts[part] += ms
    return {**parts, "by_op_ms": dict(sorted(ops.items(),
                                             key=lambda kv: -kv[1])[:16])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step, not prefill and decode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lm_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import model as mdl
    from repro_torch.serving import make_decode_step, make_prefill_step

    cfg, rc = get_arch(args.arch), RunConfig()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    B, S, n = args.batch, args.prompt, args.steps
    if args.train:
        return profile_train(cfg, args)
    lm = mdl.init(cfg, args.seed, device="cuda")
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab, (B, S + 1))
    extras = mdl.stub_frontend(cfg, B, args.seed, device="cuda")
    prefill = make_prefill_step(cfg, rc, S + 2 * n)
    decode = make_decode_step(cfg, rc)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "arch": args.arch}),
          flush=True)

    def run_prefill():
        return prefill(lm, {"tokens": toks[:, :S], **extras})

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
    if cfg.moe is not None:
        print(json.dumps(profile_moe_layer(cfg, rc, lm, toks[:, :S])),
              flush=True)
    return 0


def profile_train(cfg, args) -> int:
    """``--train``: one JSON line each for the cold first step (profiled),
    the warm step's split and a warm step (profiled)."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import model as mdl
    from repro_torch.training import init_state, make_train_step
    rc = RunConfig(learning_rate=3e-4, warmup_steps=2, steps=8)
    state = init_state(cfg, rc, args.seed, device="cuda")
    toks = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt))
    batch = {"tokens": torch.as_tensor(toks, device="cuda"),
             **mdl.stub_frontend(cfg, args.batch, args.seed, device="cuda")}
    fn = make_train_step(cfg, rc)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "arch": args.arch,
                      "layers": cfg.n_layers, "train": True}), flush=True)
    head = {"batch": args.batch, "seq": args.prompt}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (state, _), wall = timed(lambda: fn(state, batch))
    print(json.dumps({"phase": "train_first_step", **head,
                      **summary(prof, wall)}), flush=True)
    (state, _), step_s = timed(lambda: fn(state, batch))
    params = list(state["params"].parameters())
    _, fwd_bwd_s = timed(lambda: torch.autograd.grad(
        mdl.loss_fn(cfg, rc, state["params"], batch)[0], params))
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (state, _), wall = timed(lambda: fn(state, batch))
    print(json.dumps({"phase": "train_step", **head,
                      "wall_unprofiled_s": step_s,
                      "forward_backward_s": fwd_bwd_s,
                      "optimizer_and_rest_s": step_s - fwd_bwd_s,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      **summary(prof, wall)}), flush=True)
    return 0


def profile_moe_layer(cfg, rc, lm, toks) -> dict:
    """The first MoE layer's routed experts alone on its prefill input
    (the stack's own activations up to it): unprofiled ms (CUDA events,
    median of 5), then under the profiler the split of ``moe_split``."""
    from repro_torch.models import attention as attn_mod, moe
    from repro_torch.models import model as mdl, transformer as tfm
    from repro_torch.models.common import apply_norm
    plan = tfm.layer_plan(cfg)
    li = next(i for i, (_, f) in enumerate(plan) if f == "moe")
    with torch.inference_mode():
        pos = torch.arange(toks.shape[1], device="cuda")
        x = mdl._embed(cfg, lm, torch.as_tensor(toks, device="cuda"), pos)
        for i in range(li):
            x, _, _ = tfm.layer_apply(cfg, rc, lm.stack[i], x,
                                      kind=plan[i][0], ffn=plan[i][1],
                                      positions=pos)
        p = lm.stack[li]
        h = apply_norm(cfg.norm, x, p.get("norm1"))
        y, _ = attn_mod.gqa_or_mla_apply(
            cfg, p["attn"], h, kind=plan[li][0], positions=pos,
            impl=rc.attention_impl_for(h.shape[1]), chunk=rc.attn_chunk)
        h = apply_norm(cfg.norm, x + y, p.get("norm2"))
        h = h.reshape(-1, h.shape[-1])
        m = p["moe"]

        def run():
            return moe._moe_body(cfg, m, h, m["bias"])
        run()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = timed(run)
    n, C_send, C_exp = moe._capacity(cfg.moe, h.shape[0])
    return {"phase": "moe_layer", "layer": li, "tokens": h.shape[0],
            "chunk_tokens": n, "C_exp": C_exp,
            "ms_unprofiled": statistics.median(times),
            **summary(prof, wall), **moe_split(prof)}


if __name__ == "__main__":
    sys.exit(main())
