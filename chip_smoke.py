"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--n 16777216] [--seed 0]

Phases (any failure exits non-zero before the last line is printed):

1. card identity (``torch.cuda.get_device_name``, ``nvidia-smi``);
2. build the three kernel libraries (zones pairs, block quantizer, flash
   attention) from ``src/repro_torch/kernels/*/csrc``, one ``nvcc`` each,
   started together, each with its own flags; ``ptxas -v``'s registers,
   shared memory and spills of every kernel, and a line of its own for
   each redesigned one (the count and the histogram on the register-tiled
   walk, masked and unmasked, and the bf16 flash kernel);
3. the device engine at full width: ``run_jobs`` of Neighbor Searching at
   15", 30" and 60" plus Neighbor Statistics (edges 1..60") over one
   shuffle of a ``make_catalog(n, seed)`` sky with ``ZonePartitioner(60")``,
   for the identity, int16 and int8 codecs; every launch counter is reset
   just before and read just after, and must equal tiers x reducers for
   the masked kernels and 0 for the others;
4. the host engine at full width: the same jobs through
   ``host_shuffle_reduce`` (``run_jobs(engine="host")`` before its
   finalize, which the script applies), keeping the identity codec's
   ``ShuffledData`` for phases 5 and 11; launches must be 3 unmasked counts,
   1 unmasked hist, and for int8 one quantize and one dequantize (the
   codec's whole-payload round trip);
5. each kernel against its plain PyTorch version, exactly: the masked ones
   on sampled partitions (first 4, last 4, fullest) of every tier of every
   codec, the unmasked ones (with and without ``exclude_self``) on sampled
   partitions of the host engine's full-width shuffle, the quantizer
   bitwise on the full-width int8 payload and on edge cases (an all-zero
   block, .5 ties, bf16 input);
6. exact cross-checks: search(r) equals the Neighbor Statistics cumulative
   count at edge r on both engines; the host engine equals the device
   engine run on the host's zone keys (identity, int16; with the card's
   own keys the difference is reported); the card equals the CPU (plain
   versions) for the device engine at 1M objects and 60" and at 50k objects
   and 0.02 rad, and for the int8 host engine (``run_jobs(engine="host")``)
   at 250k objects;
   ``token_histogram`` on both engines equals ``np.bincount`` (identity,
   int16, 4M tokens); small-n search equals the brute-force count;
7. ``stream_device``: the phase-3 catalog written with
   ``MemmapCatalogSplits.write`` to a temporary file and streamed back as
   16 splits of 2^20 rows (``run_jobs_streaming``, prefetch 2: a producer
   thread copies each split to the card through pinned memory on a side
   stream), per codec: outputs equal to phase 3's, launches tiers x
   reducers for the masked kernels and 0 for the others; the stage walls,
   ``fetch_wall_s``, ``overlap_hidden_s``, ``overlap_fraction`` and the
   host clock beside phase 3's monolithic walls;
8. ``stream_lanes`` (int16, the same splits): 4 concurrent lanes, each on a
   CUDA stream of its own, then 4 lanes with a cancellable 60 s stall on
   split 0's first fetch and speculation on: both equal phase 3, with the
   sequential run's launches; the second must clone split 0, the clone
   must win, and ``elapsed_s`` must stay far under the stall;
9. ``stream_host``: the host engine streamed over the first 2^22 rows in 8
   splits (identity, int8), equal to ``run_jobs(engine="host")`` on those
   rows, with its launches (the unmasked kernels and the quantizers);
10. ``stream_wordcount``: 64M tokens (vocab 30,000, from ``--seed``) in a
   ``MemmapTokens`` file, 16 ``TokenBlockSplits`` on the device engine,
   combiner ``"auto"`` and None: both equal ``np.bincount``, and the
   combiner cuts ``shuffle_wire_bytes`` at least 2x;
11. kernel times (CUDA events, median of 5) at the main paths' full-width
   shapes, beside the plain version's time (the seconds-long pair versions:
   one call, no warm-up; the quantizer's: median of 3) and the bound; a
   pair row's time covers ``launches_per_timed_call`` launches (the masked
   ones: one per tier) and ``x_bound`` is its time over its bound;
12. ``lm_prefill``: TinyLlama-1.1B at its published widths, bf16 weights
   drawn from ``--seed``, ``make_prefill_step`` over 8 prompts of 2,048
   tokens (``max_len`` 2,080): wall, tokens/s, exactly one flash launch per
   layer (22) and no other;
13. ``lm_decode``: 32 greedy ``make_decode_step`` steps from that cache (no
   launch of any kernel): ms per step, tokens/s; the first step's logits
   against a full ``forward`` over the 2,049 tokens, relative error < 0.07
   (``tests/test_smoke_archs.py``'s check);
14. ``lm_serve``: ``python -m repro_torch.launch.serve``'s ``main`` with its
   defaults (8 requests, 4 slots, 16 new tokens, ``max_len`` 128): all 8
   finish and the engine ends closed;
15. ``flash_vs_plain``: the flash kernel against ``attention_ref`` on layer
   0's q/k/v at the prefill shape and over the test sweep
   (``tests/test_torch_cases.py``), f32 and bf16, to 1e-5 / 3e-2; its time
   at the prefill shape beside the plain version, the bound and
   ``scaled_dot_product_attention`` (timed only, never used by the port;
   ``x_sdpa`` is the kernel's time over its time).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit; the one before that the kernel table
(seven kernels). Imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

SEARCH_ARCSEC = (15, 30, 60)
CODECS = ("identity", "int16", "int8")
FP32_OPS_PER_CELL = 5          # 3 FMUL + 2 FADD, no FMA (see the .cu note)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense tensor cores
ZP_SOURCE = "src/repro_torch/kernels/zones_pairs/csrc/zones_pairs.cu"
Q_SOURCE = "src/repro_torch/kernels/quantize/csrc/quantize.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
REPLACES = {
    "pair_count_masked": "src/repro/kernels/zones_pairs/kernel.py:167",
    "pair_hist_masked": "src/repro/kernels/zones_pairs/kernel.py:192",
    "pair_count": "src/repro/kernels/zones_pairs/kernel.py:75",
    "pair_hist": "src/repro/kernels/zones_pairs/kernel.py:94",
    "quantize": "src/repro/kernels/quantize/kernel.py:39",
    "dequantize": "src/repro/kernels/quantize/kernel.py:58",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:77",
}
# the pair kernels on the register-tiled walk (zones_pairs.cu): the count
# and the histogram, masked (<1>) and unmasked (<0>)
REDESIGNED = ("count_tiled_kernel<1>", "count_tiled_kernel<0>",
              "hist_tiled_kernel<1>", "hist_tiled_kernel<0>")
VOCAB = 30_000                 # < 32767: the int16 token codec is lossless
STREAM_ROWS = 1 << 20          # rows per catalog split (16 at 2^24 objects)
STALL_S = 60.0                 # the speculated run's injected stall
HOST_STREAM_N = 1 << 22        # the host engine's streamed rows (8 splits)
WC_TOKENS, WC_SEQ = 1 << 26, 2048    # streamed wordcount: 64M tokens
INT8_CPU_N = 250_000           # int8 host engine card == CPU: CPU side < 1 min
LM_ARCH = "tinyllama-1.1b"
LM_BATCH, LM_PROMPT, LM_DECODE = 8, 2048, 32     # max_len = prompt + decode
# flash kernel vs plain: |got - want| <= atol + rtol |want|. The atols are
# test_flash_sweep's, whose outputs stay below 1; layer 0's outputs reach 4-8,
# where one bf16 ulp is 2^-5, so bf16 also allows 1e-2 of |want| (2.5 ulps)
FLASH_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (3e-2, 1e-2)}


def emit(**kw) -> None:
    print(json.dumps(kw, default=float), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_keyed_zones(radius: float):
    """A ``ZonePartitioner`` whose device map takes its zone keys from the
    host ``assign`` (numpy's arcsin), as the host engine does, in place of
    the device's own asin. The two arcsins differ in the last bit for a few
    points per million, which then land in the neighbouring zone."""
    from repro_torch.mapreduce import Partitioner, ZonePartitioner

    class HostKeyedZones(ZonePartitioner):
        assign_device = Partitioner.assign_device

    return HostKeyedZones(radius)


def zone_jobs(codec: str, tile: int = 256, radius=None, edges_arcsec=None,
              host_keys: bool = False):
    """Search at each radius of SEARCH_ARCSEC (or at ``radius``) plus
    statistics, batched over one ZonePartitioner (``host_keys``: one from
    ``host_keyed_zones``)."""
    from repro_torch.data.sky import ARCSEC
    from repro_torch.mapreduce import (ZonePartitioner, neighbor_search_job,
                                       neighbor_statistics_job)
    radii = ([a * ARCSEC for a in SEARCH_ARCSEC] if radius is None
             else [radius])
    part = (host_keyed_zones if host_keys else ZonePartitioner)(radii[-1])
    jobs = [neighbor_search_job(r, partitioner=part, codec=codec, tile=tile)
            for r in radii]
    jobs.append(neighbor_statistics_job(edges_arcsec, partitioner=part,
                                        codec=codec, tile=tile))
    return jobs


def outputs(results):
    return [r.output if isinstance(r.output, int) else
            np.asarray(r.output).tolist() for r in results]


# Itanium mangling's one-letter builtin types that the kernels' template
# arguments use
BUILTIN_TYPES = {"b": "bool", "i": "int", "f": "float", "d": "double"}


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name -> its name and template arguments:
    '_ZN12_GLOBAL__N_115flash_tc_kernelILi64EEEv...' ->
    'flash_tc_kernel<64>', '...15quantize_kernelI13__nv_bfloat16EEv...' ->
    'quantize_kernel<__nv_bfloat16>'. Reads length-prefixed names, nested
    names (``N...E``, joined with ``::``), literals (``Li64E``, ``Lb0E``)
    and builtin types; a name it cannot read comes back as it is."""
    pos = 0

    def source_name():                  # <length><identifier>
        nonlocal pos
        digits = re.match(r"\d+", mangled[pos:])
        pos += digits.end()
        name = mangled[pos:pos + int(digits.group())]
        pos += len(name)
        return name

    def nested():                       # N <name>... [I <args> E] E
        nonlocal pos
        pos += 1
        parts = []
        while mangled[pos] != "E":
            parts.append(source_name() + template_args())
        pos += 1
        return parts

    def template_args():                # I <arg>... E, or nothing
        nonlocal pos
        if mangled[pos] != "I":
            return ""
        pos += 1
        args = []
        while mangled[pos] != "E":
            args.append(arg())
        pos += 1
        return f"<{','.join(args)}>"

    def arg():
        nonlocal pos
        c = mangled[pos]
        if c == "L":                    # L <type> <value> E
            end = mangled.index("E", pos)
            value = mangled[pos + 2:end]
            pos = end + 1
            return "-" + value[1:] if value.startswith("n") else value
        if c == "N":
            return "::".join(nested())
        if c.isdigit():
            return source_name() + template_args()
        pos += 1
        return BUILTIN_TYPES[c]

    try:
        if not mangled.startswith("_Z"):
            return mangled
        pos = 2
        if mangled[pos] == "N":
            return nested()[-1]
        return source_name() + template_args()
    except (AttributeError, IndexError, KeyError, ValueError):
        return mangled


def ptxas_summary(log: str) -> list:
    """``nvcc -Xptxas -v``'s report, one dict per kernel: its name (read
    from the mangled one), registers, shared memory, stack, spill stores and
    loads, and any performance warning that names it."""
    rows, cur = {}, None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            cur = rows.setdefault(entry.group(1), {
                "kernel": kernel_name(entry.group(1)), "warnings": []})
            continue
        warn = re.search(r"\((C\d+)\) (.*) for the function '(\w+)'", ln)
        if warn:
            rows.setdefault(warn.group(3), {
                "kernel": kernel_name(warn.group(3)), "warnings": []}
            )["warnings"].append(f"{warn.group(1)} {warn.group(2)}")
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
        if spill:
            cur.update(stack_bytes=int(spill.group(1)),
                       spill_stores=int(spill.group(2)),
                       spill_loads=int(spill.group(3)))
        used = re.search(r"Used (\d+) registers", ln)
        if used:
            smem = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(used.group(1)),
                       static_smem_bytes=int(smem.group(1)) if smem else 0)
    return list(rows.values())


def check_outputs(results, n_edges: int) -> None:
    *search, stats = results
    for r in search:
        if not isinstance(r.output, int):
            raise AssertionError(f"search output {r.output!r} is not an int")
    hist = np.asarray(stats.output)
    if hist.shape != (n_edges,) or hist.dtype.kind != "i":
        raise AssertionError(f"stats output {hist.shape} {hist.dtype}")
    cum = np.cumsum(hist)
    for r, arcsec in zip(search, SEARCH_ARCSEC):
        if r.output != int(cum[arcsec - 1]):
            raise AssertionError(f"search({arcsec}\") {r.output} != stats "
                                 f"cum {int(cum[arcsec - 1])}")


def launch_counts(**launched) -> dict:
    """The whole launch-count dict: ``launched`` and 0 for every other."""
    from repro_torch.kernels import LAUNCHES
    return {k: launched.get(k, 0) for k in LAUNCHES}


def zone_launches(engine: str, codec: str, jobs, st) -> dict:
    """What one batched search+stats run must launch: per tier one masked
    kernel per reducer (device engine), or one unmasked kernel per reducer
    plus, for int8, the codec's quantize and dequantize (host engine)."""
    if engine == "device":
        return launch_counts(pair_count_masked=len(st.tiers) * (len(jobs) - 1),
                             pair_hist_masked=len(st.tiers))
    q = int(codec == "int8")
    return launch_counts(pair_count=len(jobs) - 1, pair_hist=1, quantize=q,
                         dequantize=q)


def counted(fn, launches: dict, want: dict | None = None):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after, between two synchronizes, and add the counts to ``launches``;
    with ``want`` (a ``launch_counts`` dict) they must equal it.
    -> (fn's result, host-clock wall, counts)."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    if want is not None and counts != want:
        raise AssertionError(f"launches {counts} != {want}")
    for k in launches:
        launches[k] += counts[k]
    return out, wall, counts


def stage_summary(st) -> dict:
    return {k: v for k, v in st.to_dict().items()
            if k.endswith(("_s", "_bytes", "_ratio", "flops"))
            or k in ("n_items", "n_partitions", "device", "tiers")}


def sample_rows(n_owned: torch.Tensor) -> torch.Tensor:
    """First 4, last 4 and the fullest partition rows."""
    Pt = n_owned.shape[0]
    idx = set(range(min(4, Pt))) | set(range(max(0, Pt - 4), Pt))
    idx.add(int(torch.argmax(n_owned)))
    return torch.tensor(sorted(idx), device=n_owned.device)


def check_equal(what: str, got, want) -> float:
    """Integers (or bit patterns) must be equal. -> max absolute error."""
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel {got.tolist()[:8]} != plain "
                             f"{want.tolist()[:8]}")
    return 0.0


def masked_vs_plain(cat, jobs) -> float:
    """Both masked kernels against their plain versions on sampled rows of
    every tier. -> max absolute error (0)."""
    from repro_torch.kernels.zones_pairs import kernel, ref
    *search, stats = jobs
    for t, tier in enumerate(cat.sd.tiers):
        rows = sample_rows(tier.n_owned)
        a = cat.codec.decode_device(*(w[rows] for w in tier.owned_wire))
        b = cat.codec.decode_device(*(w[rows] for w in tier.bucket_wire))
        a, b = a.contiguous(), b.contiguous()
        na, nb = tier.n_owned[rows].contiguous(), tier.n_bucket[rows].contiguous()
        for j in search:
            cmin = j.reducer.cos_min()
            check_equal(f"tier {t} count r={j.reducer.radius}",
                        kernel.pair_count_masked_cuda(a, b, na, nb, cmin),
                        ref.pair_count_masked_ref(a, b, na, nb, cmin))
        edges = stats.reducer.cos_edges().to(a.device)
        check_equal(f"tier {t} hist",
                    kernel.pair_hist_masked_cuda(a, b, na, nb, edges),
                    ref.pair_hist_masked_ref(a, b, na, nb, edges))
    return 0.0


def unmasked_vs_plain(sd, jobs, device) -> float:
    """Both unmasked kernels, with and without ``exclude_self``, against
    their plain versions on sampled partitions of the host engine's
    shuffle. -> max absolute error (0)."""
    from repro_torch.kernels.zones_pairs import kernel, ref
    *search, stats = jobs
    rows = sample_rows(torch.as_tensor(sd.n_owned)).numpy()
    a = torch.as_tensor(sd.owned[rows], device=device)
    b = torch.as_tensor(sd.bucket[rows], device=device)
    edges = stats.reducer.cos_edges().to(device)
    for excl in (False, True):
        for j in search:
            cmin = j.reducer.cos_min()
            check_equal(f"unmasked count r={j.reducer.radius} excl={excl}",
                        kernel.pair_count_cuda(a, b, cmin, exclude_self=excl),
                        ref.pair_count_ref(a, b, cmin, exclude_self=excl))
        check_equal(f"unmasked hist excl={excl}",
                    kernel.pair_hist_cuda(a, b, edges, exclude_self=excl),
                    ref.pair_hist_ref(a, b, edges, exclude_self=excl))
    return 0.0


def int8_payload(xyz, device) -> torch.Tensor:
    """The int8 codec's host payload: the catalog flattened and zero-padded
    to whole 256-element blocks, as one [1, n_pad] row on the card."""
    flat = torch.as_tensor(xyz.reshape(-1), device=device)
    n_pad = -(-flat.numel() // 256) * 256
    return torch.nn.functional.pad(flat, (0, n_pad - flat.numel()))[None]


def quantize_vs_plain(payload) -> float:
    """The quantizer bitwise on the payload and on edge cases. -> max
    absolute error (0)."""
    from repro_torch.kernels.quantize import kernel, ref
    edge = torch.zeros((2, 1024), device=payload.device)
    edge[1, :5] = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5])  # scale 1: ties
    edge[1, 256:512] = payload[0, :256]
    cases = [("payload", payload), ("edges", edge),
             ("edges bf16", edge.to(torch.bfloat16)),
             ("payload bf16", payload[:, :1 << 20].to(torch.bfloat16))]
    for name, x in cases:
        q, s = kernel.quantize_cuda(x)
        wq, ws = ref.quantize_ref(x)
        check_equal(f"quantize {name} codes", q, wq)
        check_equal(f"quantize {name} scales", s.view(torch.int32),
                    ws.view(torch.int32))
        check_equal(f"dequantize {name}",
                    kernel.dequantize_cuda(q, s).view(torch.int32),
                    ref.dequantize_ref(q, s).view(torch.int32))
    q, s = kernel.quantize_cuda(edge)
    if q[1, :5].tolist() != [127, 0, 2, 2, -2] or q[0].any() \
            or s[0, 0].item() != np.float32(1e-12):
        raise AssertionError(f"edge codes {q[1, :5].tolist()}, zero-block "
                             f"scale {s[0, 0].item()}")
    return 0.0


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median over ``reps`` of one call of ``fn``, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_row(name, source, launches, max_err, ms, plain_ms, bound_ms,
               bound_by, library_ms=None, tolerance="exact", **extra) -> dict:
    """One row of the kernel table. The run has already held every output
    of the kernel against its plain version to ``tolerance`` (or raised)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err, "tolerance": tolerance,
            "match_plain": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra}


def time_kernels(cat, jobs, sd, payload, launches: dict, max_err: dict
                 ) -> list:
    """Time each kernel at its main path's full-width shapes (masked: every
    tier of the device engine, one reducer's whole reduce; unmasked: the
    host engine's one launch over all partitions; quantizer: the int8
    payload), beside its plain version and its bound."""
    from repro_torch.kernels.quantize import kernel as qk, ref as qr
    from repro_torch.kernels.zones_pairs import kernel, ref
    dev = payload.device
    tiers = []
    for tier in cat.sd.tiers:
        tiers.append((cat.codec.decode_device(*tier.owned_wire).contiguous(),
                      cat.codec.decode_device(*tier.bucket_wire).contiguous(),
                      tier.n_owned, tier.n_bucket))
    real_cells = float(sum(
        (no.double() * nb.double()).sum().item() for _, _, no, nb in tiers))
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    lanes = props.multi_processor_count * 128            # FP32 lanes per SM
    ops_rate = lanes * clock_hz

    def ops_bound(cells):
        return FP32_OPS_PER_CELL * cells / ops_rate * 1e3

    cmin = jobs[-2].reducer.cos_min()                     # 60" search
    edges = jobs[-1].reducer.cos_edges().to(dev)

    def per_tier(fn, *arg):
        return lambda: [fn(a, b, na, nb, *arg) for a, b, na, nb in tiers]

    rows = []
    for name, kern, plain, arg in (
            ("pair_count_masked", kernel.pair_count_masked_cuda,
             ref.pair_count_masked_ref, cmin),
            ("pair_hist_masked", kernel.pair_hist_masked_cuda,
             ref.pair_hist_masked_ref, edges)):
        ms, bound = cuda_ms(per_tier(kern, arg)), ops_bound(real_cells)
        rows.append(kernel_row(
            name, ZP_SOURCE, launches, max_err[name], ms,
            cuda_ms(per_tier(plain, arg), reps=1, warmup=0),
            bound, "operations", cells=real_cells, sm_clock_hz=clock_hz,
            x_bound=ms / bound, launches_per_timed_call=len(tiers)))
    a = torch.as_tensor(sd.owned, device=dev)
    b = torch.as_tensor(sd.bucket, device=dev)
    cells = float(a.shape[0]) * a.shape[1] * b.shape[1]
    for name, kern, plain, arg in (
            ("pair_count", kernel.pair_count_cuda, ref.pair_count_ref, cmin),
            ("pair_hist", kernel.pair_hist_cuda, ref.pair_hist_ref, edges)):
        ms, bound = cuda_ms(lambda: kern(a, b, arg)), ops_bound(cells)
        rows.append(kernel_row(
            name, ZP_SOURCE, launches, max_err[name], ms,
            cuda_ms(lambda: plain(a, b, arg), reps=1, warmup=0),
            bound, "operations", cells=cells,
            shape=[list(a.shape), list(b.shape)], sm_clock_hz=clock_hz,
            x_bound=ms / bound, launches_per_timed_call=1))
    del a, b
    n = payload.numel()
    q, s = qk.quantize_cuda(payload)
    byte_count = {"quantize": 4 * n + n + 4 * (n // 256),
                  "dequantize": n + 4 * (n // 256) + 4 * n}
    for name, kern, plain in (
            ("quantize", lambda: qk.quantize_cuda(payload),
             lambda: qr.quantize_ref(payload)),
            ("dequantize", lambda: qk.dequantize_cuda(q, s),
             lambda: qr.dequantize_ref(q, s))):
        rows.append(kernel_row(
            name, Q_SOURCE, launches, max_err[name], cuda_ms(kern),
            cuda_ms(plain, reps=3),
            byte_count[name] / HBM_BYTES_PER_S * 1e3, "bytes",
            bytes=byte_count[name], shape=list(payload.shape)))
    return rows


def stream_summary(st) -> dict:
    """A streamed run's walls: the stage walls, the exposed and hidden
    fetch, the overlap and, for lanes, the run's own wall."""
    keys = ("wall_s", "map_wall_s", "shuffle_wall_s", "reduce_wall_s",
            "fetch_wall_s", "combine_wall_s", "overlap_hidden_s",
            "overlap_fraction", "n_splits", "n_items", "combiner",
            "shuffle_wire_bytes", "n_lanes", "elapsed_s", "speculated",
            "clone_wins", "retries", "lane_walls", "tiers")
    d = st.to_dict()
    out = {k: d[k] for k in keys}
    out["split_median_s"] = {k: statistics.median(r[k] for r in st.splits)
                             for k in ("fetch_prep_s", "fetch_wait_s",
                                       "map_s", "wall_s")}
    return out


def stream_phases(xyz, seed: int, mono: dict, launches: dict,
                  n_edges: int) -> None:
    """Phases 7-10: the streaming executor at full width. ``mono`` holds
    phase 3's (outputs, -, host wall, StageStats) per codec."""
    import tempfile
    from repro_torch.data.pipeline import (ArraySplits, MemmapCatalogSplits,
                                           MemmapTokens, TokenBlockSplits)
    from repro_torch.ft import FaultySplitSource, SpeculativeConfig
    from repro_torch.mapreduce import (run_jobs, run_jobs_streaming,
                                       token_histogram_job)

    def same(what, res, want_outputs):
        if outputs(res) != want_outputs:
            raise AssertionError(f"{what}: {outputs(res)} != {want_outputs}")
        check_outputs(res, n_edges)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-stream-") as tmp:
        # 7. the catalog from a file, 16 prefetched splits, per codec
        path = str(Path(tmp) / "catalog.f32")
        t0 = time.perf_counter()
        MemmapCatalogSplits.write(path, xyz)
        write_s = time.perf_counter() - t0
        src = MemmapCatalogSplits(path, d=xyz.shape[1],
                                  rows_per_split=STREAM_ROWS)
        seq_counts = {}
        for codec in CODECS:
            jobs = zone_jobs(codec)
            res, wall, counts = counted(
                lambda: run_jobs_streaming(jobs, src, prefetch=2), launches)
            st, mst = res[0].stats, mono[codec][3]
            same(f"stream_device {codec}", res, mono[codec][0])
            want = zone_launches("device", codec, jobs, st)
            if counts != want or st.tiers != mst.tiers:
                raise AssertionError(f"stream_device {codec}: launches "
                                     f"{counts} != {want}, tiers {st.tiers} "
                                     f"vs {mst.tiers}")
            seq_counts[codec] = counts
            emit(phase="stream_device", codec=codec, rows_per_split=STREAM_ROWS,
                 prefetch=2, file_bytes=Path(path).stat().st_size,
                 write_s=write_s, host_wall_s=wall, launches=counts,
                 stats=stream_summary(st), mono_host_wall_s=mono[codec][2],
                 mono_stats={k: getattr(mst, k) for k in (
                     "wall_s", "map_wall_s", "shuffle_wall_s",
                     "reduce_wall_s")})

        # 8. four lanes, then four lanes with a stalled split and speculation
        jobs = zone_jobs("int16")
        faulty = FaultySplitSource(src, delays={0: STALL_S})
        for run, source, kw in (
                ("lanes", src, {}),
                ("speculated", faulty, {"speculate": SpeculativeConfig(
                    slowdown=2.0, min_finished=2, max_clones=1)})):
            res, wall, counts = counted(
                lambda: run_jobs_streaming(jobs, source, n_lanes=4, **kw),
                launches, seq_counts["int16"])
            st = res[0].stats
            same(f"stream_lanes {run}", res, mono["int16"][0])
            if run == "speculated" and not (
                    st.speculated >= 1 and st.clone_wins >= 1
                    and st.elapsed_s < STALL_S / 6):
                raise AssertionError(
                    f"speculation: speculated {st.speculated}, clone wins "
                    f"{st.clone_wins}, elapsed {st.elapsed_s} s against a "
                    f"{STALL_S} s stall")
            emit(phase="stream_lanes", run=run, codec="int16", n_lanes=4,
                 host_wall_s=wall, launches=counts, stats=stream_summary(st),
                 injected_delay_s=faulty.injected_delay_s,
                 split0=st.splits[0])

        # 9. the host engine streamed, against its own monolithic run
        sub = xyz[:HOST_STREAM_N]
        for codec in ("identity", "int8"):
            jobs = zone_jobs(codec)
            ref, ref_wall, ref_counts = counted(
                lambda: run_jobs(jobs, sub, engine="host"), launches)
            res, wall, counts = counted(
                lambda: run_jobs_streaming(jobs, ArraySplits(sub, 8),
                                           engine="host"), launches)
            want = zone_launches("host", codec, jobs, res[0].stats)
            if counts != want or ref_counts != want:
                raise AssertionError(f"stream_host {codec}: launches {counts}"
                                     f", monolithic {ref_counts} != {want}")
            same(f"stream_host {codec}", res, outputs(ref))
            emit(phase="stream_host", codec=codec, n=len(sub), n_splits=8,
                 host_wall_s=wall, launches=counts,
                 stats=stream_summary(res[0].stats), mono_host_wall_s=ref_wall,
                 mono_wall_s=ref[0].stats.wall_s)

        # 10. wordcount over a token file, combiner on and off
        t0 = time.perf_counter()
        toks = np.random.default_rng(seed).integers(0, VOCAB, WC_TOKENS,
                                                    dtype=np.int32)
        tpath = str(Path(tmp) / "tokens.i32")
        MemmapTokens.write(tpath, toks)
        want_counts = np.bincount(toks, minlength=VOCAB)
        setup_s = time.perf_counter() - t0
        del toks
        rows = WC_TOKENS // WC_SEQ
        tsrc = TokenBlockSplits(MemmapTokens(tpath, WC_SEQ), WC_SEQ,
                                rows_per_split=rows // 16, n_splits=16)
        wire = {}
        for comb in ("auto", None):
            res, wall, counts = counted(
                lambda: run_jobs_streaming([token_histogram_job(VOCAB)], tsrc,
                                           combiner=comb),
                launches, launch_counts())
            if not np.array_equal(res[0].output, want_counts):
                raise AssertionError(f"stream_wordcount combiner={comb} != "
                                     "np.bincount")
            st = res[0].stats
            wire[comb] = st.shuffle_wire_bytes
            emit(phase="stream_wordcount", combiner=comb, n_tokens=WC_TOKENS,
                 vocab=VOCAB, setup_s=setup_s, host_wall_s=wall,
                 stats=stream_summary(st))
        if not wire[None] >= 2 * wire["auto"]:
            raise AssertionError(f"combiner wire bytes {wire['auto']} vs "
                                 f"{wire[None]} without")
        emit(phase="stream_wordcount_wire", on=wire["auto"], off=wire[None],
             ratio=wire[None] / wire["auto"])


def lm_main_path(seed: int, dev, launches: dict):
    """Phases 12-14: TinyLlama prefill, decode and the serving CLI at full
    width. -> (the model, the prefill tokens) for phase 15."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl
    from repro_torch.serving import make_decode_step, make_prefill_step

    cfg, rc = get_arch(LM_ARCH), RunConfig()
    B, S, n_dec = LM_BATCH, LM_PROMPT, LM_DECODE
    t0 = time.perf_counter()
    lm = mdl.init(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    prefill = make_prefill_step(cfg, rc, S + n_dec)
    decode = make_decode_step(cfg, rc)

    # 12. prefill (one uncounted warm-up call first: cuBLAS handles, autotune)
    prefill(lm, {"tokens": toks[:, :S]})
    torch.cuda.reset_peak_memory_stats()
    (cache, last), wall, counts = counted(
        lambda: prefill(lm, {"tokens": toks[:, :S]}), launches,
        launch_counts(flash_attention=cfg.n_layers))
    if last.shape != (B, cfg.vocab_padded) or not torch.isfinite(last).all():
        raise AssertionError(f"prefill logits {tuple(last.shape)} not finite")
    emit(phase="lm_prefill", arch=LM_ARCH, batch=B, prompt=S,
         max_len=S + n_dec, dtype=str(last.dtype), init_s=init_s, wall_s=wall,
         tokens_per_s=B * S / wall, launches=counts,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         param_gb=param_gb(lm))

    # 13. greedy decode from that cache, then test_smoke_archs' consistency
    def run_decode():
        tok, times, first = toks[:, S:S + 1], [], None
        for i in range(n_dec):
            t0 = time.perf_counter()
            logits, _ = decode(lm, cache, tok, S + i)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            first = logits if first is None else first
        return first, times
    (first, times), wall, counts = counted(run_decode, launches,
                                           launch_counts())
    with torch.inference_mode():
        full = mdl.forward(cfg, rc, lm, {"tokens": torch.as_tensor(
            toks, device=dev)})[0][:, S].float()
    rel = ((first.float() - full).abs().max()
           / torch.clamp_min(full.abs().max(), 1.0)).item()
    if not rel < 0.07:
        raise AssertionError(f"decode vs forward: relative error {rel}")
    ms = statistics.median(times) * 1e3
    emit(phase="lm_decode", steps=n_dec, batch=B, wall_s=wall,
         ms_per_step=ms, first_step_ms=times[0] * 1e3,
         tokens_per_s=B / (ms / 1e3), launches=counts,
         rel_err_vs_forward=rel)
    del cache

    # 14. the serving CLI with its defaults
    (eng, reqs, steps, _), wall, counts = counted(
        lambda: serve.main([]), launches, launch_counts())
    done = sum(r.done for r in reqs)
    if done != len(reqs) or not eng.closed:
        raise AssertionError(f"serve: {done}/{len(reqs)} finished, closed "
                             f"{eng.closed}")
    emit(phase="lm_serve", requests=len(reqs), finished=done, steps=steps,
         closed=eng.closed, wall_s=wall, steps_per_s=steps / wall,
         new_tokens=sum(len(r.out) for r in reqs), launches=counts)
    return lm, toks[:, :S]


def param_gb(module) -> float:
    return sum(p.numel() * p.element_size() for p in module.parameters()) / 1e9


def layer0_qkv(lm, toks, dev):
    """Layer 0's rotated q and k and its v over ``toks``, as ``gqa_apply``
    computes them."""
    from repro_torch.models.common import apply_norm, einsum, rope
    cfg, p = lm.cfg, lm.stack[0]
    with torch.inference_mode():
        x = lm["embed"]["tok"][torch.as_tensor(toks, device=dev)]
        h = apply_norm(cfg.norm, x, p["norm1"])
        pos = torch.arange(toks.shape[1], device=dev)
        q, k, v = (einsum("bsd,dhk->bshk", h, p["attn"][w])
                   for w in ("w_q", "w_k", "w_v"))
        return (rope(q, pos, cfg.rope_theta).contiguous(),
                rope(k, pos, cfg.rope_theta).contiguous(), v.contiguous())


def flash_vs_plain(lm, toks, dev, launches: dict) -> dict:
    """Phase 15: the flash kernel against its plain version on layer 0's
    q/k/v at the prefill shape and over the test sweep, then its times.
    -> the kernel's row of the table."""
    from repro_torch.kernels.flash_attention import kernel, ref
    from test_torch_cases import FLASH_CASES, FLASH_EDGE_CASES, flash_case

    def err(q, k, v, **kw):
        got = kernel.flash_attention_cuda(q, k, v, **kw).float()
        want = ref.attention_ref(q, k, v, **kw).float()
        atol, rtol = FLASH_TOL[q.dtype]
        diff = (got - want).abs()
        if not (diff <= atol + rtol * want.abs()).all():
            raise AssertionError(f"flash {tuple(q.shape)} {q.dtype} {kw}: "
                                 f"max error {diff.max().item()} beyond "
                                 f"{atol} + {rtol} |want|")
        return diff.max().item()

    q, k, v = layer0_qkv(lm, toks, dev)
    worst = {"prefill_bf16": err(q, k, v)}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for S, H, Kv, dh, window, cap in FLASH_CASES + FLASH_EDGE_CASES:
            qc, kc, vc = (torch.as_tensor(x).to(dtype).to(dev)
                          for x in flash_case(S, H, Kv, dh))
            for causal in (True, False):
                e = err(qc, kc, vc, causal=causal, window=window,
                        softcap=cap)
                worst[name] = max(worst.get(name, 0.0), e)
    emit(phase="flash_vs_plain", shape=[list(q.shape), list(k.shape)],
         cases=len(FLASH_CASES + FLASH_EDGE_CASES), max_abs_err=worst,
         max_abs_out=ref.attention_ref(q, k, v).abs().max().item(),
         tol={str(d).split(".")[-1]: t for d, t in FLASH_TOL.items()})

    B, S, H, dh = q.shape
    flops = 4.0 * B * H * dh * S * (S + 1) / 2        # unmasked causal pairs
    byte_count = 2 * q.element_size() * (q.numel() + k.numel())  # q k v o
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = byte_count / HBM_BYTES_PER_S * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = cuda_ms(lambda: kernel.flash_attention_cuda(q, k, v))
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v), reps=3)
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True))
    return kernel_row(
        "flash_attention", FA_SOURCE, launches, worst["prefill_bf16"], ms,
        plain_ms, max(ops_ms, bytes_ms),
        "operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=library_ms,
        tolerance=dict(zip(("atol", "rtol"), FLASH_TOL[q.dtype])),
        shape=[list(q.shape), list(k.shape)],
        flops=flops, bytes=byte_count, max_abs_err_sweep=worst,
        achieved_tflops=flops / ms / 1e9, x_sdpa=ms / library_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 2

    from repro_torch.data import sky
    from repro_torch.kernels import LAUNCHES, _build
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.quantize import kernel as qkernel
    from repro_torch.kernels.zones_pairs import kernel as zkernel
    from repro_torch.mapreduce import (JobResult, StageStats,
                                       host_shuffle_reduce, run_jobs,
                                       shuffle_once, token_histogram)

    # 1. card identity
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build the three libraries, one nvcc each, started together
    t0 = time.perf_counter()
    libs = (zkernel.LIBRARY, qkernel.LIBRARY, fkernel.LIBRARY)
    paths = _build.build(*libs)
    for lib in libs:
        lib.load()
    ptxas = {lib.name: ptxas_summary(lib.info["log"]) for lib in libs}
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[str(p) for p in paths],
         nvcc_seconds={lib.name: lib.info["seconds"] for lib in libs},
         ptxas=ptxas)
    # the redesigned kernels: registers, shared memory and spills
    fa_lib = fkernel.LIBRARY.load()
    for name, kernels in ptxas.items():
        for k in kernels:
            m = re.fullmatch(r"flash_tc_kernel<(\d+)>", k["kernel"])
            if m:
                k["dynamic_smem_bytes"] = fa_lib.fa_tc_smem_bytes(
                    int(m.group(1)))
            if m or k["kernel"] in REDESIGNED:
                emit(phase="ptxas", library=name, **k)

    t0 = time.perf_counter()
    xyz = sky.make_catalog(args.n, args.seed)
    emit(phase="catalog", n=args.n, seed=args.seed,
         seconds=time.perf_counter() - t0)
    launches = dict.fromkeys(LAUNCHES, 0)
    n_edges = len(zone_jobs("identity")[-1].reducer.edges_rad)

    def drive(codec, engine):
        """-> (outputs, the host engine's ShuffledData or None, host wall,
        StageStats)."""
        jobs = zone_jobs(codec)

        def run():
            if engine == "device":
                return run_jobs(jobs, xyz, engine=engine), None
            st = StageStats()
            totals, sd = host_shuffle_reduce(jobs, xyz, st)
            st.reduce_padded_ratio = sd.padded_ratio
            return [JobResult(j.reducer.finalize(t, sd), st)
                    for j, t in zip(jobs, totals)], sd

        (res, sd), wall, counts = counted(run, launches)
        st = res[0].stats
        want = zone_launches(engine, codec, jobs, st)
        if counts != want:
            raise AssertionError(f"{engine} {codec}: launches {counts} != "
                                 f"{want}")
        check_outputs(res, n_edges)
        (P, C1, C2), = st.tiers if engine == "host" else ((0, 0, 0),)
        emit(phase=f"main_path_{engine}", codec=codec, wall_s=wall,
             launches=counts, tiers=st.tiers, outputs=outputs(res),
             padded_ratio=st.reduce_padded_ratio, C1=C1, C2=C2,
             stats=stage_summary(st))
        return outputs(res), sd, wall, st

    # 3. the device engine, per codec
    mono = {codec: drive(codec, "device") for codec in CODECS}
    full = {codec: run[0] for codec, run in mono.items()}
    # 4. the host engine, per codec; phases 5 and 11 reuse identity's shuffle
    full_host = {}
    for codec in CODECS:
        full_host[codec], shuffled, _, _ = drive(codec, "host")
        if codec == "identity":
            sd = shuffled

    # 5. kernel == plain, exactly
    max_err = dict.fromkeys(LAUNCHES, 0.0)
    cats = {}
    for codec in CODECS:
        jobs = zone_jobs(codec)
        cat = shuffle_once(jobs[0].partitioner, xyz, codec=codec)
        err = masked_vs_plain(cat, jobs)
        for k in ("pair_count_masked", "pair_hist_masked"):
            max_err[k] = max(max_err[k], err)
        cats[codec] = (cat, jobs)
        emit(phase="masked_vs_plain", codec=codec, tiers=len(cat.sd.tiers),
             max_abs_err=err)
    jobs = zone_jobs("identity")
    err = unmasked_vs_plain(sd, jobs, dev)
    max_err["pair_count"] = max_err["pair_hist"] = err
    payload = int8_payload(xyz, dev)
    max_err["quantize"] = max_err["dequantize"] = quantize_vs_plain(payload)
    emit(phase="unmasked_and_quantize_vs_plain", shape=[list(sd.owned.shape),
         list(sd.bucket.shape)], payload=list(payload.shape),
         max_abs_err=err)

    # 6. exact cross-checks. The engines agree exactly on one zone map: the
    # device engine runs with the host's zone keys. With its own keys
    # (the card's asinf) a few boundary points change zone, and at 60" the
    # f32 threshold admits pairs beyond the replication margin, so the
    # counts may differ by the pairs those points make: reported, not held.
    part = zone_jobs("identity")[0].partitioner
    t0 = time.perf_counter()
    keys_host = part.assign(xyz)
    keys_card = part.assign_device(torch.as_tensor(xyz, device=dev))
    moved = int(np.count_nonzero(keys_host != keys_card.cpu().numpy()))
    assign_s = time.perf_counter() - t0
    own_keys_delta = {}
    for codec in ("identity", "int16"):
        same_keys = outputs(run_jobs(zone_jobs(codec, host_keys=True), xyz))
        if full_host[codec] != same_keys:
            raise AssertionError(f"{codec}: host engine {full_host[codec]} "
                                 f"!= device engine on the host's zone keys "
                                 f"{same_keys}")
        own_keys_delta[codec] = [
            (np.asarray(h) - np.asarray(d)).tolist()
            for h, d in zip(full_host[codec][:-1], full[codec][:-1])]
    emit(phase="host_equals_device", codecs=["identity", "int16"],
         zone_keys_differing=moved, host_assign_s=assign_s,
         search_delta_with_own_keys=own_keys_delta)
    for n, seed, radius, edges, engine, codec in (
            (1_000_000, 1, None, None, "device", "identity"),
            (50_000, 2, 0.02, np.linspace(0.005, 0.02, 8) / sky.ARCSEC,
             "device", "identity"),
            (INT8_CPU_N, 3, None, None, "host", "int8")):
        cpu_xyz = sky.make_catalog(n, seed)
        jobs = zone_jobs(codec, radius=radius, edges_arcsec=edges)
        t0 = time.perf_counter()
        card = outputs(run_jobs(jobs, cpu_xyz, engine=engine))
        t1 = time.perf_counter()
        host = outputs(run_jobs(jobs, cpu_xyz, engine=engine, device="cpu"))
        t2 = time.perf_counter()
        if card != host:
            raise AssertionError(f"card != cpu at n={n} {engine} {codec}: "
                                 f"{card} vs {host}")
        emit(phase="card_equals_cpu", n=n, radius=radius, engine=engine,
             codec=codec, outputs=card, card_s=t1 - t0, cpu_s=t2 - t1)
    toks = np.random.default_rng(args.seed).integers(0, VOCAB, 4_000_000)
    want = np.bincount(toks, minlength=VOCAB)
    for codec in ("identity", "int16"):
        for engine in ("device", "host"):
            t0 = time.perf_counter()
            res = token_histogram(toks, VOCAB, codec=codec, engine=engine)
            wall = time.perf_counter() - t0
            if not np.array_equal(res.output, want):
                raise AssertionError(f"token_histogram {engine} {codec} != "
                                     "np.bincount")
            emit(phase="token_histogram", engine=engine, codec=codec,
                 n_tokens=len(toks), wall_s=wall, stats=stage_summary(res.stats))
    small = sky.make_catalog(4000, 3)
    for engine in ("device", "host"):
        got = run_jobs(zone_jobs("identity", radius=0.05), small,
                       engine=engine)[0].output
        want_bf = sky.brute_force_pairs(small, 0.05)
        if got != want_bf:
            raise AssertionError(f"{engine} search {got} != brute force "
                                 f"{want_bf}")
    emit(phase="brute_force", n=4000, radius=0.05, pairs=got)

    # 7-10. the streaming executor at full width
    t0 = time.perf_counter()
    stream_phases(xyz, args.seed, mono, launches, n_edges)
    emit(phase="stream_phases", seconds=time.perf_counter() - t0)

    # 11. kernel times at the full-width shapes (identity codec)
    cat, jobs = cats["identity"]
    rows = time_kernels(cat, jobs, sd, payload, launches, max_err)
    del cat, jobs, cats, sd, payload
    torch.cuda.empty_cache()

    # 12-14. the LM serving path; 15. the flash kernel against its plain version
    lm, toks = lm_main_path(args.seed, dev, launches)
    rows.append(flash_vs_plain(lm, toks, dev, launches))
    emit(kernels=rows)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
