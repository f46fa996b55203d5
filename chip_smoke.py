"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--n 16777216] [--seed 0]

Phases (any failure exits non-zero before the last line is printed):

1. card identity (``torch.cuda.get_device_name``, ``nvidia-smi``);
2. build both zones pair kernels from ``src/repro_torch/.../csrc``;
3. the full-width main path: ``run_jobs`` of Neighbor Searching at 15", 30"
   and 60" plus Neighbor Statistics (edges 1..60") over one shuffle of a
   ``make_catalog(n, seed)`` sky with ``ZonePartitioner(60")``, for the
   identity, int16 and int8 codecs; every launch counter is reset just
   before and read just after, and must equal tiers x reducers;
4. each kernel against its plain PyTorch version, exactly, on sampled
   partitions (first 4, last 4, fullest) of every tier of every codec;
5. exact cross-checks: search(r) equals the Neighbor Statistics cumulative
   count at edge r; the card equals the CPU (plain versions) at 1M objects
   and 60", and at 50k objects and 0.02 rad; small-n search equals the
   brute-force count;
6. kernel times (CUDA events, median of 5) at the full-width tier shapes
   beside the plain version's time and the operation bound.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit; the one before that the kernel table.
Imports nothing of ``jax`` or ``repro``.
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

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEARCH_ARCSEC = (15, 30, 60)
CODECS = ("identity", "int16", "int8")
FP32_OPS_PER_CELL = 5          # 3 FMUL + 2 FADD, no FMA (see the .cu note)


def emit(**kw) -> None:
    print(json.dumps(kw, default=float), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def zone_jobs(codec: str, tile: int = 256, radius=None, edges_arcsec=None):
    """Search at each radius of SEARCH_ARCSEC (or at ``radius``) plus
    statistics, batched over one ZonePartitioner."""
    from repro_torch.data.sky import ARCSEC
    from repro_torch.mapreduce import (ZonePartitioner, neighbor_search_job,
                                       neighbor_statistics_job)
    if radius is None:
        radii = [a * ARCSEC for a in SEARCH_ARCSEC]
        part = ZonePartitioner(radii[-1])
    else:
        radii = [radius]
        part = ZonePartitioner(radius)
    jobs = [neighbor_search_job(r, partitioner=part, codec=codec, tile=tile)
            for r in radii]
    jobs.append(neighbor_statistics_job(edges_arcsec, partitioner=part,
                                        codec=codec, tile=tile))
    return jobs


def outputs(results):
    return [r.output if isinstance(r.output, int) else
            np.asarray(r.output).tolist() for r in results]


def check_outputs(results, n_edges: int) -> None:
    *search, stats = results
    for r in search:
        if not isinstance(r.output, int):
            raise AssertionError(f"search output {r.output!r} is not an int")
    hist = np.asarray(stats.output)
    if hist.shape != (n_edges,) or hist.dtype.kind != "i":
        raise AssertionError(f"stats output {hist.shape} {hist.dtype}")


def sample_rows(n_owned: torch.Tensor) -> torch.Tensor:
    """First 4, last 4 and the fullest partition rows of a tier."""
    Pt = n_owned.shape[0]
    idx = set(range(min(4, Pt))) | set(range(max(0, Pt - 4), Pt))
    idx.add(int(torch.argmax(n_owned)))
    return torch.tensor(sorted(idx), device=n_owned.device)


def kernel_vs_plain(cat, jobs) -> float:
    """Both kernels against their plain versions on sampled rows of every
    tier; integers must be equal. -> max absolute error (0)."""
    from repro_torch.kernels.zones_pairs import kernel, ref
    *search, stats = jobs
    worst = 0
    for t, tier in enumerate(cat.sd.tiers):
        rows = sample_rows(tier.n_owned)
        a = cat.codec.decode_device(*(w[rows] for w in tier.owned_wire))
        b = cat.codec.decode_device(*(w[rows] for w in tier.bucket_wire))
        a, b = a.contiguous(), b.contiguous()
        na, nb = tier.n_owned[rows].contiguous(), tier.n_bucket[rows].contiguous()
        for j in search:
            cmin = j.reducer.cos_min()
            got = int(kernel.pair_count_masked_cuda(a, b, na, nb, cmin))
            want = int(ref.pair_count_masked_ref(a, b, na, nb, cmin))
            worst = max(worst, abs(got - want))
            if got != want:
                raise AssertionError(f"tier {t} count kernel {got} != plain "
                                     f"{want} at r={j.reducer.radius}")
        edges = stats.reducer.cos_edges().to(a.device)
        got = kernel.pair_hist_masked_cuda(a, b, na, nb, edges).cpu()
        want = ref.pair_hist_masked_ref(a, b, na, nb, edges).cpu()
        worst = max(worst, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"tier {t} hist kernel != plain: "
                                 f"{got.tolist()} vs {want.tolist()}")
    return float(worst)


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


def time_kernels(cat, jobs, launches: dict, max_err: float) -> list:
    """Time each kernel over every tier of the full-width catalog (one
    reducer's whole reduce), beside its plain version and its bound."""
    from repro_torch.kernels.zones_pairs import kernel, ref
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
    bound_ms = FP32_OPS_PER_CELL * real_cells / (lanes * clock_hz) * 1e3
    cmin = jobs[-2].reducer.cos_min()                     # 60" search
    edges = jobs[-1].reducer.cos_edges().cuda()

    def run(fn, *arg):
        return lambda: [fn(a, b, na, nb, *arg) for a, b, na, nb in tiers]

    rows = []
    for name, kern, plain, arg in (
            ("pair_count_masked", kernel.pair_count_masked_cuda,
             ref.pair_count_masked_ref, cmin),
            ("pair_hist_masked", kernel.pair_hist_masked_cuda,
             ref.pair_hist_masked_ref, edges)):
        ms = cuda_ms(run(kern, arg))
        plain_ms = cuda_ms(run(plain, arg), reps=3)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/zones_pairs/csrc/zones_pairs.cu",
            "replaces": ("src/repro/kernels/zones_pairs/kernel.py:167"
                         if name == "pair_count_masked" else
                         "src/repro/kernels/zones_pairs/kernel.py:192"),
            "launches": launches[name], "max_abs_err": max_err,
            "match_plain": max_err == 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None,
            "real_cells": real_cells, "sm_clock_hz": clock_hz,
        })
    return rows


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
    from repro_torch.kernels.zones_pairs import kernel
    from repro_torch.mapreduce import run_jobs, shuffle_once

    # 1. card identity
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    path = kernel.build()
    ptxas = [ln.strip() for ln in kernel.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0, library=str(path),
         ptxas=ptxas)

    # 3. full-width main path, per codec
    t0 = time.perf_counter()
    xyz = sky.make_catalog(args.n, args.seed)
    emit(phase="catalog", n=args.n, seed=args.seed,
         seconds=time.perf_counter() - t0)
    full = {}
    launches = dict.fromkeys(kernel.LAUNCHES, 0)
    for codec in CODECS:
        jobs = zone_jobs(codec)
        kernel.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_jobs(jobs, xyz)
        wall = time.perf_counter() - t0
        counts = dict(kernel.LAUNCHES)
        st = res[0].stats
        n_tiers = len(st.tiers)
        want = {"pair_count_masked": n_tiers * (len(jobs) - 1),
                "pair_hist_masked": n_tiers}
        if counts != want:
            raise AssertionError(f"{codec}: launches {counts} != {want}")
        for k in launches:
            launches[k] += counts[k]
        check_outputs(res, 60)
        full[codec] = res
        emit(phase="main_path", codec=codec, wall_s=wall, launches=counts,
             tiers=st.tiers, outputs=outputs(res),
             stats={k: v for k, v in st.to_dict().items()
                    if k.endswith(("_s", "_bytes", "_ratio", "flops"))
                    or k in ("n_items", "n_partitions", "device")})

    # 4. kernel == plain, exactly, on sampled partitions of every tier
    max_err = 0.0
    cats = {}
    for codec in CODECS:
        jobs = zone_jobs(codec)
        cat = shuffle_once(jobs[0].partitioner, xyz, codec=codec)
        max_err = max(max_err, kernel_vs_plain(cat, jobs))
        cats[codec] = (cat, jobs)
        emit(phase="kernel_vs_plain", codec=codec, tiers=len(cat.sd.tiers),
             max_abs_err=max_err)

    # 5. exact cross-checks
    for codec, res in full.items():
        *search, stats = res
        cum = np.cumsum(stats.output)
        for r, arcsec in zip(search, SEARCH_ARCSEC):
            if r.output != int(cum[arcsec - 1]):
                raise AssertionError(f"{codec}: search({arcsec}\") "
                                     f"{r.output} != stats cum "
                                     f"{int(cum[arcsec - 1])}")
    emit(phase="search_equals_stats", radii_arcsec=SEARCH_ARCSEC)
    for n, seed, radius, edges in (
            (1_000_000, 1, None, None),
            (50_000, 2, 0.02, np.linspace(0.005, 0.02, 8) / sky.ARCSEC)):
        cpu_xyz = sky.make_catalog(n, seed)
        jobs = zone_jobs("identity", radius=radius, edges_arcsec=edges)
        t0 = time.perf_counter()
        card = outputs(run_jobs(jobs, cpu_xyz))
        t1 = time.perf_counter()
        host = outputs(run_jobs(jobs, cpu_xyz, device="cpu"))
        t2 = time.perf_counter()
        if card != host:
            raise AssertionError(f"card != cpu at n={n}: {card} vs {host}")
        emit(phase="card_equals_cpu", n=n, radius=radius, outputs=card,
             card_s=t1 - t0, cpu_s=t2 - t1)
    small = sky.make_catalog(4000, 3)
    got = run_jobs(zone_jobs("identity", radius=0.05), small)[0].output
    want = sky.brute_force_pairs(small, 0.05)
    if got != want:
        raise AssertionError(f"search {got} != brute force {want}")
    emit(phase="brute_force", n=4000, radius=0.05, pairs=got)

    # 6. kernel times at the full-width tier shapes (identity codec)
    cat, jobs = cats["identity"]
    rows = time_kernels(cat, jobs, launches, max_err)
    emit(kernels=rows)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
