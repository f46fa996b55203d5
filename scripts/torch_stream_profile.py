"""Profile the port's streaming executor on the card: prefetch and lanes.

    python3 scripts/torch_stream_profile.py [--n 16777216] [--rows 1048576]
        [--lanes 4] [--seed 0] [--trace-dir build/traces]

Writes ``make_catalog(n, seed)`` to a temporary memmap file and streams it
back in splits of ``rows`` rows through ``run_jobs_streaming`` (int16,
search at 15/30/60" plus statistics, ``ZonePartitioner(60")``): once
sequentially with prefetch 2 and once over ``lanes`` lanes. Each run is
done twice without the profiler (the first warms streams and allocator
pools) and once under ``torch.profiler`` (CPU and CUDA activities). For
each it prints one JSON line: the host walls, the ``StageStats`` walls and
overlap, the per-split medians of fetch (prep and wait) and map, and from
the profiled run's Chrome trace the device time of kernels and of
host-to-device copies per stream, the union of busy device time (idle
share = 1 - union / wall), the copy time that ran while a kernel ran on
another stream, and the CUDA runtime calls (``cudaMalloc``,
``cudaStreamSynchronize``, ``cudaMemcpyAsync``, ...) by host time and
thread. Needs a CUDA device; imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _overlap(copies, kernels) -> float:
    """Copy time that ran while at least one kernel ran (any stream)."""
    busy = sorted(kernels)
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = 0.0
    for a, b in copies:
        for c, d in merged:
            if d <= a:
                continue
            if c >= b:
                break
            total += min(b, d) - max(a, c)
    return total


def trace_summary(path: Path, wall_s: float) -> dict:
    events = json.loads(path.read_text())["traceEvents"]
    kernels, copies, by_stream, api = [], [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, dur = e.get("cat", ""), float(e.get("dur", 0.0))
        span = (float(e["ts"]), float(e["ts"]) + dur)
        if cat == "kernel" or cat == "gpu_memcpy":
            stream = str(e.get("args", {}).get("stream", "?"))
            rec = by_stream.setdefault(stream, {"kernel_ms": 0.0,
                                                "copy_ms": 0.0,
                                                "kernels": 0, "copies": 0})
            if cat == "kernel":
                kernels.append(span)
                rec["kernel_ms"] += dur / 1e3
                rec["kernels"] += 1
            else:
                copies.append(span)
                rec["copy_ms"] += dur / 1e3
                rec["copies"] += 1
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            key = (e.get("name", "?"), e.get("tid", "?"))
            n, ms = api.get(key, (0, 0.0))
            api[key] = (n + 1, ms + dur / 1e3)
    busy_s = _union(kernels + copies) / 1e6
    top_api = sorted(api.items(), key=lambda kv: kv[1][1], reverse=True)
    return {"device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall_s,
            "kernel_ms": sum(b - a for a, b in kernels) / 1e3,
            "copy_ms": sum(b - a for a, b in copies) / 1e3,
            "copy_under_kernel_ms": _overlap(copies, kernels) / 1e3,
            "streams": by_stream,
            "cuda_api_ms": [(name, tid, n, ms)
                            for (name, tid), (n, ms) in top_api[:12]]}


def split_medians(stats) -> dict:
    return {k: statistics.median(r[k] for r in stats.splits)
            for k in ("fetch_prep_s", "fetch_wait_s", "map_s", "wall_s")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default="build/traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_stream_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.data import MemmapCatalogSplits, sky
    from repro_torch.mapreduce import run_jobs_streaming

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi("name,power.limit"),
                      "torch": torch.__version__}), flush=True)
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    xyz = sky.make_catalog(args.n, args.seed)
    jobs = chip_smoke.zone_jobs("int16")
    with tempfile.TemporaryDirectory(prefix="stream-profile-") as tmp:
        path = str(Path(tmp) / "catalog.f32")
        MemmapCatalogSplits.write(path, xyz)
        src = MemmapCatalogSplits(path, d=3, rows_per_split=args.rows)
        for name, kw in (("sequential", {"prefetch": 2}),
                         ("lanes", {"n_lanes": args.lanes})):
            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run_jobs_streaming(jobs, src, **kw)
                torch.cuda.synchronize()
                return res, time.perf_counter() - t0

            plain = [run()[1] for _ in range(2)]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                res, wall = run()
            trace = trace_dir / f"stream_profile_{name}.json"
            prof.export_chrome_trace(str(trace))
            st = res[0].stats
            print(json.dumps({
                "run": name, **kw, "n": args.n, "rows_per_split": args.rows,
                "host_wall_unprofiled_s": plain, "host_wall_profiled_s": wall,
                "stats": {k: getattr(st, k) for k in (
                    "wall_s", "elapsed_s", "map_wall_s", "shuffle_wall_s",
                    "reduce_wall_s", "fetch_wall_s", "overlap_hidden_s",
                    "overlap_fraction", "lane_walls")},
                "split_median_s": split_medians(st),
                **trace_summary(trace, wall)}, default=float), flush=True)
            trace.unlink()                   # tens of MB: keep the summary
    return 0


if __name__ == "__main__":
    sys.exit(main())
