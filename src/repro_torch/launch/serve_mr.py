"""MapReduce query-service driver: resident catalog + online query stream.

    python -m repro_torch.launch.serve_mr [--n 20000] [--requests 64]
        [--qps 0] [--max-batch 16] [--lanes 1] [--device cuda]

Loads a sky catalog (``make_catalog(n, seed)``) once into the service (one
shuffle, tiers resident on the device), then offers a stream of small
neighbor-search / statistics queries through the admission window and
prints ``latency_summary`` (qps, p50, p99). ``--qps 0`` runs a closed-loop
burst (capacity); a positive value paces arrivals at that offered load
(latency under load). Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.data import sky
from repro_torch.mapreduce import (ZonePartitioner, neighbor_search_job,
                                   neighbor_statistics_job)
from repro_torch.serving.mr_service import MRQueryService


def query_mix(radius: float, partitioner, codec, tile):
    """The service's standing query menu: three search radii + one stats
    histogram, all <= the catalog partitioner's radius so every query is
    answerable from the one resident shuffle."""
    edges = np.linspace(radius / 4, radius, 4)
    return [
        neighbor_search_job(radius, partitioner=partitioner, codec=codec,
                            tile=tile),
        neighbor_search_job(radius / 2, partitioner=partitioner, codec=codec,
                            tile=tile),
        neighbor_search_job(radius / 4, partitioner=partitioner, codec=codec,
                            tile=tile),
        neighbor_statistics_job(edges / sky.ARCSEC, partitioner=partitioner,
                                codec=codec, tile=tile),
    ]


def offer(svc: MRQueryService, jobs, n: int, qps: float, catalog: str):
    """Submit ``n`` requests cycling through ``jobs``, paced at ``qps``
    (0: all at once), to a started service. -> the requests."""
    gap = 1.0 / qps if qps > 0 else 0.0
    t0 = time.perf_counter()
    reqs = []
    for i in range(n):
        if gap:
            wait = t0 + i * gap - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        reqs.append(svc.submit(jobs[i % len(jobs)], catalog=catalog))
    return reqs


def _tile(s: str):
    return s if s == "auto" else int(s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000, help="catalog rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--radius", type=float, default=0.02)
    ap.add_argument("--codec", default="int16")
    ap.add_argument("--tile", type=_tile, default=256)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="offered load; 0 = closed-loop burst")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    xyz = sky.make_catalog(args.n, args.seed)
    part = ZonePartitioner(args.radius)
    svc = MRQueryService(device=args.device, max_batch=args.max_batch,
                         max_wait_s=args.max_wait_ms * 1e-3,
                         n_lanes=args.lanes)
    t0 = time.perf_counter()
    cat = svc.load_catalog("sky", xyz, part, codec=args.codec,
                           tile=args.tile)
    print(f"[serve_mr] catalog: {args.n} rows -> {cat.P} partitions, "
          f"{cat.nbytes / 1e6:.1f} MB resident wire bytes on {svc.device}, "
          f"shuffled once in {time.perf_counter() - t0:.2f}s")

    mix = query_mix(args.radius, part, args.codec, args.tile)
    # one warm batch so the measured stream reflects steady state
    for j in mix:
        svc.submit(j, catalog="sky")
    svc.run_pending()
    svc.request_stats.clear()
    svc.batches.clear()

    with svc:
        reqs = offer(svc, mix, args.requests, args.qps, "sky")
        outs = [r.result(timeout=600) for r in reqs]
    assert len(outs) == args.requests

    s = svc.latency_summary()
    load = f"{args.qps:.0f} qps offered" if args.qps > 0 else "closed loop"
    print(f"[serve_mr] {s['n']} queries ({load}): {s['qps']:.1f} qps served, "
          f"p50 {s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms, "
          f"queue-wait p99 {s['wait_p99_ms']:.1f} ms, "
          f"mean batch {s['mean_batch']:.1f} "
          f"({len(svc.batches)} micro-batches)")
    print(json.dumps(s))
    return svc, s


if __name__ == "__main__":
    main()
