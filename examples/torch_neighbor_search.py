"""The paper's applications end-to-end on a synthetic sky catalog, through
the PyTorch port's composable Job API (``repro_torch``): the counterpart of
``examples/neighbor_search.py``, section for section.

Neighbor Searching (data-intensive) + Neighbor Statistics (compute-intensive)
are built from pluggable stages: ``ZonePartitioner`` (map), a registered
``ShuffleCodec`` (shuffle), and pair-kernel reducers (CUDA kernels on the
card, their plain PyTorch versions on the CPU). One engine runs them, and
also batches both apps over a single shuffle. Every run prints its
``StageStats`` and, on the card, the Amdahl number AD priced at the card's
``DeviceSpec`` (the paper's Table-4 analysis; a CPU run has no spec).

The streaming section runs the same job out-of-core: the catalog lives in a
memmap file and crosses the engine split by split (HDFS-block analogues)
with the next split's read and copy to the card double-buffered under the
current split's compute: same answer, bounded memory, and the exposed and
hidden I/O printed from ``StageStats``.

The speculation section injects a straggler (one split's fetch stalls 3x
the clean wall) and shows the lane scheduler recover it: the slow attempt
is cloned onto a free lane, the clone wins, the stalled original is
cancelled: same answer, a fraction of the stall paid.

The last section flips the execution model from batch to SERVICE: the
catalog is shuffled once into a resident ``ResidentCatalog`` and a stream
of small queries goes through ``MRQueryService``'s submit queue
(micro-batched, coalesced, each answered by a pure fused reduce) with qps,
p50 and p99 from the per-request ``RequestStats``.

    PYTHONPATH=src python examples/torch_neighbor_search.py [--n 50000]
        [--radius 0.02] [--device cpu]

Runs on the card unless ``--device cpu``. The last line printed is a JSON
object of every count the run printed (``main`` returns it).
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.data import ArraySplits, MemmapCatalogSplits, sky  # noqa: E402
from repro_torch.ft import FaultySplitSource, SpeculativeConfig  # noqa: E402
from repro_torch.mapreduce import (ZonePartitioner,  # noqa: E402
                                   available_codecs, neighbor_search_job,
                                   neighbor_statistics_job, run_job,
                                   run_job_streaming, run_jobs)
from repro_torch.serving import MRQueryService  # noqa: E402


def show(res, label):
    st = res.stats
    ad = (f"{st.roofline().amdahl_numbers()['AD']:.2g}"
          if st.device.startswith("cuda") else "n/a (no spec off the card)")
    print(f"  {label}: {st.wall_s:.2f}s "
          f"(map {st.map_wall_s:.2f} / shuffle {st.shuffle_wall_s:.2f} "
          f"/ reduce {st.reduce_wall_s:.2f}; dominant={st.dominant_stage}) "
          f"shuffle={st.shuffle_wire_bytes / 1e6:.1f}MB "
          f"x{st.compression_ratio:.1f} AD={ad}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--radius", type=float, default=0.02)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card")
    args = ap.parse_args(argv)
    dev = args.device
    counts = {"n": args.n, "radius": args.radius}

    print(f"== synthetic catalog: {args.n} objects ==")
    xyz = sky.make_catalog(args.n, seed=0)

    print("-- Neighbor Searching (radius sweep, cf. paper Table 3) --")
    counts["radius_sweep"] = sweep = []
    for radius in (args.radius / 2, args.radius, args.radius * 2):
        res = run_job(neighbor_search_job(radius, tile=256), xyz, device=dev)
        sweep.append([radius, res.output])
        print(f"  radius={radius:.3f} rad: {res.output} pairs in "
              f"{res.stats.wall_s:.2f}s")

    print(f"-- stage swaps (cf. Figure 3; codecs: {available_codecs()}) --")
    counts["stage_swaps"] = swaps = {}
    for label, kw in {
        "baseline": dict(tile=64),
        "batched (buffering analogue)": dict(tile=512),
        "int16 shuffle (LZO analogue)": dict(tile=512, codec="int16"),
        # int8's ~1/127 coordinate step is coarse for radii this small: max
        # compression, visible count error: the LZO trade taken too far
        "int8 shuffle (block-quantized)": dict(tile=512, codec="int8"),
    }.items():
        res = run_job(neighbor_search_job(args.radius, **kw), xyz, device=dev)
        swaps[label] = res.output
        show(res, f"{label}: pairs={res.output}")

    print("-- both apps batched over ONE shuffle (cf. paper section 2.2) --")
    edges = np.linspace(args.radius / 8, args.radius, 8)
    part = ZonePartitioner(args.radius)
    search, stats = run_jobs(
        [neighbor_search_job(args.radius, partitioner=part, tile=256),
         neighbor_statistics_job(edges / sky.ARCSEC, partitioner=part,
                                 tile=256)], xyz, device=dev)
    counts["batched"] = {"pairs": search.output,
                         "histogram": stats.output.tolist()}
    print(f"  pairs={search.output}, histogram={stats.output.tolist()}")
    show(search, "batched search+stats")

    print("-- out-of-core: the same job streamed from a memmap catalog --")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "catalog.f32")
        MemmapCatalogSplits.write(path, xyz)        # stand-in for a big file
        src = MemmapCatalogSplits(path, d=3,
                                  rows_per_split=max(args.n // 8, 1))
        res = run_job_streaming(
            neighbor_search_job(args.radius, codec="int16", tile=256), src,
            device=dev)
        st = res.stats
        counts["streamed"] = res.output
        print(f"  pairs={res.output} over {st.n_splits} splits "
              f"(per-split rows<={src.rows_per_split}); split I/O: "
              f"{st.overlap_hidden_s:.3f}s hidden under compute, "
              f"{st.fetch_wall_s:.3f}s exposed "
              f"(overlap={st.overlap_fraction:.0%})")

    print("-- speculative re-execution: an injected straggler recovered --")
    clean = run_job_streaming(
        neighbor_search_job(args.radius, codec="int16", tile=256),
        ArraySplits(xyz, 8), n_lanes=4, device=dev)
    t_clean = clean.stats.elapsed_s
    # split 0's first fetch stalls 3x the clean wall (a dying-disk analogue);
    # the policy clones it onto a free lane, the clone's fast re-fetch wins,
    # and the stalled original is cancelled mid-sleep
    slow = FaultySplitSource(ArraySplits(xyz, 8), delays={0: 3.0 * t_clean})
    spec = run_job_streaming(
        neighbor_search_job(args.radius, codec="int16", tile=256), slow,
        n_lanes=4, speculate=SpeculativeConfig(slowdown=1.5, min_finished=2),
        device=dev)
    st = spec.stats
    counts["speculation"] = {"clean": clean.output, "straggler": spec.output,
                             "speculated": st.speculated,
                             "clone_wins": st.clone_wins}
    print(f"  clean: {t_clean:.2f}s on {clean.stats.n_lanes} lanes; "
          f"straggler(+{3.0 * t_clean:.2f}s) with speculation: "
          f"{st.elapsed_s:.2f}s ({st.elapsed_s / t_clean:.2f}x clean; "
          f"speculated={st.speculated}, clone_wins={st.clone_wins})")
    if spec.output != clean.output:         # recovery is bit-identical
        raise AssertionError(f"speculated {spec.output} != clean "
                             f"{clean.output}")

    print("-- service mode: resident catalog, micro-batched queries --")
    svc = MRQueryService(max_batch=8, max_wait_s=0.002, device=dev)
    cat = svc.load_catalog("sky", xyz, part, codec="int16", tile=256)
    print(f"  shuffled once: {cat.nbytes / 1e6:.1f}MB resident wire bytes, "
          f"{cat.P} partitions")
    with svc:                    # background admission/serving thread
        reqs = [svc.submit(neighbor_search_job(r, partitioner=part,
                                               codec="int16", tile=256),
                           catalog="sky")
                for r in (args.radius, args.radius / 2) * 4]
        outs = [r.result(timeout=600) for r in reqs]
    s = svc.latency_summary()
    counts["service"] = outs
    print(f"  {s['n']} queries at {s['qps']:.0f} qps "
          f"(p50 {s['p50_ms']:.1f}ms / p99 {s['p99_ms']:.1f}ms, "
          f"mean batch {s['mean_batch']:.1f}); "
          f"pairs@radius={outs[0]}, pairs@radius/2={outs[1]}")
    return counts


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
