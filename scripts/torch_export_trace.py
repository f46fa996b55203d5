#!/usr/bin/env python
"""Run the port's traced lane-mode streaming job and export its Chrome trace.

The port of ``scripts/export_trace.py``: a lane-mode streaming run
(3 concurrent lanes, prefetch 2, 8 splits) of Neighbor Searching recorded
by ``repro_torch.obs.Tracer`` and saved as Chrome trace-event JSON (load it
in Perfetto or chrome://tracing for the map/shuffle/reduce stage spans,
the fetch-wait stalls and each lane's execution with its split and
attempt ids).

    PYTHONPATH=src python scripts/torch_export_trace.py [out.json]
        [--device cpu]

Runs on the card unless ``--device cpu``; the card's run is metered by
``NvmlMeter`` (the card's energy counter, which must be readable), the
CPU's by ``ModeledMeter``. Checks before it writes, in the reference's
order: the streamed output equals the monolithic ``run_job``'s, every
opened span closed, and the export parses as JSON and holds the span
families of ``REQUIRED_SPANS``; then prints the per-span summary and the
run's wall, joules and rows per joule. Imports nothing of ``jax`` or
``repro``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
from repro_torch.data import sky  # noqa: E402
from repro_torch.data.pipeline import ArraySplits  # noqa: E402
from repro_torch.mapreduce import (neighbor_search_job, run_job,  # noqa: E402
                                   run_job_streaming)
from repro_torch.obs import (ModeledMeter, NvmlMeter, Tracer,  # noqa: E402
                             use_meter, use_tracer)

REQUIRED_SPANS = {"map", "shuffle", "reduce", "fetch-wait", "lane-exec",
                  "job"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="trace.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else args.device
    if device is None:
        meter = NvmlMeter()
        if not meter.available:
            raise RuntimeError("NVML's energy counter is not readable: the "
                               "card's run needs it (--device cpu models "
                               "the joules)")
    else:
        meter = ModeledMeter()
    xyz = sky.make_catalog(6000, 0)
    job = neighbor_search_job(0.02, codec="int16", tile=128)
    want = run_job(job, xyz, device=device)  # monolithic oracle + warm-up
    with use_tracer(Tracer()) as tr, use_meter(meter):
        res = run_job_streaming(job, ArraySplits(xyz, n_splits=8),
                                n_lanes=3, prefetch=2, device=device)
    if res.output != want.output:
        raise AssertionError(f"streamed {res.output} != monolithic "
                             f"{want.output}")
    if tr.open_spans != 0:
        raise AssertionError(f"{tr.open_spans} spans left open")

    doc = json.loads(tr.export_json())          # round-trips as valid JSON
    names = {e["name"] for e in doc["traceEvents"]}
    missing = REQUIRED_SPANS - names
    if missing:
        raise AssertionError(f"span families missing from trace: {missing}")

    path = tr.save(args.out)
    st = res.stats
    print(tr.summary())
    print(f"\n{len(doc['traceEvents'])} events "
          f"({len(names)} span names) -> {path}")
    print(f"run: {st.n_splits} splits, wall={st.wall_s * 1e3:.1f} ms, "
          f"energy={st.energy_j:.2f} J ({st.energy_source}), "
          f"{st.rows_per_joule:.0f} rows/J")
    return 0


if __name__ == "__main__":
    sys.exit(main())
