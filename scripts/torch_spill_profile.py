"""Where the port's spill writes spend their time, on the card's host.

    python3 scripts/torch_spill_profile.py [--n 16777216] [--rows 1048576]
        [--chunk 3] [--ranges 10 256] [--codec int16] [--seed 0]
        [--dir DIR]

Maps the first ``chunk`` splits of ``rows`` rows of ``make_catalog(n,
seed)`` on the card (``ZonePartitioner(60")``, the codec's wire) and brings
them to the host as ``chip_smoke.py``'s spilled runs do. For each range
count it plans byte-weighted bounds as the executor's first flush does,
then times, range by range, the segment cut (``spill._range_selections``:
which rows and entries a range needs) and the whole ``_write_segment``
(cut, copies and file writes); the difference is the copies and the
writes. Then the read-back of every range (``SpillStore.read_range``), and
the same bytes written and read as one plain file: the disk's own rates
through the page cache. One JSON line per range count and one for the
disk. Needs a CUDA device (``--device cpu`` for a rehearsal); imports
nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--chunk", type=int, default=3)
    ap.add_argument("--ranges", type=int, nargs="+", default=[10, 256])
    ap.add_argument("--codec", default="int16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.core.device import resolve_device
    from repro_torch.data.sky import ARCSEC, make_catalog
    from repro_torch.mapreduce import (ZonePartitioner, get_codec,
                                       map_split_device)
    from repro_torch.mapreduce.spill import (SpillStore, _range_selections,
                                             _write_segment, mapped_to_host,
                                             mapped_wire_nbytes, plan_bounds)

    dev = resolve_device(args.device)
    xyz = make_catalog(args.n, args.seed)
    part = ZonePartitioner(60 * ARCSEC)
    P = int(part.n_partitions(xyz))
    codec = get_codec(args.codec)
    recs = []
    for k in range(args.chunk):
        rows = torch.as_tensor(xyz[k * args.rows:(k + 1) * args.rows],
                               device=dev)
        recs.append(mapped_to_host(map_split_device(part, codec, rows, P,
                                                    dev)))
    wire = sum(mapped_wire_nbytes(m) for m in recs)
    w = np.zeros(P, np.float64)
    for m in recs:
        w += np.bincount(m.dest_eff, minlength=P + 1)[:P]
    root = tempfile.mkdtemp(prefix="spill-profile-", dir=args.dir)
    try:
        for Z in args.ranges:
            bounds = plan_bounds(w, Z)
            cut_s, write_s, nbytes = [], [], 0
            for z in range(len(bounds) - 1):
                lo, hi = int(bounds[z]), int(bounds[z + 1])
                t0 = time.perf_counter()
                _range_selections(recs, lo, hi)
                t1 = time.perf_counter()
                nbytes += _write_segment(
                    os.path.join(root, f"z{Z}-{z}.seg"), recs, lo, hi)
                t2 = time.perf_counter()
                cut_s.append(t1 - t0)
                write_s.append((t2 - t1) - (t1 - t0))
            store = SpillStore(os.path.join(root, f"store{Z}"), P)
            store.set_bounds(bounds)
            t0 = time.perf_counter()
            store.commit_chunk(store.stage_chunk(recs, "p"))
            stage_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            read_bytes = 0
            for z in range(store.n_ranges):
                rec = store.read_range(z)
                read_bytes += sum(a.nbytes for a in rec["payloads"])
            read_s = time.perf_counter() - t0
            store.close()
            print(json.dumps({
                "phase": "spill_write", "codec": args.codec, "ranges":
                len(bounds) - 1, "splits": args.chunk, "rows": args.rows,
                "wire_bytes": wire, "segment_bytes": nbytes,
                "cut_s": sum(cut_s), "copy_and_write_s": sum(write_s),
                "cut_s_per_range_median": float(np.median(cut_s)),
                "stage_chunk_s": stage_s, "read_back_s": read_s,
                "read_back_payload_bytes": read_bytes}), flush=True)
        blob = np.random.default_rng(args.seed).integers(
            0, 255, wire, dtype=np.uint8).tobytes()
        path = os.path.join(root, "plain.bin")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(blob)
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            back = f.read()
        t2 = time.perf_counter()
        if back != blob:
            raise RuntimeError("the plain file read back differs")
        print(json.dumps({"phase": "disk", "bytes": len(blob),
                          "write_s": t1 - t0, "read_s": t2 - t1,
                          "write_gb_s": len(blob) / (t1 - t0) / 1e9,
                          "read_gb_s": len(blob) / (t2 - t1) / 1e9}),
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
