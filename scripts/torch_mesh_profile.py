"""The port's data-axis mesh phases alone, on every card of the machine.

    python3 scripts/torch_mesh_profile.py [--n 16777216] [--seed 0]

Builds the pair and quantize kernels, runs what ``chip_smoke.py``'s mesh
phases are held to (phase 3: the device engine unsharded, int16 and int8;
phase 4: the host engine's int8 run) on ``make_catalog(n, seed)``, then
those phases themselves (``chip_smoke.mesh_phases``, phases 19-22): a
world of one NCCL rank in this process, ``MESH_WORLD`` gloo ranks (rank r
on card r % count), and, on a machine of 2 or 4 cards, an NCCL world of
one card a rank. Prints ``chip_smoke.py``'s phase lines, then one line
with the seconds and the launches. Needs a CUDA device; imports nothing
of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mesh_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.data import sky
    from repro_torch.kernels import LAUNCHES, _build
    from repro_torch.kernels.quantize import kernel as qkernel
    from repro_torch.kernels.zones_pairs import kernel as zkernel
    from repro_torch.mapreduce import run_jobs

    cs.emit(phase="device", kind=torch.cuda.get_device_name(0),
            count=torch.cuda.device_count(),
            nvidia_smi=cs.nvidia_smi("name,power.limit"),
            torch=torch.__version__)
    _build.build(zkernel.LIBRARY, qkernel.LIBRARY)
    xyz = sky.make_catalog(args.n, args.seed)
    mono = {}
    for codec in ("int16", "int8"):
        jobs = cs.zone_jobs(codec)
        run_jobs(jobs, xyz)                     # warm
        res, wall, _ = cs.counted(lambda: run_jobs(jobs, xyz),
                                  dict.fromkeys(LAUNCHES, 0))
        mono[codec] = (cs.outputs(res), None, wall, res[0].stats)
        cs.emit(phase="main_path_device", codec=codec, wall_s=wall,
                outputs=mono[codec][0])
    full_host = {"int8": cs.outputs(run_jobs(cs.zone_jobs("int8"), xyz,
                                             engine="host"))}
    launches = dict.fromkeys(LAUNCHES, 0)
    n_edges = len(cs.zone_jobs("identity")[-1].reducer.edges_rad)
    t0 = time.perf_counter()
    cs.mesh_phases(xyz, args.seed, mono, full_host, launches, n_edges)
    print(json.dumps({"mesh_phases_s": time.perf_counter() - t0,
                      "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
