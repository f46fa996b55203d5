"""The port's data-axis mesh phases and its lanes across cards alone, on
every card of the machine.

    python3 scripts/torch_mesh_profile.py [--n 16777216] [--seed 0] [--repeat 5]
                                          [--only service]

Builds the pair and quantize kernels, runs what ``chip_smoke.py``'s mesh
phases are held to (phase 3: the device engine unsharded, int16 and int8;
phase 4: the host engine's int8 run; phase 18: the service's 4-query mix,
one ``run_jobs`` a query) on ``make_catalog(n, seed)``, then those phases
themselves (``chip_smoke.mesh_phases``, phases 19-22 with
``mesh_service``): a world of one NCCL rank in this process,
``MESH_WORLD`` gloo ranks (rank r on card r % count), and, on a machine of
2 or 4 cards, an NCCL world of one card a rank. Then ``lanes_cards``
(``chip_smoke.lanes_cards_phase``) over 16 memmap splits of the catalog
and 64M wordcount tokens, beside ``stream_lanes``'s 4 lanes on the first
card alone, each timed warm (one untimed run of each side first), the two
sides taking turns ``--repeat`` times (one card first, then the cards
first, ...). Prints ``chip_smoke.py``'s phase lines, one line of every
wall with the median, least and most of each and the ratio of the
medians, then one line with the seconds and the launches. ``--only
service`` runs ``mesh_service`` alone, ``--repeat`` times in one world of
``MESH_WORLD`` gloo ranks, each turn held to phase 18 (for an A/B of two
trees in one call). Needs a CUDA device; imports nothing of ``jax`` or
``repro``.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def lanes(cs, xyz, seed: int, mono: dict, launches: dict, n_edges: int,
          repeat: int) -> None:
    """``stream_lanes``'s 4 lanes on the first card against ``lanes_cards``
    over every card, on the same splits and tokens, taking turns
    ``repeat`` times."""
    from repro_torch.data.pipeline import (MemmapCatalogSplits, MemmapTokens,
                                           TokenBlockSplits)
    from repro_torch.mapreduce import run_jobs_streaming, token_histogram_job
    with tempfile.TemporaryDirectory(prefix="mesh-profile-") as tmp:
        path = str(Path(tmp) / "catalog.f32")
        MemmapCatalogSplits.write(path, xyz)
        src = MemmapCatalogSplits(path, d=xyz.shape[1],
                                  rows_per_split=cs.STREAM_ROWS)
        toks = np.random.default_rng(seed).integers(0, cs.VOCAB, cs.WC_TOKENS,
                                                    dtype=np.int32)
        tpath = str(Path(tmp) / "tokens.i32")
        MemmapTokens.write(tpath, toks)
        want_counts = np.bincount(toks, minlength=cs.VOCAB)
        del toks
        tsrc = TokenBlockSplits(MemmapTokens(tpath, cs.WC_SEQ), cs.WC_SEQ,
                                rows_per_split=cs.WC_TOKENS // cs.WC_SEQ // 16,
                                n_splits=16)
        jobs = cs.zone_jobs("int16")
        _, _, seq = cs.counted(lambda: run_jobs_streaming(jobs, src),
                               launches)

        def one_card() -> dict:
            one = {}
            res, one["stream_lanes"], _ = cs.counted(
                lambda: run_jobs_streaming(jobs, src, n_lanes=4,
                                           device="cuda:0"), launches, seq)
            cs.same_outputs("4 lanes on one card", res, mono["int16"][0],
                            n_edges)
            res, one["wordcount"], _ = cs.counted(
                lambda: run_jobs_streaming([token_histogram_job(cs.VOCAB)],
                                           tsrc, n_lanes=4, device="cuda:0"),
                launches)
            if not np.array_equal(res[0].output, want_counts):
                raise AssertionError("4 lanes on one card: wordcount != "
                                     "np.bincount")
            return one

        # every card's first stages are cold (its context, its kernels'
        # first load, its allocator's pools): one untimed run of each side
        for n_lanes, device in ((4, "cuda:0"),
                                (2 * torch.cuda.device_count(), None)):
            run_jobs_streaming(jobs, src, n_lanes=n_lanes, device=device)
            run_jobs_streaming([token_histogram_job(cs.VOCAB)], tsrc,
                               n_lanes=n_lanes, device=device)
        walls = {"one_card_4_lanes_s": [], "across_cards_s": []}
        for i in range(repeat):
            for side in ((0, 1) if i % 2 == 0 else (1, 0)):
                if side == 0:
                    walls["one_card_4_lanes_s"].append(one_card())
                else:
                    walls["across_cards_s"].append(cs.lanes_cards_phase(
                        src, tsrc, want_counts, mono, launches, n_edges, seq))
        spread = {f"{side}.{run}": {
            "median": float(np.median(ts)), "min": min(ts), "max": max(ts)}
            for side, reps in walls.items() if reps and reps[0]
            for run in reps[0] for ts in [[r[run] for r in reps]]}
        ratio = {}
        if walls["across_cards_s"][0]:
            for run, base in (("plain", "stream_lanes"),
                              ("wordcount", "wordcount")):
                ratio[run] = (spread[f"across_cards_s.{run}"]["median"]
                              / spread[f"one_card_4_lanes_s.{base}"]["median"])
        cs.emit(phase="lanes_cards_vs_one_card", repeat=repeat, walls=walls,
                spread=spread, ratio_of_medians=ratio,
                cards=torch.cuda.device_count())


def service_rank(rank: int, world: int, n: int, seed: int,
                 turns: int) -> list:
    """``mesh_service`` alone on one rank, ``turns`` times."""
    import chip_smoke as cs
    from repro_torch.data import sky
    from repro_torch.launch.mesh import make_mesh
    xyz = sky.make_catalog(n, seed)
    mesh = make_mesh((world,), ("data",))
    cs.warm_census()
    return [cs.mesh_service_rank(rank, xyz, mesh) for _ in range(turns)]


def service(cs, xyz, seed: int, want: list, turns: int) -> None:
    from repro_torch.launch.mesh import spawn_world
    with tempfile.TemporaryDirectory(prefix="mesh-profile-") as tmp:
        ranks = spawn_world(service_rank, cs.MESH_WORLD, len(xyz), seed,
                            turns, backend="gloo",
                            init_file=str(Path(tmp) / "store"),
                            timeout_s=900)
    for t in range(turns):
        per_rank = [r[t] for r in ranks]
        cs.check_mesh_service(per_rank, want, cs.MESH_WORLD)
        loops = [r["closed_loop"] for r in per_rank]
        cs.emit(phase="mesh_service_turn", turn=t, backend="gloo",
                world=cs.MESH_WORLD, equals="phase 18",
                qps=[c["summary"]["qps"] for c in loops],
                p50_ms=[c["summary"]["p50_ms"] for c in loops],
                closed_loop_host_wall_s=[c["host_wall_s"] for c in loops],
                warm_host_wall_s=[r["warm"]["host_wall_s"]
                                  for r in per_rank])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=5,
                    help="turns of the lanes comparison, each side once "
                    "(of mesh_service with --only service)")
    ap.add_argument("--only", choices=["service"])
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
    if args.only == "service":
        _, mix = cs.service_mix()
        service(cs, xyz, args.seed, [cs.outputs(run_jobs([j], xyz))[0]
                                     for j in mix], args.repeat)
        return 0
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
    _, mix = cs.service_mix()
    service_want = [cs.outputs(run_jobs([j], xyz))[0] for j in mix]
    launches = dict.fromkeys(LAUNCHES, 0)
    n_edges = len(cs.zone_jobs("identity")[-1].reducer.edges_rad)
    t0 = time.perf_counter()
    cs.mesh_phases(xyz, args.seed, mono, full_host, service_want, launches,
                   n_edges)
    t1 = time.perf_counter()
    lanes(cs, xyz, args.seed, mono, launches, n_edges, args.repeat)
    print(json.dumps({"mesh_phases_s": t1 - t0,
                      "lanes_s": time.perf_counter() - t1,
                      "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
