"""Dry run: size every (architecture, shape) cell on the production meshes
without a card (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each step on 512 fake host devices and
reads XLA's memory and cost analyses. The port runs the step itself, once,
as rank 0 of a ``fake`` process group of the mesh's size
(``launch/mesh.py::fake_world``: its collectives move nothing), on tensors
of the ``meta`` device (shapes and dtypes, no storage), under the
operation census (``core/op_census.py``: FLOPs, HBM bytes, c10d wire bytes
inside and across pods, counts by operator, the peak of live bytes):

- train: ``training/state.py::abstract_state`` (this rank's shards and
  parts) and ``make_train_step``; prefill and decode:
  ``serving/engine.py::rank_params`` (this rank's model-axis part, cut
  into FSDP row shards by ``pod_param_mode``) and, for decode,
  ``init_rank_cache`` on ``meta`` (its slots and its part of each cache),
  with ``make_prefill_step`` or ``make_decode_step`` (``pos`` the cache's
  last position);
- the batch is ``models/model.py::input_specs`` on the mesh: this rank's
  rows, which each step takes as they are (the training step's
  ``local_batch``, the serving steps' ``batch_rows``);
- under ``kernels.card_routing()``: ``attend`` sends a ``meta`` call to the
  flash kernel's custom op wherever the kernel takes it on the card, and
  its fake implementation stands in for the launch. So the census sizes
  the path the card runs: a flash call is charged its attended pairs x 4 x
  dh FLOPs and the bytes of q, k, v and o, where the reference's dry run,
  lowered on host devices, prices the masked or chunked formula's FLOPs
  and score tensors. Attention FLOPs and temp bytes differ from the
  reference's for that reason (``routing`` in each record).

Memory per device: ``argument`` the step's arguments (the state, or the
parameters and cache, and the batch; each storage once), ``temp`` the
census's peak of live bytes less the arguments, ``output`` the bytes of
new storages the step returns, ``alias`` those of returned tensors that
live in an argument's storage (the state under ``donate_state``, the
cache updated in place). ``terms`` is a ``core/amdahl.py::RooflineTerms``
over the census's per-device counts times the devices, priced on the
card's ``DeviceSpec`` with the bf16 dense tensor-core rate as its compute
peak (``lm_spec``). Without a card pass ``device="cpu"`` and ``spec``
(``--device cpu --spec "NVIDIA H100 80GB HBM3"``: ``amdahl.sheet_spec``);
with neither it raises.

The step runs eagerly: every layer and micro-batch is dispatched, so the
counts need no trip counts, and the slowest cell (deepseek-v3
``train_4k``, 61 layers, 16 micro-batches) is the longest ``trace_s``.
Run a process per mesh size: ``main`` ends one fake world before it
starts the next.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --device cpu --spec "NVIDIA H100 80GB HBM3"

Records go to ``--out`` (``artifacts/dryrun_torch/``), one JSON file a
cell named ``arch__shape__16x16__mode``; ``--summarize`` prints their
table.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import (ARCHS, SHAPES, RunConfig, cell_is_applicable,
                                 get_arch, get_shape)
from repro_torch.core import amdahl
from repro_torch.core.amdahl import (RooflineTerms, model_flops_decode,
                                     model_flops_prefill, model_flops_train)
from repro_torch.core.balance import balance_report, suggest
from repro_torch.core.op_census import census, tensors_of
from repro_torch.kernels import card_routing
from repro_torch.launch import mesh as meshes
from repro_torch.models import model as mdl
from repro_torch.serving.engine import (init_rank_cache, make_decode_step,
                                        make_prefill_step, rank_params)
from repro_torch.training.state import abstract_state
from repro_torch.training.step import make_train_step

MESH_NAMES = {"single": "16x16", "multi": "2x16x16", "tiny": "tiny",
              "tinymulti": "tinymulti"}


def rc_for_mode(cfg, shape, mode: str, overrides: dict | None = None) -> RunConfig:
    """The reference's ``rc_for_mode``, field for field."""
    # gradient accumulation keeps train-step activation memory within HBM
    micro = {"train": 16 if cfg.n_params() > 1e11 else
             (8 if cfg.moe is not None else 4)}.get(shape.kind, 0)
    base = RunConfig(arch=cfg.name, shape=shape.name, remat="full",
                     pod_param_mode="sharded", microbatch=micro)
    if mode == "baseline":
        rc = base.paper_faithful()
    elif mode == "optimized":
        # blocked_causal only where attention heads shard over the 16-way
        # model axis (the reference's rule)
        blocked = cfg.n_heads % 16 == 0
        rc = dataclasses.replace(
            base, bucketed_updates=True, donate_state=True,
            hierarchical_sync=True,
            compress_moe_a2a=cfg.moe is not None,
            attention_impl="blocked_causal" if blocked else "masked")
    else:
        raise ValueError(mode)
    if overrides:
        rc = dataclasses.replace(rc, **overrides)
    return rc


def lm_spec(device=None, spec=None) -> amdahl.DeviceSpec:
    """The spec a cell is priced on: ``spec``, or the card's
    (``device_spec(device)``, which raises without one), with its compute
    peak the bf16 dense tensor-core rate (the LM's GEMMs)."""
    spec = spec if spec is not None else amdahl.device_spec(device)
    return dataclasses.replace(
        spec, peak_flops=spec.dense_flops,
        source=spec.source + "; compute peak: the bf16 dense rate")


def build_step(cfg, shape, mesh, rc):
    """-> (step, its ``meta`` arguments, model FLOPs): the callable a
    user's entry point builds for the cell and this rank's arguments (its
    rows of the batch, as a per-rank loader gives them)."""
    n_active = cfg.n_params_active()
    batch = mdl.input_specs(cfg, shape, mesh=mesh)
    B = shape.global_batch
    tokens = B * shape.seq_len
    if shape.kind == "train":
        return (make_train_step(cfg, rc, mesh, local_batch=True),
                (abstract_state(cfg, rc, mesh), batch),
                model_flops_train(n_active, tokens))
    params = rank_params(cfg, mesh, rc)
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, rc, shape.seq_len, device="meta",
                                  mesh=mesh, batch_rows=B),
                (params, batch), model_flops_prefill(n_active, tokens))
    cache = init_rank_cache(cfg, B, shape.seq_len, device="meta", mesh=mesh)
    return (make_decode_step(cfg, rc, device="meta", mesh=mesh,
                             batch_rows=B),
            (params, cache, batch["tokens"], shape.seq_len - 1),
            model_flops_decode(n_active, B))


def _storages(x) -> dict:
    """{id(storage): nbytes} of every tensor in ``x`` (``tensors_of``:
    modules' parameters and buffers, dicts, lists, tuples; other leaves
    skipped)."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tensors_of(x)}


def run_step(step, args, *, pod_size: int = 0):
    """Run ``step(*args)`` once under the census. -> (its ``OpCensus``,
    the memory record, seconds). Works on ``meta`` and on the card alike
    (``chip_smoke.py`` holds the two to each other)."""
    held = _storages(args)
    # the cycle collector frees some of a step's garbage: start it from
    # none, so when it runs (and so the peak) does not depend on what the
    # process ran before
    gc.collect()
    t0 = time.perf_counter()
    with census(pod_size=pod_size, args=args) as c:
        out = step(*args)
    secs = time.perf_counter() - t0
    got = _storages(out)
    alias = sum(n for k, n in got.items() if k in held)
    memory = {
        "argument_bytes_per_device": c.arg_bytes,
        "output_bytes_per_device": sum(got.values()) - alias,
        "temp_bytes_per_device": c.peak_bytes - c.arg_bytes,
        "alias_bytes_per_device": alias,
    }
    return c, memory, secs


def _mesh(kind: str, devices: int | None):
    if kind in ("single", "multi"):
        return meshes.fake_production_mesh(multi_pod=kind == "multi")
    return meshes.fake_tiny_mesh(multi_pod=kind == "tinymulti",
                                 devices=devices or 8)


def run_cell(arch: str, shape_name: str, mesh_kind: str, mode: str,
             out_dir: str, force: bool = False, overrides: dict | None = None,
             tag: str = "", moe_overrides: dict | None = None, *,
             device=None, spec=None, devices: int | None = None) -> dict:
    """Size one cell and write its record (``<out_dir>/<cell>.json``). A
    cell ``cell_is_applicable`` refuses writes the reference's skip
    record; an ``ok`` record already there is reused unless ``force``.
    ``device``/``spec``: as ``lm_spec`` (raises before any work without a
    card and without ``spec``). ``devices``: the fake world's size for
    the tiny meshes (8)."""
    cfg = get_arch(arch)
    if moe_overrides and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_overrides))
    shape = get_shape(shape_name)
    ok, reason = cell_is_applicable(cfg, shape)
    name = f"{arch}__{shape_name}__{MESH_NAMES[mesh_kind]}__{mode}{tag}"
    path = os.path.join(out_dir, name + ".json")
    if not ok:
        rec = {"cell": name, "status": "skipped", "reason": reason}
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip] {name}: {reason}")
        return rec
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            print(f"[cached] {name}")
            return rec
    dspec = lm_spec(device, spec)
    mesh = _mesh(mesh_kind, devices)
    n_dev = mesh.size()
    rc = rc_for_mode(cfg, shape, mode, overrides)
    rec = {"cell": name, "arch": arch, "shape": shape_name,
           "mesh": MESH_NAMES[mesh_kind], "mode": mode, "devices": n_dev,
           "routing": "card: flash's custom op for a meta call the kernel "
                      "takes on the card",
           "rc": {k: v for k, v in dataclasses.asdict(rc).items()
                  if not k.startswith("_")}}
    try:
        step, args, mf = build_step(cfg, shape, mesh, rc)
        with card_routing():
            c, memory, secs = run_step(step, args,
                                       pod_size=meshes.pod_size(mesh))
        a = c.summary()
        terms = RooflineTerms(
            flops=c.flops * n_dev, hbm_bytes=c.hbm_bytes * n_dev,
            coll_bytes_intra=a["coll_wire_intra_per_device"] * n_dev,
            coll_bytes_cross=a["coll_wire_cross_per_device"] * n_dev,
            chips=n_dev, model_flops=mf, spec=dspec)
        rec.update(
            status="ok", trace_s=round(secs, 2), memory=memory,
            cost_analysis={"flops": c.flops + c.ew_flops,
                           "bytes accessed": c.hbm_bytes},
            analyzer=a, terms=terms.to_dict(), spec=dspec.name,
            n_params=cfg.n_params(), n_params_active=cfg.n_params_active(),
            suggestion=suggest(terms))
        print(memory)
        print(balance_report(name, terms))
        print("  ->", suggest(terms))
    except Exception as e:                # a cell's failure is its record
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[ERROR] {name}: {e}")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def summarize(out_dir: str):
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(out_dir, fn)) as f:
            rows.append(json.load(f))
    print(f"{'cell':66s} {'status':8s} {'dom':10s} {'step_ms':>9s} "
          f"{'roofline%':>9s} {'bytes/dev':>10s} {'trace_s':>8s}")
    for r in rows:
        if r.get("status") != "ok":
            print(f"{r.get('cell', '?'):66s} {r.get('status', '?'):8s} "
                  f"{r.get('reason', r.get('error', ''))[:60]}")
            continue
        t = r["terms"]
        mem = r["memory"]["argument_bytes_per_device"] or 0
        tmp = r["memory"]["temp_bytes_per_device"] or 0
        print(f"{r['cell']:66s} {'ok':8s} {t['dominant']:10s} "
              f"{t['step_time_s'] * 1e3:9.2f} "
              f"{t['roofline_fraction'] * 100:8.1f}% "
              f"{(mem + tmp) / 1e9:9.2f}G {r.get('trace_s', 0):8.1f}")


def _value(v: str):
    """``--set``/``--set-moe`` values: booleans, ints, floats, else text."""
    if v in ("True", "False", "true", "false"):
        return v.lower() == "true"
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "tiny", "tinymulti", "both"])
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--devices", type=int, default=None,
                    help="the fake world's size for --mesh tiny/tinymulti")
    ap.add_argument("--summarize", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="RunConfig overrides k=v (hillclimb knobs)")
    ap.add_argument("--set-moe", action="append", default=[],
                    help="MoEConfig overrides k=v (hillclimb knobs)")
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (then --spec)")
    ap.add_argument("--spec", default=None,
                    help="price on this data-sheet card (amdahl.DATA_SHEET)")
    args = ap.parse_args(argv)

    if args.summarize:
        summarize(args.out)
        return
    overrides = {k: _value(v) for k, v in
                 (kv.split("=", 1) for kv in args.set)}
    moe_overrides = {k: _value(v) for k, v in
                     (kv.split("=", 1) for kv in args.set_moe)}
    spec = amdahl.sheet_spec(args.spec) if args.spec else None
    lm_spec(args.device, spec)             # no card and no spec: raise now
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_err = n_skip = 0
    t0 = time.perf_counter()
    for mk in kinds:                        # one fake world at a time
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mk, args.mode, args.out,
                               force=args.force,
                               overrides=overrides or None, tag=args.tag,
                               moe_overrides=moe_overrides or None,
                               device=args.device, spec=spec,
                               devices=args.devices)
                st = rec.get("status")
                n_ok += st == "ok"
                n_err += st == "error"
                n_skip += st == "skipped"
        meshes.end_fake_world()
    print(f"\ndone: ok={n_ok} err={n_err} skip={n_skip} "
          f"wall={time.perf_counter() - t0:.1f}s")
    if n_err:
        sys.exit(1)


if __name__ == "__main__":
    main()
