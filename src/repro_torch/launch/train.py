"""End-to-end training driver (the port of ``repro.launch.train``).

Exercises the training substrate: data pipeline -> train step (with the
paper's optimizations) -> metrics -> checkpointing (replicated,
checksummed, async) -> straggler monitor / failure coordinator hooks ->
restart from the latest checkpoint.

    python -m repro_torch.launch.train [--arch tinyllama-1.1b] [--reduced]
        [--layers N] [--steps 50] [--batch 8] [--seq 128] [--ckpt DIR]
        [--ckpt-every 50] [--inject-failure-at -1] [--baseline]
        [--mesh DxM] [--mode sharded] [--device cuda]

Runs on the card unless ``--device cpu``. ``--layers`` cuts the depth.
``--mesh 2x2`` spawns a world of data x model ranks on this machine
(``launch/mesh.py::run_on_mesh``: gloo on the CPU, NCCL where each rank
has a card) and trains on it; ``--mode`` is ``RunConfig.pod_param_mode``.

``train(mesh=...)`` is SPMD: every rank of a ``launch/mesh.py`` mesh calls
it with the same arguments and takes its rows of each global batch. In
``RunConfig``'s default mode, "sharded", on more than one data rank that
is FSDP: each rank initialises and keeps only its shards, and the
checkpoints hold whole leaves, written by the mesh's ranks in turn
(``checkpoint/checkpointing.py``), so a run resumes on any number of
ranks. A mesh with a ``model`` axis (``make_mesh((2, 2), ("data",
"model"))``) runs the model tensor parallel over the model ranks (``parallel/tp.py``:
each rank its heads, hidden units and vocabulary rows) and splits a MoE
config's experts over them (``parallel/ep.py``); its checkpoints hold
whole leaves too.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import RunConfig, get_arch
from repro_torch.core.device import resolve_device
from repro_torch.data import Pipeline, PipelineConfig, SyntheticTokens
from repro_torch.ft import Coordinator, StragglerMonitor
from repro_torch.training.state import init_state
from repro_torch.training.step import make_train_step


def train(cfg, rc: RunConfig, *, batch: int, seq: int, steps: int,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          inject_failure_at: int = -1, mesh=None, log_every: int = 10,
          resume: bool = True, device=None, dtype=None):
    """Train ``steps`` steps from the latest checkpoint in ``ckpt_dir``
    (when ``resume``), or from ``rc.seed``'s weights, on ``device`` (None:
    the card; this rank's card under ``mesh``). Synthetic tokens from
    ``rc.seed``; ``cond``/``prefix`` zeros where the config reads them. A
    checkpoint every ``ckpt_every`` steps and a blocking one at the end. At
    step ``inject_failure_at`` it raises (a simulated crash). -> (state,
    losses)."""
    device = resolve_device(device, mesh)
    step_fn = make_train_step(cfg, rc, mesh)
    state = init_state(cfg, rc, mesh=mesh, device=device, dtype=dtype)
    mesh_shape = tuple(mesh.mesh.shape) if mesh is not None else ()

    ckpt = None
    start_step = 0
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir, replication=2, async_io=True)
        if resume and ckpt.latest_step() is not None:
            state, manifest = ckpt.restore(state)
            start_step = manifest["step"]
            print(f"[train] resumed from step {start_step}")

    pipe = Pipeline(SyntheticTokens(cfg.vocab, rc.seed),
                    PipelineConfig(global_batch=batch, seq_len=seq,
                                   start_step=start_step)).start()
    mon = StragglerMonitor(hosts=[0])
    coord = Coordinator(hosts=[0])

    extras = {}
    if cfg.cross_attn:
        extras["cond"] = torch.zeros((batch, cfg.cond_len, cfg.d_model),
                                     dtype=torch.bfloat16, device=device)
    if cfg.prefix_embeds:
        extras["prefix"] = torch.zeros((batch, cfg.prefix_embeds,
                                        cfg.d_model), dtype=torch.bfloat16,
                                       device=device)

    losses = []
    it = iter(pipe)
    try:
        for i in range(start_step, start_step + steps):
            _, tokens = next(it)
            batch_dict = {"tokens": torch.as_tensor(tokens, device=device)
                          } | extras
            t0 = time.time()
            if i == inject_failure_at:
                raise RuntimeError(f"injected failure at step {i}")
            state, mets = step_fn(state, batch_dict)
            loss = float(mets["loss"])
            dt = time.time() - t0
            mon.record(0, dt)
            coord.heartbeat(0, time.time())
            losses.append(loss)
            if i % log_every == 0:
                print(f"[train] step={i} loss={loss:.4f} "
                      f"grad_norm={float(mets['grad_norm']):.3f} "
                      f"dt={dt*1e3:.0f}ms")
            if ckpt and (i + 1) % ckpt_every == 0:
                ckpt.save(i + 1, state, mesh_shape=mesh_shape)
        if ckpt:
            ckpt.save(start_step + steps, state, mesh_shape=mesh_shape,
                      blocking=True)
    finally:
        if ckpt:
            ckpt.wait()
        pipe.stop()
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful mode (all optimizations off)")
    ap.add_argument("--mesh", default="",
                    help="train on a spawned world: N, DxM (data x model) "
                         "or PxDxM ranks")
    ap.add_argument("--mode", default="sharded",
                    choices=("sharded", "data", "replicated"),
                    help="RunConfig.pod_param_mode")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        from repro_torch.launch.mesh import run_on_mesh
        out = run_on_mesh(_main_on_mesh, args.mesh, args,
                          device=args.device)
        return out[0]
    return _main(args)


def _main_on_mesh(mesh, args):
    """``main`` on one rank of ``--mesh``'s world (its own card, or the
    CPU); the first rank prints. -> (the world's backend, losses, seconds
    of ``_main``: init, steps, checkpoints and any restart): the state
    stays on its rank."""
    import contextlib
    import io

    import torch.distributed as dist
    quiet = (contextlib.redirect_stdout(io.StringIO()) if dist.get_rank()
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with quiet:
        losses = _main(args, mesh)[1]
    return dist.get_backend(), losses, time.perf_counter() - t0


def _main(args, mesh=None):
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rc = RunConfig(arch=cfg.name, steps=args.steps, remat="none",
                   warmup_steps=max(args.steps // 10, 1),
                   pod_param_mode=args.mode)
    if args.baseline:
        rc = rc.paper_faithful()
    device = args.device
    if mesh is not None and torch.device(device).type == "cuda":
        device = None                   # this rank's card
    kw = dict(batch=args.batch, seq=args.seq, steps=args.steps,
              ckpt_dir=args.ckpt or None, ckpt_every=args.ckpt_every,
              device=device, mesh=mesh)

    t0 = time.time()
    try:
        state, losses = train(cfg, rc,
                              inject_failure_at=args.inject_failure_at, **kw)
    except RuntimeError as e:
        print(f"[train] FAILURE: {e}; restarting from checkpoint...")
        state, losses = train(cfg, rc, **kw)
    print(f"[train] done in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return state, losses


if __name__ == "__main__":
    main()
