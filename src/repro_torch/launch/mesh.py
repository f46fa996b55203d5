"""Device meshes over ``torch.distributed``: the port of
``repro.launch.mesh`` and of ``repro.core.compat.make_mesh``.

The reference drives a JAX mesh from one controller. The port is SPMD:
every rank is one process on one device, and every rank calls the same
entry point with the same arguments. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (``"pod"``, ``"data"``, ``"model"``); a collective over an axis runs
on ``mesh.get_group(axis)``. The caller builds the default process group
and so chooses the backend (NCCL for one card a rank, gloo for ranks that
share a card or for the CPU); nothing here switches it.

The reference's ``core/compat.py`` ``shard_map`` shim has no counterpart:
each rank runs its own shard's body directly, and the collectives are
explicit ``torch.distributed`` calls (``core/compression.py``,
``core/collectives.py``).

These are functions, as in the reference, so importing touches no process
group. ``spawn_world`` starts a world of ranks on one machine, for tests
and for ``chip_smoke.py``; ``parse_mesh`` and ``run_on_mesh`` give the
command-line entry points a mesh (``--mesh 2x2``: data x model).
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import time
import traceback

import torch
import torch.distributed as dist


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group (which
    must exist and hold ``prod(shape)`` ranks) with dim names ``axes``.
    On the card each rank first takes ``cuda:(rank % device_count)`` as its
    current device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks, the world has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_tiny_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's 8-device mesh: (2, 4) data x model, or (2, 2, 2)
    pod x data x model."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_cpu_mesh():
    """A one-rank (1, 1) data x model mesh on the CPU. Without a default
    process group it starts a world of one gloo rank (an in-memory store,
    no address)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), device_type="cpu")


def mesh_ranks(mesh) -> list:
    """The global ranks of ``mesh``, in its row-major order: the first is
    the mesh's first rank."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def control_group(mesh, *, timeout_s: float):
    """A gloo process group over every rank of ``mesh``, for small host
    objects (batch descriptions, failure reports) beside the data plane.

    ``torch.distributed.new_group`` is itself a collective of the whole
    world: every rank makes its control groups at the same point, in the
    same order. A process group runs its collectives in the order each rank
    issues them, so a group is driven by one thread at a time on every
    rank; two threads that talk across ranks take a group each. Every
    collective on it raises after ``timeout_s``: a rank that never answers
    fails the others loudly."""
    return dist.new_group(mesh_ranks(mesh), backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout_s))


def pod_size(mesh) -> int:
    """Ranks per pod (for cross-pod collective classification); 0 when the
    mesh has no ``"pod"`` axis."""
    names = mesh.mesh_dim_names or ()
    if "pod" not in names:
        return 0
    return math.prod(n for a, n in zip(names, mesh.mesh.shape) if a != "pod")


def parse_mesh(text: str) -> tuple[tuple, tuple]:
    """``"4"``, ``"2x2"`` or ``"2x2x2"`` -> (shape, axes): ``("data",)``,
    ``("data", "model")`` or ``("pod", "data", "model")``."""
    shape = tuple(int(v) for v in text.lower().split("x"))
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}.get(len(shape))
    if axes is None or min(shape) < 1:
        raise ValueError(f"a mesh is N, DxM or PxDxM ranks, got {text!r}")
    return shape, axes


def _on_mesh(rank, world, fn, shape, axes, device_type, args):
    return fn(make_mesh(shape, axes, device_type=device_type), *args)


def run_on_mesh(fn, text: str, *args, device: str = "cuda",
                timeout_s: float = 3600.0) -> list:
    """``fn(mesh, *args)`` on every rank of a world of ``parse_mesh(text)``
    ranks spawned on this machine (``spawn_world``): gloo on the CPU, or
    where the ranks outnumber the cards, NCCL on one card a rank. ``fn``
    is a module-level function. -> its results, by rank."""
    import os
    import tempfile
    shape, axes = parse_mesh(text)
    n = math.prod(shape)
    cuda = torch.device(device).type == "cuda"
    backend = ("nccl" if cuda and n <= torch.cuda.device_count()
               else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        return spawn_world(_on_mesh, n, fn, shape, axes,
                           "cuda" if cuda else "cpu", args, backend=backend,
                           init_file=os.path.join(tmp, "store"),
                           timeout_s=timeout_s)


def _rank_main(rank, fn, world_size, backend, init_file, timeout_s, args,
               results):
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:
        # reported before the group goes down, so ahead of the errors it
        # then raises in the other ranks' collectives
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world_size: int, *args, backend: str = "gloo",
                init_file: str, timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes
    (``torch.multiprocessing.spawn``), each one rank of a default process
    group on ``backend`` that meets through a ``FileStore`` at
    ``init_file`` (a path that does not exist yet). ``fn`` and its results
    are pickled: a module-level function returning numbers, arrays and
    containers of them.

    -> the results, by rank. A rank that raises or dies ends the others
    (``spawn``'s own join) and fails the call with the tracebacks of the
    ranks that raised, the first to raise first; a collective that waits
    ``timeout_s`` raises in its rank, and a world still running after
    ``timeout_s`` is killed."""
    results = mp.get_context("spawn").SimpleQueue()
    ctx = torch.multiprocessing.spawn(
        _rank_main, args=(fn, world_size, backend, init_file, timeout_s,
                          args, results),
        nprocs=world_size, join=False, daemon=True)
    got, failed = {}, []
    deadline = time.monotonic() + timeout_s

    def read():     # as they come: a rank's put blocks while the pipe is full
        while not results.empty():
            rank, ok, value = results.get()
            if ok:
                got[rank] = value
            else:
                failed.append(f"rank {rank} failed:\n{value}")

    while True:
        try:
            done = ctx.join(timeout=1.0)
        except Exception as e:
            read()
            raise RuntimeError("spawn_world: " + "\n".join(failed)) from e
        read()
        if done:
            return [got[r] for r in range(world_size)]
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise TimeoutError(f"spawn_world: ranks still running after "
                               f"{timeout_s} s")
