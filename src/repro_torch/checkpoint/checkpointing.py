"""Sharded, checksummed, replicated, async checkpointing (the port of
``repro.checkpoint.checkpointing``, with its on-disk layout and manifest).

Layout (one directory per step):

    ckpt_dir/step_000010/
        manifest.json                 # shapes, dtypes, checksums, replica
                                      # map, mesh metadata
        host_0/<leaf-path>.npy        # primary files
        host_1/<leaf-path>.npy        # replica(s) (HDFS replication-factor
                                      # analogue)

Design points mapped from the paper:
- replication factor R: every leaf is written to R simulated host
  directories; restore falls back across replicas on checksum failure
  (``dfs.replication``).
- chunked checksums with configurable chunk size
  (``io.bytes.per.checksum``).
- direct serialization: arrays are written with ``np.save`` from the host
  copy, no pickle staging.
- async: the device->host copy happens synchronously (consistency), the
  file I/O in a background thread (the writer should not stall the
  worker).
- a step is written to ``step_XXXXXXXX.tmp`` and published by one
  ``os.replace``; the oldest steps beyond ``keep`` are removed.

A state is a tree of dicts, lists and tensors; an ``nn.Module`` in it
stands for its parameters. Leaf keys are the "/"-joined paths, as the
reference's. A train state (``training/state.py``: its ``params`` an
``LM``) is written as the reference writes its own: its leaves by the
reference's key paths and shapes (a scan group's layers stacked, the
router biases as the reference's biases tree, buckets whole in the
reference's element order without padding; ``state.checkpoint_leaves``),
so the reference's ``Checkpointer.restore`` reads it, and a checkpoint
written by one world restores into a world of any other size or into one
rank. Under FSDP, or with experts over a ``model`` axis, every rank of
the mesh calls ``save`` and ``restore`` with its own shards: ``save`` gathers each leaf (the ranks call the same
collectives in key order) and the mesh's ranks take the leaves in turn,
each writing its own (one writer a leaf, no file twice); the manifest
(with ``mesh_shape``) is merged on the first rank and the step published
once every rank has written, at the next ``wait`` (``save`` and the end of
the run call it on every rank). ``restore`` reads every leaf whole on
every rank and keeps the rank's part.

bf16 has no numpy dtype: a bf16 leaf is written as its raw 2-byte words
under the header the reference's ``ml_dtypes`` array gets (``'<V2'``),
with ``"dtype": "bfloat16"`` in the manifest, so a file either package
writes reads back in the other. ``restore`` fills the
tensors of a like-shaped state in place (a module's parameters keep their
identity) and returns it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.integrity import (DEFAULT_CHUNK, chunk_checksums,
                                              verify)


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{"params/stack.0.attn.w_q": tensor, "opt/m/0": tensor, ...}``."""
    if isinstance(tree, torch.nn.Module):
        return {f"{prefix}{n}": p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}{k}/"))
    return out


def _is_train_state(tree) -> bool:
    return (isinstance(tree, dict) and
            isinstance(tree.get("params"), torch.nn.Module) and
            hasattr(tree["params"], "cfg"))


def _leaves_of(state) -> tuple[dict, tuple | None]:
    """-> ({key: () -> tensor}, world): a train state's reference leaves
    (``state.checkpoint_leaves``) or a tree's leaves; ``world`` is (group,
    rank, ranks) of a sharded state's mesh, None otherwise."""
    if not _is_train_state(state):
        return {k: (lambda v=v: v)
                for k, v in _flatten_with_paths(state).items()}, None
    from repro_torch.training.state import checkpoint_leaves
    from repro_torch.core.compression import axis_group
    leaves = {k: lf.get for k, lf in checkpoint_leaves(state).items()}
    lay = state.get("layout")
    if lay is None or (lay.fsdp is None and lay.ep is None):
        return leaves, None
    mesh = lay.mesh
    group = axis_group(mesh.mesh_dim_names, mesh=mesh)
    return leaves, (group, dist.get_rank(group), dist.get_world_size(group))


def _targets_of(state) -> dict:
    """``{key: (shape, put)}``: where each leaf of a restored checkpoint
    goes (``put`` fills the state from the whole tensor)."""
    if _is_train_state(state):
        from repro_torch.training.state import checkpoint_leaves
        return {k: (lf.shape, lf.put)
                for k, lf in checkpoint_leaves(state).items()}

    def put(t):
        @torch.no_grad()
        def go(x):
            t.copy_(x)
        return go
    return {k: (tuple(t.shape), put(t))
            for k, t in _flatten_with_paths(state).items()}


def _to_host(t) -> tuple[np.ndarray, str]:
    """-> (the host array to write, the manifest's dtype name)."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr, allow_pickle=False)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A restored file's tensor: bf16 by reinterpreting its 2-byte words."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


class Checkpointer:
    def __init__(self, directory: str, *, replication: int = 2,
                 n_hosts: int = 4, checksum_chunk: int = DEFAULT_CHUNK,
                 async_io: bool = True, keep: int = 3):
        self.dir = directory
        self.replication = max(1, replication)
        self.n_hosts = max(self.replication, n_hosts)
        self.chunk = checksum_chunk
        self.async_io = async_io
        self.keep = keep
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self._sharded = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, state, *, mesh_shape=None,
             blocking: bool = False) -> str:
        """Snapshot ``state``. Returns the checkpoint path."""
        self.wait()                      # one outstanding async save at a time
        leaves, world = _leaves_of(state)
        # synchronous device->host copy for a consistent snapshot; under
        # FSDP every rank gathers every leaf, and keeps those it writes
        keys = sorted(leaves)
        rank, size = world[1:] if world else (0, 1)
        host = {}
        for i, key in enumerate(keys):
            t = leaves[key]()
            if i % size == rank:
                host[key] = (i, _to_host(t))
        d = self.step_dir(step)
        tmp = d + ".tmp"
        meta = {"step": step, "time": time.time(),
                "mesh_shape": list(mesh_shape or []),
                "replication": self.replication,
                "checksum_chunk": self.chunk}

        def _write():
            os.makedirs(tmp, exist_ok=True)
            entries = {}
            for key, (i, (arr, dtype)) in sorted(host.items()):
                replicas = [(i + r) % self.n_hosts
                            for r in range(self.replication)]
                sums = chunk_checksums(arr, self.chunk)
                rel = key.replace("/", "__") + ".npy"
                for h in replicas:
                    hd = os.path.join(tmp, f"host_{h}")
                    os.makedirs(hd, exist_ok=True)
                    _save(os.path.join(hd, rel), arr, dtype)
                entries[key] = {
                    "shape": list(arr.shape), "dtype": dtype, "file": rel,
                    "hosts": replicas, "crc32": sums,
                }
            return entries

        def publish(entries):
            manifest = dict(meta, leaves=dict(sorted(entries.items())))
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(d):        # re-save of the same step (restart)
                shutil.rmtree(d)
            os.replace(tmp, d)           # atomic publish
            self._gc()

        entries: dict = {}

        def write():
            entries.update(_write())
            if world is None:
                publish(entries)

        # a sharded save is published by wait(), on every rank, even one
        # whose write failed (it reports the failure there)
        self._sharded = (publish, world, entries) if world else None

        def run():
            try:
                write()
            except BaseException as e:   # raised again by wait()
                self._error = e

        if self.async_io and not blocking:
            self._pending = threading.Thread(target=run, daemon=True)
            self._pending.start()
        else:
            run()
            self.wait()
        return self.step_dir(step)

    def wait(self):
        """Join the outstanding async save; a sharded state's is published
        here, where every rank of its mesh calls this at the same point.
        Raise its error, or another rank's, if any."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        err, self._error = self._error, None
        sharded, self._sharded = self._sharded, None
        if sharded is not None:
            publish, (group, rank, size), entries = sharded
            got = [None] * size
            dist.all_gather_object(got, (entries, repr(err) if err else None),
                                   group=group)
            failed = [e for _, e in got if e is not None]
            if not failed and rank == 0:
                publish({k: v for part, _ in got for k, v in part.items()})
            dist.barrier(group=group)
            if failed and err is None:
                err = IOError(f"checkpoint save failed on another rank: "
                              f"{failed[0]}")
        if err is not None:
            raise err

    def _gc(self):
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("step_") and not fn.endswith(".tmp"):
                try:
                    out.append(int(fn.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.list_steps()
        return s[-1] if s else None

    def restore(self, like_state, step: int | None = None, *,
                failed_hosts: set[int] | None = None):
        """Fill ``like_state``'s tensors in place from step ``step`` (the
        latest by default). ``failed_hosts`` simulates dead nodes; restore
        succeeds from surviving replicas (or raises if all are lost).
        -> (like_state, manifest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints in " + self.dir)
        d = self.step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        failed = failed_hosts or set()
        chunk = manifest.get("checksum_chunk", DEFAULT_CHUNK)
        for key, (shape, put) in _targets_of(like_state).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"leaf {key} is not in checkpoint {d}")
            if list(shape) != meta["shape"]:
                raise ValueError(f"leaf {key}: checkpoint shape "
                                 f"{meta['shape']}, state {list(shape)}")
            arr = None
            for h in meta["hosts"]:
                if h in failed:
                    continue
                p = os.path.join(d, f"host_{h}", meta["file"])
                if not os.path.exists(p):
                    continue
                cand = np.load(p, allow_pickle=False)
                if verify(cand, meta["crc32"], chunk) == -1:
                    arr = cand
                    break
            if arr is None:
                raise IOError(f"all replicas lost/corrupt for leaf {key}")
            put(_from_host(arr, meta["dtype"]))
        return like_state, manifest
