"""The expert-parallel MoE (experts over the ``model`` axis, token slices,
the int8 all-to-all; ``parallel/ep.py``, ``models/moe.py::_ep_body``) in
the port's train step, held to the JAX package on the CPU.

One gloo world of 4 ranks (``launch/mesh.py::spawn_world``, one torch
thread a rank) runs every case once (the module fixture ``runs``); the
reference runs the same cases in one subprocess on 4 host devices
(``XLA_FLAGS`` forces the count). Both start from the port's weights for
``SEED`` (``test_torch_fsdp._weights``), in f32, and take the same numpy
inputs. Meshes: (2, 2) and (1, 4) data x model, and (2, 1, 2) pod x data
x model, two independent (1, 2) data x model meshes side by side.

- ``moe_apply`` (one layer, reduced granite and deepseek, ``aux_loss_coef``
  1 so ``aux_loss`` is the aux statistic): every rank's ``y`` within
  md_check's 2e-4 of max |y| of the reference's shard on the device of the
  same mesh coordinates, ``load`` summed over the data ranks equal to the
  reference's, ``aux`` averaged over them within rtol 1e-5; at
  ``capacity_factor`` 1.25 and 8, ``compress_moe_a2a`` off and on, and at
  a ``chunk_tokens`` that ``tp`` does not divide (every model rank
  dispatches the whole chunk). The reference does not return its keep
  masks; each rank's (``_ep_body(with_keep=True)``) equals
  ``moe_ep_plain``'s, and the 1.25 cases drop assignments, so a different
  drop would move ``y`` by a whole expert output, far past 2e-4.
- ``moe_ep_plain`` (the ``tp`` slices in one process, no collective)
  against every rank's ``_ep_body``; every adjoint of ``parallel/ep.py``
  against autograd through it.
- The train step at ``capacity_factor`` 8 and ``aux_loss_coef`` 0 against
  one rank's step on the whole batch (first-step moments, so the
  gradients, per leaf, and every step's metrics within rtol 1e-4; the
  final leaves as ``test_torch_fsdp.py`` holds them) and against the
  reference's step on the same mesh (in f32 the reference's EP gradient
  is its one-device gradient: ROADMAP queue 3); at 1.25 with the aux loss
  against one rank's step with ``moe_ep_plain`` in place of each MoE
  layer. Cases: granite (2, 2) "sharded" with bucketed AdamW; granite
  (1, 4) "replicated" per-tensor with ``compress_moe_a2a``; granite in
  "data" mode on (1, 2, 2) pod x data x model; deepseek (2, 2) with
  Adafactor, MTP and the router-bias update.
- Checkpoints: saved from (2, 2) by ``train()``, restored into one rank,
  (4, 1) and (1, 4) with the same leaves, resumed bit for bit; the
  reference's ``Checkpointer.restore`` reads it.
- A rank's bytes at full widths (``abstract_state``): expert leaves at
  most the reference's per-device bytes plus padding, dense leaves at most
  the FSDP bound of ``test_torch_fsdp.py``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.training import state as jstate  # noqa: E402
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import init_module  # noqa: E402
from repro_torch.parallel import ep as ep_mod  # noqa: E402
from repro_torch.training import state as tstate  # noqa: E402
from test_torch_fsdp import (B, S, SEED, STEPS, _flat, _StandInMesh,  # noqa
                             _weights, assert_leaves_close)
from test_torch_train import STEP_REL, close_rel  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v3-671b"
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "1x2": ((2, 1, 2), ("pod", "data", "model"))}
MOE_REL = 2e-4                 # tests/md_check.py's moe check
MOE_X = (4, 16)                # the layer's input, [4, 16, D]


def _moe_cases() -> dict:
    """name: (arch, mesh, MoE fields, compress)."""
    out = {}
    for arch in (GRANITE, DEEPSEEK):
        a = arch.split("-")[0]
        for mesh in MESHES:
            for cf in (1.25, 8.0):
                for compress in (False, True):
                    out[f"{a}-{mesh}-cf{cf:g}-{'int8' if compress else 'f32'}"
                        ] = (arch, mesh, {"capacity_factor": cf}, compress)
        for cf in (1.25, 8.0):      # 30 tokens a chunk: 4 does not divide it
            out[f"{a}-1x4-cf{cf:g}-unsliced"] = (
                arch, "1x4", {"capacity_factor": cf, "chunk_tokens": 30},
                False)
    out["granite-2x2-cf1.25-unsliced"] = (GRANITE, "2x2", {
        "capacity_factor": 1.25, "chunk_tokens": 15}, False)
    # at these few tokens 1.25 leaves room for every assignment; half the
    # mean load drops some, on both sides of the exchange
    out["granite-2x2-cf0.5-f32"] = (GRANITE, "2x2", {"capacity_factor": 0.5},
                                    False)
    out["deepseek-1x4-cf0.5-int8"] = (DEEPSEEK, "1x4", {
        "capacity_factor": 0.5}, True)
    out["granite-1x4-cf0.5-unsliced"] = (GRANITE, "1x4", {
        "capacity_factor": 0.5, "chunk_tokens": 30}, False)
    return out


MOE_CASES = _moe_cases()
# the adjoints: (arch, MoE fields, compress, weight of the output, of aux)
GRAD_CASES = {
    "sliced": (GRANITE, {"capacity_factor": 1.25}, False, 1.0, 0.0),
    "unsliced": (GRANITE, {"capacity_factor": 8.0, "chunk_tokens": 30},
                 False, 1.0, 0.0),
    "aux_only": (DEEPSEEK, {"capacity_factor": 1.25}, False, 0.0, 1.0),
    "both_int8": (DEEPSEEK, {"capacity_factor": 8.0}, True, 1.0, 1.0),
}
# the train step: (arch, mesh shape, axes, RunConfig knobs)
TRAIN_CASES = {
    "granite_sharded": (GRANITE, (2, 2), ("data", "model"), {}),
    "granite_replicated_int8": (GRANITE, (1, 4), ("data", "model"), {
        "pod_param_mode": "replicated", "hierarchical_sync": False,
        "bucketed_updates": False, "compress_moe_a2a": True}),
    "granite_data": (GRANITE, (1, 2, 2), ("pod", "data", "model"),
                     {"pod_param_mode": "data"}),
    "deepseek_adafactor": (DEEPSEEK, (2, 2), ("data", "model"), {}),
}
# the same cases at the published capacity factor with the aux loss, held
# to one rank's step through moe_ep_plain
AUX_CASES = ("granite_sharded", "deepseek_adafactor")
ABSTRACT = (GRANITE, DEEPSEEK)


def _cfg(arch, **moe_kw):
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **moe_kw))


def _moe_cfg(arch, fields):
    return _cfg(arch, aux_loss_coef=1.0, **fields)


def _train_cfg(arch, aux: bool):
    return _cfg(arch, **({} if aux else {"capacity_factor": 8.0,
                                         "aux_loss_coef": 0.0}))


def _rc(knobs) -> dict:
    return dict(steps=10, warmup_steps=1, learning_rate=1e-3, **knobs)


def _tokens(cfg) -> np.ndarray:
    return np.stack([np.random.default_rng(30 + i).integers(
        0, cfg.vocab, (B, S)) for i in range(STEPS)])


def _moe_params(arch) -> dict:
    """One MoE layer's f32 parameters from the port's init, flat by name
    (``shared.w_up``), and its router bias (nonzero for deepseek)."""
    cfg = get_arch(arch).reduced()
    m = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    init_module(m, moe.moe_schema(cfg), seed=SEED)
    p = {n: t.detach().numpy().copy() for n, t in m.named_parameters()}
    bias = np.zeros(cfg.moe.n_experts_padded, np.float32)
    if cfg.moe.router == "sigmoid_bias":
        bias = (np.random.default_rng(5).normal(size=bias.shape) * 0.1
                ).astype(np.float32)
    return p, bias


def _moe_x(arch) -> np.ndarray:
    cfg = get_arch(arch).reduced()
    return (np.random.default_rng(11).normal(size=MOE_X + (cfg.d_model,))
            * 0.5).astype(np.float32)


def _tree(flat: dict, module=False):
    """{"shared.w_up": a} -> {"shared": {"w_up": a}}."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = torch.as_tensor(v) if module else v
    return out


# ---------------------------------------------------------------------------
# the reference, in a subprocess on 4 host devices
# ---------------------------------------------------------------------------

_REFERENCE = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.checkpoint.checkpointing import _flatten_with_paths
from repro.configs import RunConfig, get_arch
from repro.core.compat import make_mesh
from repro.models import moe as jmoe
from repro.parallel.sharding import make_rules, use_mesh
from repro.training import state as jstate, step as jstep

z = np.load(sys.argv[1])
spec = json.loads(str(z["spec"]))
res = {"moe": {}, "metrics": {}, "abstract": {}}
arrays = {}


def nest(flat, sep):
    tree = {}
    for k, v in flat.items():
        *head, last = k.split(sep)
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


def coords(mesh, device):
    return "_".join(map(str, np.argwhere(mesh.devices == device)[0]))


for case, c in spec["moe"].items():
    cfg = get_arch(c["arch"]).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **c["fields"]))
    mesh = make_mesh(tuple(c["shape"]), tuple(c["axes"]))
    rules = make_rules(mesh)
    pre = "moe|" + c["arch"] + "|"
    p = nest({k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}, ".")
    bias = jnp.asarray(z["bias|" + c["arch"]])
    x = jnp.asarray(z["x|" + c["arch"]])

    def f(pp, xx, bb, cfg=cfg, mesh=mesh, rules=rules, cc=c["compress"]):
        with use_mesh(mesh, rules):
            return jmoe.moe_apply(cfg, pp, xx, bb, compress_a2a=cc)
    y, aux = jax.jit(f)(p, x, bias)
    for sh in y.addressable_shards:
        arrays[f"moe#{case}#y#{coords(mesh, sh.device)}"] = np.asarray(sh.data)
    arrays[f"moe#{case}#load"] = np.asarray(aux["load"])
    res["moe"][case] = float(aux["aux_loss"])

for case, c in spec["train"].items():
    cfg = get_arch(c["arch"]).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **c["fields"]))
    rc = RunConfig(**c["rc"])
    mesh = make_mesh(tuple(c["shape"]), tuple(c["axes"]))
    fn, _, st_sh, rules = jstep.make_train_step(cfg, rc, mesh)
    with use_mesh(mesh, rules):
        st = jstate.init_state(cfg, rc, jax.random.PRNGKey(0), mesh)
    pre = c["arch"] + "|params/"
    st["params"] = nest({k[len(pre):]: z[k] for k in z.files
                         if k.startswith(pre)}, "/")
    st = jax.device_put(st, st_sh)
    mets = []
    for toks in z[c["arch"] + "|tokens"]:
        with use_mesh(mesh, rules):
            st, m = fn(st, {"tokens": jnp.asarray(toks)})
        mets.append({k: float(v) for k, v in m.items()})
    res["metrics"][case] = mets
    for k, v in _flatten_with_paths(st).items():
        arrays["train#" + case + "#" + k] = np.asarray(v)

for arch in spec["abstract"]:
    mesh = make_mesh((2, 2), ("data", "model"))
    a = jstate.abstract_state(get_arch(arch), RunConfig(), mesh,
                              make_rules(mesh))
    by = {"expert": 0, "dense": 0}
    for path, x in jax.tree_util.tree_flatten_with_path(a["params"])[0]:
        key = jax.tree_util.keystr(path)
        kind = "expert" if any(w in key for w in ("w_gate", "w_up", "w_down")
                               ) and "moe" in key and "shared" not in key \
            else "dense"
        by[kind] += int(np.prod(x.sharding.shard_shape(x.shape))) * \
            x.dtype.itemsize
    res["abstract"][arch] = by
np.savez(sys.argv[2], meta=json.dumps(res), **arrays)
'''


def _start_reference(tmp: Path) -> tuple:
    moe_spec = {}
    for name, (arch, mesh, fields, compress) in MOE_CASES.items():
        shape, axes = MESHES[mesh]
        moe_spec[name] = {"arch": arch, "shape": list(shape),
                          "axes": list(axes), "compress": compress,
                          "fields": dict(fields, aux_loss_coef=1.0)}
    train_spec = {}
    for name, (arch, shape, axes, knobs) in TRAIN_CASES.items():
        train_spec[name] = {"arch": arch, "shape": list(shape),
                            "axes": list(axes), "rc": _rc(knobs),
                            "fields": {"capacity_factor": 8.0,
                                       "aux_loss_coef": 0.0}}
    arrays, weights = {}, {}
    for arch in (GRANITE, DEEPSEEK):
        cfg = get_arch(arch).reduced()
        weights[arch] = _weights(arch)
        arrays.update({f"{arch}|{k}": v for k, v in weights[arch].items()})
        arrays[f"{arch}|tokens"] = _tokens(cfg)
        p, bias = _moe_params(arch)
        arrays.update({f"moe|{arch}|{k}": v for k, v in p.items()})
        arrays[f"bias|{arch}"] = bias
        arrays[f"x|{arch}"] = _moe_x(arch)
    src, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, spec=json.dumps({"moe": moe_spec, "train": train_spec,
                                   "abstract": ABSTRACT}), **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(src),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, weights


def _finish_reference(proc, out) -> dict:
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    ref = {"y": {}, "load": {}, "leaves": {}}
    with np.load(out) as z:
        ref.update(json.loads(str(z["meta"])))
        for k in z.files:
            if k.startswith("moe#"):
                _, case, what, *rest = k.split("#")
                if what == "y":
                    ref["y"].setdefault(case, {})[rest[0]] = z[k]
                else:
                    ref["load"][case] = z[k]
            elif k.startswith("train#"):
                _, case, key = k.split("#", 2)
                ref["leaves"].setdefault(case, {})[key] = z[k]
    return ref


# ---------------------------------------------------------------------------
# the port, on 4 gloo ranks
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_mesh
    key = (tuple(shape), tuple(axes))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(shape, axes, device_type="cpu")
    return _MESHES[key]


def _coords(mesh) -> str:
    return "_".join(map(str, mesh.get_coordinate()))


def _rows(mesh, n):
    from repro_torch.parallel.sharding import batch_spec
    return batch_spec(n, mesh)


def _local_moe(p: dict, ep) -> dict:
    """This rank's MoE parameters: its experts of each expert tensor."""
    out = {}
    for n, v in p.items():
        t = torch.as_tensor(v)
        out[n] = ep.own(t, ("experts",)).clone() if n in (
            "w_gate", "w_up", "w_down") else t
    return out


def _moe_rank() -> dict:
    """Every MoE case on this rank: ``moe_apply``'s outputs, ``_ep_body``'s
    keep mask, and the census of one call."""
    from repro_torch.core import op_census
    out = {}
    for name, (arch, mname, fields, compress) in MOE_CASES.items():
        cfg = _moe_cfg(arch, fields)
        mesh = _mesh(*MESHES[mname])
        ep = ep_mod.Ep.of(mesh)
        p, bias = _moe_params(arch)
        lp = _tree(_local_moe(p, ep))
        x = torch.as_tensor(_moe_x(arch))[_rows(mesh, MOE_X[0])]
        with op_census.census() as c:
            y, aux = moe.moe_apply(cfg, lp, x, torch.as_tensor(bias), ep=ep,
                                   compress_a2a=compress)
        B_, S_, D = x.shape
        yb, load, a, keep = moe._ep_body(cfg, lp, x.reshape(-1, D),
                                         torch.as_tensor(bias), ep, compress,
                                         with_keep=True)
        out[name] = {"coords": _coords(mesh), "y": y.numpy(),
                     "load": aux["load"].numpy(),
                     "aux": aux["aux_loss"].item(), "y_body": yb.numpy(),
                     "keep": keep.numpy(), "model_rank": ep.rank,
                     "census": [(col.op, col.wire_bytes, col.payload_bytes,
                                 col.group_size) for col in c.collectives]}
    return out


def _grad_rank() -> dict:
    """Every adjoint case on (1, 4): the gradients of sum(y w) + c aux
    with respect to x, the router and this rank's experts."""
    mesh = _mesh(*MESHES["1x4"])
    ep = ep_mod.Ep.of(mesh)
    out = {}
    for name, (arch, fields, compress, wy, wa) in GRAD_CASES.items():
        cfg = _moe_cfg(arch, fields)
        p, bias = _moe_params(arch)
        lp = {k: v.requires_grad_(True) for k, v in _local_moe(p, ep).items()
              if not k.startswith("shared")}
        x = torch.as_tensor(_moe_x(arch)).reshape(-1, cfg.d_model)
        x.requires_grad_(True)
        y, _, aux, _ = moe._ep_body(cfg, lp, x, torch.as_tensor(bias), ep,
                                    compress)
        w = torch.as_tensor(np.random.default_rng(13).normal(
            size=y.shape).astype(np.float32))
        ((y * w).sum() * wy + aux * wa).backward()
        out[name] = {"x": x.grad.numpy(),
                     **{k: v.grad.numpy() for k, v in lp.items()}}
    return out


def _train_run(name, rank, weights, aux: bool) -> dict:
    """The EP train step of case ``name``: metrics, first-step leaves, the
    final leaves (on rank 0) and this rank's state."""
    from repro_torch.training import init_state, make_train_step
    arch, shape, axes, knobs = TRAIN_CASES[name]
    cfg = _train_cfg(arch, aux)
    mesh = _mesh(shape, axes)
    rc = RunConfig(**_rc(knobs))
    st = init_state(cfg, rc, SEED, mesh, device="cpu", dtype=torch.float32)
    leaves = tstate.checkpoint_leaves(st)
    for k, v in weights[arch].items():
        leaves[k].put(torch.from_numpy(v))
    fn = make_train_step(cfg, rc, mesh)
    mets, first = [], None
    for i, toks in enumerate(_tokens(cfg)):
        st, m = fn(st, {"tokens": toks})
        mets.append({k: v.item() for k, v in m.items()})
        if i == 0:
            first = _moments(st)
    final = {k: lf.get().detach().numpy().copy()
             for k, lf in tstate.checkpoint_leaves(st).items()}
    return {"metrics": mets, "first": first if rank == 0 else None,
            "leaves": final if rank == 0 else None,
            "bytes": _bytes(st)}


def _moments(st) -> dict:
    """The first moments as the reference's leaves (a collective)."""
    return {k: lf.get().detach().numpy().copy()
            for k, lf in tstate.checkpoint_leaves(st).items()
            if k.startswith("opt/m/")}


def _bytes(st) -> dict:
    """This rank's parameter bytes, experts and the rest."""
    dims = tstate.param_dims(st["params"])
    by = {"expert": 0, "dense": 0}
    for n, p in st["params"].named_parameters():
        kind = "expert" if ep_mod.is_expert(dims[n]) else "dense"
        by[kind] += p.numel() * p.element_size()
    return by


def _one_rank(name, weights, aux: bool) -> dict:
    """One rank's step on the whole batch; with ``aux`` each MoE layer is
    ``moe_ep_plain`` on the case's model ranks."""
    from repro_torch.models import transformer
    from repro_torch.training import init_state, make_train_step
    arch, shape, axes, knobs = TRAIN_CASES[name]
    cfg = _train_cfg(arch, aux)
    rc = RunConfig(**_rc({k: v for k, v in knobs.items()
                          if k != "compress_moe_a2a"}))
    tp = shape[-1]
    compress = knobs.get("compress_moe_a2a", False)

    def plain(cfg, p, x, bias, *, ep=None, compress_a2a=False):
        Bx, Sx, D = x.shape
        ys, load, a, _ = moe.moe_ep_plain(cfg, p, x.reshape(-1, D), bias, tp,
                                          compress_a2a=compress)
        y = ys[0].reshape(Bx, Sx, D)
        if cfg.moe.n_shared:
            y = y + moe.ffn_apply(cfg, p["shared"], x)
        al = a * cfg.moe.aux_loss_coef if cfg.moe.aux_loss_coef else \
            torch.zeros(())
        return y, {"load": load, "aux_loss": al}

    st = init_state(cfg, rc, SEED, device="cpu", dtype=torch.float32)
    leaves = tstate.checkpoint_leaves(st)
    for k, v in weights[arch].items():
        leaves[k].put(torch.from_numpy(v))
    fn = make_train_step(cfg, rc)
    mets, first = [], None
    keep = transformer.moe_mod.moe_apply
    if aux or compress:
        transformer.moe_mod.moe_apply = plain
    try:
        for i, toks in enumerate(_tokens(cfg)):
            st, m = fn(st, {"tokens": toks})
            mets.append({k: v.item() for k, v in m.items()})
            if i == 0:
                first = _moments(st)
    finally:
        transformer.moe_mod.moe_apply = keep
    return {"metrics": mets, "first": first,
            "leaves": {k: lf.get().detach().numpy().copy()
                       for k, lf in tstate.checkpoint_leaves(st).items()}}


def _checkpoints(rank, tmp: str) -> dict:
    """``train()`` on (2, 2): 4 steps straight, and 2 + a resume of 2 from
    the step-2 checkpoint (deterministic algorithms); the step-2 state
    restored into (4, 1) and (1, 4) and, on rank 0, into one rank."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as ttrain
    from repro_torch.training import init_state
    cfg = _train_cfg(GRANITE, False)
    rc = RunConfig(**_rc({"remat": "none"}))
    mesh = _mesh((2, 2), ("data", "model"))
    kw = dict(batch=B, seq=S, mesh=mesh, device="cpu", dtype=torch.float32,
              log_every=1000)
    torch.use_deterministic_algorithms(True)
    try:
        _, full = ttrain.train(cfg, rc, steps=4, ckpt_dir=f"{tmp}/a",
                               ckpt_every=100, **kw)
        st2, _ = ttrain.train(cfg, rc, steps=2, ckpt_dir=f"{tmp}/b",
                              ckpt_every=2, **kw)
        saved = {k: lf.get().detach().numpy().copy()
                 for k, lf in tstate.checkpoint_leaves(st2).items()}
        _, resumed = ttrain.train(cfg, rc, steps=2, ckpt_dir=f"{tmp}/b",
                                  ckpt_every=100, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    out = {"full": full, "resumed": resumed}
    for label, shape in (("4x1", (4, 1)), ("1x4", (1, 4))):
        st = init_state(cfg, rc, SEED + 1, _mesh(shape, ("data", "model")),
                        device="cpu", dtype=torch.float32)
        Checkpointer(f"{tmp}/b").restore(st, step=2)
        got = {k: lf.get().detach().numpy().copy()
               for k, lf in tstate.checkpoint_leaves(st).items()}
        out[label] = (sorted(got) == sorted(saved) and all(
            np.array_equal(got[k], v) for k, v in saved.items()))
    if rank == 0:
        one = init_state(cfg, rc, SEED + 1, device="cpu", dtype=torch.float32)
        Checkpointer(f"{tmp}/b").restore(one, step=2)
        got = {k: lf.get().detach().numpy().copy()
               for k, lf in tstate.checkpoint_leaves(one).items()}
        out["one"] = (sorted(got) == sorted(saved) and all(
            np.array_equal(got[k], v) for k, v in saved.items()))
        out["saved"] = saved
    return out


def _rank(rank, world, tmp, weights):
    torch.set_num_threads(1)     # the ranks share the machine's cores
    out = {"moe": _moe_rank(), "grads": _grad_rank(), "train": {},
           "aux": {}}
    for name in TRAIN_CASES:
        out["train"][name] = _train_run(name, rank, weights, False)
    for name in AUX_CASES:
        out["aux"][name] = _train_run(name, rank, weights, True)
    # the one-rank steps, a case a rank
    names = list(TRAIN_CASES) + [f"{n}+aux" for n in AUX_CASES]
    out["one_rank"] = {n: _one_rank(n.split("+")[0], weights, n.endswith(
        "+aux")) for i, n in enumerate(names) if i % world == rank}
    out["ckpt"] = _checkpoints(rank, tmp)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the port's results by rank, the reference's results, tmp)."""
    from repro_torch.launch.mesh import spawn_world
    tmp = tmp_path_factory.mktemp("ep")
    proc, out, weights = _start_reference(tmp)
    try:
        ranks = spawn_world(_rank, WORLD, str(tmp), weights, init_file=str(
            tmp / "store"), timeout_s=900)
    except BaseException:
        proc.kill()
        raise
    one = {}
    for r in ranks:
        one.update(r["one_rank"])
    return ranks, _finish_reference(proc, out), tmp, one


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------

def _plain(name):
    """``moe_ep_plain`` of a MoE case on each data rank's tokens: {data
    rows start: (ys, load, aux, keeps)}."""
    arch, mname, fields, compress = MOE_CASES[name]
    cfg = _moe_cfg(arch, fields)
    shape, axes = MESHES[mname]
    tp, dp = shape[-1], math.prod(shape[:-1])
    p, bias = _moe_params(arch)
    x = torch.as_tensor(_moe_x(arch))
    n = MOE_X[0] // dp
    out = []
    for d in range(dp):
        xd = x[d * n:(d + 1) * n].reshape(-1, cfg.d_model)
        with torch.no_grad():
            out.append(moe.moe_ep_plain(cfg, _tree(p, True), xd,
                                        torch.as_tensor(bias), tp,
                                        compress_a2a=compress))
    return out


def _data_index(coords: str, mname) -> int:
    c = [int(v) for v in coords.split("_")]
    return c[0] if len(c) == 2 else c[0] * MESHES[mname][0][1] + c[1]


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_the_reference(runs, case):
    """Every rank's ``y`` within 2e-4 of max |y| of the reference's shard
    at the same mesh coordinates; ``load`` summed over the data ranks
    equal to the reference's; ``aux`` averaged over them within rtol
    1e-5."""
    ranks, ref = runs[0], runs[1]
    mname = MOE_CASES[case][1]
    shape = MESHES[mname][0]
    tp, dp = shape[-1], math.prod(shape[:-1])
    got = [r["moe"][case] for r in ranks]
    for g in got:
        want = ref["y"][case][g["coords"]]
        top = float(np.abs(want).max())
        assert np.abs(g["y"] - want).max() <= MOE_REL * top, (
            g["coords"], np.abs(g["y"] - want).max(), top)
    first = [g for g in got if g["model_rank"] == 0]
    assert len(first) == dp
    np.testing.assert_array_equal(sum(g["load"] for g in first),
                                  ref["load"][case])
    np.testing.assert_allclose(np.mean([g["aux"] for g in first]),
                               ref["moe"][case], rtol=1e-5)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_ep_body_matches_moe_ep_plain(runs, case):
    """``_ep_body`` on every rank against ``moe_ep_plain`` (the ``tp``
    slices in one process) on that data rank's tokens: ``y`` within 1e-5
    of max |y| (int8: one code step of a return block's scale, the bound
    of ``assert_int8_close``), keep masks and ``load`` equal. The 0.5
    cases drop assignments."""
    mname = MOE_CASES[case][1]
    plain = _plain(case)
    dropped = 0.0
    for r in runs[0]:
        g = r["moe"][case]
        ys, load, _, keeps = plain[_data_index(g["coords"], mname)]
        m = g["model_rank"]
        want = ys[m].numpy()
        if MOE_CASES[case][3]:
            assert_int8_close(g["y_body"], want)
        else:
            close_rel(g["y_body"], want, 1e-5, case)
        np.testing.assert_array_equal(g["keep"], keeps[m].numpy())
        np.testing.assert_array_equal(g["load"], load.numpy())
        dropped = max(dropped, 1.0 - float(g["keep"].mean()))
    if MOE_CASES[case][2]["capacity_factor"] < 1:
        assert dropped > 0, case


def assert_int8_close(got, want):
    """A compressed exchange in another order of f32 sums: an element
    whose code lands on the other side of a rounding boundary moves by one
    code step, max|block| / 127 of its return block, times its gates (at
    most ``routed_scaling`` 2.5 in all). At most a thousandth of the
    elements may exceed 1e-5 of max |y|, and none 2.5 / 127 of it."""
    top = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert np.mean(diff > 1e-5 * top) <= 1e-3
    assert diff.max() <= 2.5 / 127 * top, (diff.max(), top)


@pytest.mark.parametrize("case", [c for c in MOE_CASES
                                  if c.endswith("cf8-f32")])
def test_ep_y_equals_the_one_card_body_without_drops(runs, case):
    """At ``capacity_factor`` 8 nothing drops: every rank's ``y`` (the
    routed experts) equals the one-card ``_moe_body``'s on its data rank's
    tokens within 1e-5 of max |y|, and the summed ``load`` its."""
    arch, mname, fields, _ = MOE_CASES[case]
    cfg = _moe_cfg(arch, fields)
    p, bias = _moe_params(arch)
    x = torch.as_tensor(_moe_x(arch))
    dp = math.prod(MESHES[mname][0][:-1])
    n = MOE_X[0] // dp
    for r in runs[0]:
        g = r["moe"][case]
        d = _data_index(g["coords"], mname)
        with torch.no_grad():
            y, load, _, keep = moe._moe_body(
                cfg, _tree(p, True), x[d * n:(d + 1) * n].reshape(
                    -1, cfg.d_model), torch.as_tensor(bias))
        assert bool(keep.all())
        close_rel(g["y_body"], y.numpy(), 1e-5, case)
        np.testing.assert_array_equal(g["load"], load.numpy())


def _q8_error_bound(x: torch.Tensor) -> float:
    """The largest change of one hop's int8 round trip on ``x`` [R, ...]:
    half a code step, max |x[r]| / 254, of its block."""
    return float(x.abs().amax(dim=tuple(range(1, x.dim()))).max()) / 254


def test_q8_round_trip_is_the_reference():
    """``q8``/``dq8`` on a [4, 24, 64] bf16 and f32 block set against the
    reference's ``_q8``/``_dq8``: the same codes and scales, bit for bit;
    the round trip within half a code step of each block."""
    from repro.models import moe as jmoe
    import jax.numpy as jnp
    x = (np.random.default_rng(2).normal(size=(4, 24, 64)) * 3).astype(
        np.float32)
    x[1] = 0.0          # a block of zeros: the 1e-12 floor
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        t = torch.as_tensor(x).to(dt)
        q, s = ep_mod.q8(t)
        jq, js = jmoe._q8(jnp.asarray(x).astype(jdt))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = ep_mod.dq8(q, s, dt)
        jback = jmoe._dq8(jq, js, jdt)
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jback).astype(np.float32))
    t = torch.as_tensor(x)
    assert float((ep_mod.q8_roundtrip(t) - t).abs().max()) <= \
        _q8_error_bound(t) * (1 + 1e-6)


@pytest.mark.parametrize("case", ["granite-1x4-cf8-f32",
                                  "deepseek-2x2-cf1.25-f32"])
def test_census_counts_and_sizes_the_all_to_alls(runs, case):
    """The operation census of one ``moe_apply`` on a rank: per chunk
    three all-to-alls over the model group (the tokens, their expert ids,
    the return trip), int8 codes and scales in place of the tokens under
    ``compress_moe_a2a`` (five), each charged its input bytes times
    (tp - 1) / tp; one all-gather of ``y``, two all-reduces (``load``,
    ``aux``)."""
    for compress_case in (case, case.replace("-f32", "-int8")):
        arch, mname, fields, compress = MOE_CASES[compress_case]
        cfg = _moe_cfg(arch, fields)
        shape = MESHES[mname][0]
        tp, dp = shape[-1], math.prod(shape[:-1])
        T = MOE_X[0] // dp * MOE_X[1]
        n, ntok, C_send, C_exp, sliced = moe._ep_capacity(cfg.moe, T, tp)
        nch = -(-T // n)
        g = runs[0][0]["moe"][compress_case]["census"]
        a2a = [c for c in g if c[0] == "all-to-all"]
        assert len(a2a) == nch * (5 if compress else 3), g
        assert all(c[3] == tp for c in g)
        assert all(math.isclose(c[1], c[2] * (tp - 1) / tp) for c in a2a)
        D = cfg.d_model
        tok = sorted(c[2] for c in a2a)[-1]
        assert tok == tp * C_send * D * (1 if compress else 4), (tok, a2a)
        ops = [c[0] for c in g]
        assert ops.count("all-gather") == 1 and ops.count("all-reduce") == 2


# ---------------------------------------------------------------------------
# the adjoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_adjoints_match_autograd_through_moe_ep_plain(runs, case):
    """The gradients of sum(y w) + c aux on (1, 4) against autograd through
    ``moe_ep_plain`` on 4 model ranks: ``x`` (``enter``'s all-reduce), the
    router (``enter``, and ``mean`` for aux), each rank's experts (the
    ``all_to_all`` adjoint; ``gather_slices`` on sliced chunks,
    ``replicated`` on unsliced ones). f32: within 1e-5 of each tensor's
    max; int8 (the cotangent quantized on the way back too): within
    ``assert_int8_close``'s bound."""
    arch, fields, compress, wy, wa = GRAD_CASES[case]
    cfg = _moe_cfg(arch, fields)
    p, bias = _moe_params(arch)
    tp = 4
    pt = {k: torch.as_tensor(v).clone().requires_grad_(True)
          for k, v in p.items() if not k.startswith("shared")}
    x = torch.as_tensor(_moe_x(arch)).reshape(-1, cfg.d_model)
    x.requires_grad_(True)
    ys, _, aux, _ = moe.moe_ep_plain(cfg, pt, x, torch.as_tensor(bias), tp,
                                     compress_a2a=compress)
    sliced = moe._ep_capacity(cfg.moe, x.shape[0], tp)[-1]
    assert sliced == (case != "unsliced")
    y = ys[0] if sliced else torch.stack(ys).mean(0)
    w = torch.as_tensor(np.random.default_rng(13).normal(
        size=y.shape).astype(np.float32))
    ((y * w).sum() * wy + aux * wa).backward()
    want = {"x": x.grad.numpy(), **{k: v.grad.numpy() for k, v in pt.items()}}
    for r, rank in enumerate(runs[0]):
        got = rank["grads"][case]
        for k, g in got.items():
            wk = want[k]
            if k in ("w_gate", "w_up", "w_down"):
                wk = np.split(wk, tp)[r]
            if compress:
                assert_int8_close(g, wk)
            else:
                close_rel(g, wk, 1e-5, f"{case} {k}")
    if wy == 0:
        assert not np.any(want["w_up"])      # aux reaches the router only


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _close_metrics(got, want, rtol, what):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert set(g) == set(w), (g, w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       err_msg=f"{what} step {i} {k}")


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_ep_step_equals_the_one_rank_step(runs, case):
    """``capacity_factor`` 8, ``aux_loss_coef`` 0: every step's metrics
    within rtol 1e-4 of one rank's step on the whole batch (with the int8
    exchange, one rank's step through ``moe_ep_plain``'s compressed
    hops); the first step's moments (lr 0: a tenth of the gradient), leaf
    by leaf, within 1e-4 of each leaf's max; the final state as the FSDP
    tests hold it. Every rank reports the same metrics."""
    ranks, _, _, one = runs
    arch = TRAIN_CASES[case][0]
    got = ranks[0]["train"][case]
    want = one[case]
    _close_metrics(got["metrics"], want["metrics"], 1e-4, case)
    assert all(r["train"][case]["metrics"] == got["metrics"] for r in ranks)
    flips = bool(TRAIN_CASES[case][3].get("compress_moe_a2a"))
    if got["first"]:
        assert sorted(got["first"]) == sorted(want["first"])
        for k, w in want["first"].items():
            close_rel(got["first"][k], w, 1e-4, k, flips)
    assert_leaves_close(got["leaves"], want["leaves"],
                        STEP_REL.get(arch, 2e-5), 1e-3)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_ep_step_matches_the_reference_ep_step(runs, case):
    """The reference's step on the same mesh and mode, f32 weights: every
    step's metrics within rtol 1e-4, the final state as the FSDP tests hold
    it. With the int8 exchange the two sides sum in another order, so an
    element whose code lands on the other side of a rounding boundary
    moves by a code step (1/127 of its block's max), and the updates carry
    those moves into the next steps: the losses within rtol 1e-3, the
    gradient norms within 1e-2 (after two updates 3.7035 against 3.7159),
    every parameter within two Adam updates' reach, 2 lr each (AdamW's
    normalised step flips with the sign of a small gradient); the
    compressed hops themselves are held at 1e-4 to ``moe_ep_plain``'s
    (``test_ep_step_equals_the_one_rank_step``)."""
    ranks, ref = runs[0], runs[1]
    arch = TRAIN_CASES[case][0]
    got = ranks[0]["train"][case]
    want = ref["leaves"][case]
    if TRAIN_CASES[case][3].get("compress_moe_a2a"):
        for i, (g, w) in enumerate(zip(got["metrics"], ref["metrics"][case],
                                       strict=True)):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(
                    g[k], w[k], rtol=1e-2 if k == "grad_norm" else 1e-3,
                    err_msg=f"{case} step {i} {k}")
        lr = _rc({})["learning_rate"]
        for k, g in got["leaves"].items():
            if k.startswith("params/"):
                assert np.abs(g - want[k]).max() <= 2 * 2 * lr * 1.001, k
        return
    _close_metrics(got["metrics"], ref["metrics"][case], 1e-4, case)
    assert_leaves_close(got["leaves"], want, STEP_REL.get(arch, 2e-5), 1e-3)


@pytest.mark.parametrize("case", AUX_CASES)
def test_ep_step_with_drops_and_aux_matches_moe_ep_plain(runs, case):
    """The published ``capacity_factor`` 1.25 with the aux loss: the EP
    step against one rank's step with ``moe_ep_plain`` in each MoE layer
    (the same drops, the aux loss of each rank's slice averaged over
    ``model``): metrics within rtol 1e-4, first moments within 1e-4 of
    each leaf's max (AdamW), the final state as above; the aux loss
    positive."""
    ranks, _, _, one = runs
    arch = TRAIN_CASES[case][0]
    got = ranks[0]["aux"][case]
    want = one[case + "+aux"]
    _close_metrics(got["metrics"], want["metrics"], 1e-4, case)
    if got["first"]:
        for k, w in want["first"].items():
            close_rel(got["first"][k], w, 1e-4, k)
    assert_leaves_close(got["leaves"], want["leaves"],
                        STEP_REL.get(arch, 2e-5), 1e-3)
    if get_arch(arch).moe.aux_loss_coef:
        assert all(m["moe_aux_loss"] > 0 for m in got["metrics"])


def _expert_bytes(cfg) -> int:
    n = sum(1 for i in range(cfg.n_layers) if i >= cfg.moe.start_layer)
    return n * 3 * cfg.moe.n_experts_padded * cfg.d_model * \
        cfg.moe.d_ff_expert


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_a_rank_holds_its_experts(runs, case):
    """A rank's expert parameters are 1/(F tp) of the whole ones (F the
    FSDP ranks) plus one ``pad_multiple`` of elements a tensor; its dense
    parameters 1/F of theirs plus the same."""
    arch, shape, axes, knobs = TRAIN_CASES[case]
    cfg = _train_cfg(arch, False)
    tp = shape[-1]
    mode = knobs.get("pod_param_mode", "sharded")
    names = dict(zip(axes, shape))
    F = {"sharded": names.get("pod", 1) * names.get("data", 1),
         "data": names.get("data", 1), "replicated": 1}[mode]
    one = tstate.abstract_state(cfg, RunConfig(**_rc(knobs)),
                                dtype=torch.float32)
    whole = _bytes(one)
    n = len(list(one["params"].parameters()))
    for r in runs[0]:
        b = r["train"][case]["bytes"]
        assert b["expert"] <= whole["expert"] / (F * tp) + 4 * 4 * n, b
        assert b["dense"] <= whole["dense"] / F + 4 * 4 * n, b
    assert whole["expert"] == 4 * _expert_bytes(cfg)


@pytest.mark.parametrize("arch", ABSTRACT)
def test_abstract_state_bytes_within_the_reference(runs, arch):
    """Full widths on ``meta``, "sharded" on (2, 2) data x model: a rank's
    expert parameter bytes at most the reference's per-device bytes of
    those leaves plus one ``pad_multiple`` of elements a tensor, and a
    quarter of the whole; its dense bytes at most half the one-rank
    state's (the FSDP bound over 2 data ranks; the reference also cuts
    them over ``model``, which waits for tensor parallelism, ROADMAP
    queue 1 item 5) plus the same."""
    cfg = get_arch(arch)
    st = tstate.abstract_state(cfg, RunConfig(),
                               _StandInMesh((2, 2), ("data", "model")))
    got = _bytes(st)
    n = len(list(st["params"].parameters()))
    ref = runs[1]["abstract"][arch]
    assert got["expert"] <= ref["expert"] + 4 * 4 * n, (got, ref)
    assert got["expert"] <= 2 * _expert_bytes(cfg) / 4 + 4 * 4 * n
    whole = _bytes(tstate.abstract_state(cfg, RunConfig()))
    assert got["dense"] <= whole["dense"] / 2 + 4 * 4 * n, (got, whole)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_resume_on_a_model_axis_is_bitwise(runs):
    """4 steps straight on (2, 2) against 2, a checkpoint and 2 resumed
    from it, under deterministic algorithms: the same losses, bit for
    bit, on every rank."""
    for r in runs[0]:
        c = r["ckpt"]
        assert c["full"][2:] == c["resumed"], (c["full"], c["resumed"])
        assert all(np.isfinite(c["full"]))


@pytest.mark.parametrize("world", ["one", "4x1", "1x4"])
def test_ep_checkpoint_restores_into_other_worlds(runs, world):
    """The step-2 checkpoint written on (2, 2) restores into one rank,
    into (4, 1) (FSDP alone) and into (1, 4) (experts alone) with the same
    leaves, bit for bit; its manifest names the mesh, and every leaf is
    written once a replica."""
    c = [r["ckpt"] for r in runs[0]]
    if world == "one":
        assert c[0]["one"]
    else:
        assert all(x[world] for x in c)
    d = runs[2] / "b" / "step_00000002"
    manifest = json.load(open(d / "manifest.json"))
    assert manifest["mesh_shape"] == [2, 2]
    files = sorted(str(p.relative_to(d)) for p in d.rglob("*.npy"))
    assert len(files) == 2 * len(manifest["leaves"])
    assert sorted(manifest["leaves"]) == sorted(c[0]["saved"])


def test_reference_restores_the_ep_checkpoint(runs):
    """The reference's ``Checkpointer.restore`` reads the (2, 2)
    checkpoint into a one-device state: every leaf it asks for is there,
    in its shape, equal to the port's gathered leaf."""
    jcfg = jget_arch(GRANITE).reduced()
    like = jstate.init_state(jcfg, JRunConfig(**_rc({"remat": "none"})),
                             jax.random.PRNGKey(0))
    back, _ = JCheckpointer(str(runs[2] / "b")).restore(like, step=2)
    saved = runs[0][0]["ckpt"]["saved"]
    flat = {k: np.asarray(v) for k, v in _flat(
        jax.tree.map(np.asarray, back), "").items()}
    shapes = {k: np.shape(v) for k, v in _flat(
        jax.tree.map(np.asarray, like), "").items()}
    assert sorted(flat) == sorted(saved)
    for k, v in flat.items():
        assert v.shape == shapes[k], k
        assert np.array_equal(v, saved[k]), k


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_ep_capacity_is_the_reference_arithmetic(tp):
    """``_ep_capacity`` at the published widths: the chunk sliced where
    ``tp`` divides it, ``C_send`` and ``C_exp`` by the reference's
    formulas (``moe.py:150-164``), and at ``tp = 1`` the one-card
    ``_capacity``."""
    for arch, T in ((GRANITE, 8192), (DEEPSEEK, 4096), (GRANITE, 30)):
        m = get_arch(arch).moe
        n, ntok, C_send, C_exp, sliced = moe._ep_capacity(m, T, tp)
        assert n == min(m.chunk_tokens, T)
        assert sliced == (n % tp == 0)
        assert ntok == (n // tp if sliced else n)
        A = ntok * m.top_k
        assert C_send == max(8, math.ceil(A / tp * m.capacity_factor / 8)
                             * 8)
        E_loc = m.n_experts_padded // tp
        assert C_exp == max(8, math.ceil(tp * C_send / E_loc
                                         * m.capacity_factor / 8) * 8)
        one = moe._ep_capacity(m, T, 1)
        assert (one[0], one[2], one[3]) == moe._capacity(m, T)


def test_adafactor_factors_within_an_expert():
    """Adafactor's factored statistics run over a tensor's last two
    dimensions, so an expert leaf [E, D, F]'s row and column statistics
    are each expert's own: the one-rank update of experts [2, 4) equals
    the update of those experts alone, but for the update-clipping RMS,
    which spans every expert (the one reduction the model ranks share:
    ``FactoredLeaf.ep``, ``_adafactor_update(ep=)``)."""
    from repro_torch.optim import optimizers as opt
    g = torch.as_tensor(np.random.default_rng(4).normal(
        size=(8, 6, 5)).astype(np.float32))
    p = torch.zeros_like(g)
    st = opt.opt_init("adafactor", {"w": g})["per"]["w"]
    kw = dict(lr=1.0, b2=0.999, eps=1e-30, wd=0.0,
              step=torch.tensor(1.0))
    u, new = opt._adafactor_update(g, st, p, **kw)
    sub = {k: v[2:4] for k, v in st.items()}
    u2, new2 = opt._adafactor_update(g[2:4], sub, p[2:4], **kw)
    for k in new:
        torch.testing.assert_close(new[k][2:4], new2[k], rtol=0, atol=0)
    # u = -(g / sqrt(vhat)) / max(rms, 1): the ratios differ by the RMS
    ratio = (u[2:4] / u2).flatten()
    assert torch.allclose(ratio, ratio[0].expand_as(ratio), rtol=1e-5)
