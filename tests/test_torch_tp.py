"""Tensor parallelism over the ``model`` axis (``parallel/tp.py``: heads,
KV heads, hidden units and vocabulary rows a rank, the explicit
all-reduces, the vocab-parallel loss) in the port's train step, with FSDP
over the data axes and the experts over ``model`` (granite-moe), held to
the JAX package's GSPMD step on the same mesh, on the CPU.

One gloo world of 4 ranks (``launch/mesh.py::spawn_world``, one torch
thread a rank) runs every case once (the module fixture ``runs``); the
reference runs the same cases in one subprocess on 4 host devices
(``XLA_FLAGS`` forces the count; its (1, 2) mesh takes the first two).
Both start from the port's f32 weights for ``SEED``
(``test_torch_fsdp._weights``) and take the same numpy tokens, an 8-row
global batch a step, two steps, the first at warm-up learning rate 0.
Meshes: (2, 2) data x model, (1, 2) data x model twice side by side
(a (2, 1, 2) mesh whose first axis, ``rep``, no rule reads: each half
runs the whole batch on its two model ranks), and (1, 4).

Cases (reduced widths, granite at ``capacity_factor`` 8 and
``aux_loss_coef`` 0, so no assignment drops and the expert-parallel aux
statistic, a mean over each rank's token slice, stays out of the loss):
tinyllama (32/4 heads at full width; 4/2 here: on 4 ranks its 2 KV heads
stay whole, ``Tp.kv_heads``) and granite-moe (TP on attention and the
vocabulary, EP on the experts) in "sharded", per-tensor "replicated" and,
for tinyllama, "data" mode; tinyllama with Adafactor (its factored means
over cut dimensions all-reduced over ``model``) with and without FSDP.
Two tinyllama cases take the fallback for KV heads the model ranks do not
divide (the whole ``w_k``/``w_v`` on every rank, entered so that the
ranks' partial gradients sum): on (1, 4) its 4/2 heads (one query head
and one whole KV head a rank), and on (1, 2) 6/3 heads at head dim 16,
whose query heads do not fall in equal groups on a rank (rank 0's read
KV heads 0, 0, 1: the per-head index).

- Every step's metrics within rtol 1e-4 of the reference's, and the state
  after the update (``training/state.py::checkpoint_leaves``, the
  reference's leaves) as ``test_torch_fsdp.py`` holds it; every rank
  reports the same metrics.
- The same function as one rank's port step on the whole batch: metrics
  within rtol 1e-5, the state as above.
- The explicit replicated sync (queue 1 item 3: ``hierarchical_sync``,
  the buckets of each rank's plan summed over the data axes only) equals
  the per-tensor replicated step on the same mesh within rtol 1e-5; with
  ``compress_grads`` (int8 with error feedback) its loss is within 0.15
  of the sharded step's (``tests/md_check.py::check_train_step_sharded``)
  and every rank agrees.
- A rank holds exactly its ``ShardSpec`` of its model part of each
  parameter: at most 1/(F tp) of a tensor the model axis cuts and 1/F of
  one it leaves whole, plus one row.
- Checkpoints: ``train()`` on (2, 2) saves whole leaves; the step-2 state
  restores into one rank, (4, 1) and (1, 4) with the same leaves, the
  resumed run's losses equal the uninterrupted run's (deterministic
  algorithms), and the reference's ``Checkpointer.restore`` reads it.
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
from repro_torch.parallel.sharding import ShardSpec  # noqa: E402
from repro_torch.parallel.tp import Tp  # noqa: E402
from repro_torch.training import state as tstate  # noqa: E402
from test_torch_fsdp import (B, S, SEED, _flat, _leaves,  # noqa: E402
                             _StandInMesh, _weights, assert_leaves_close)
from test_torch_train import STEP_REL, close_rel  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD, STEPS = 4, 2
TINY, GRANITE = "tinyllama-1.1b", "granite-moe-3b-a800m"
# the port's meshes: (shape, axes); the reference's: (shape, devices)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x2": ((2, 1, 2), ("rep", "data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
REF_MESHES = {"2x2": (2, 2), "1x2": (1, 2), "1x4": (1, 4)}
REPLICATED = {"pod_param_mode": "replicated", "hierarchical_sync": False,
              "bucketed_updates": False}
ADAFACTOR = {"optimizer": "adafactor"}
HEADS_6_3 = {"n_heads": 6, "n_kv_heads": 3, "head_dim": 16}


def _cases() -> dict:
    """name: (arch, mesh, RunConfig knobs, ArchConfig fields)."""
    out = {}
    for arch in (TINY, GRANITE):
        a = arch.split("-")[0]
        for mesh in ("2x2", "1x2"):
            out[f"{a}-{mesh}-sharded"] = (arch, mesh, {}, {})
            out[f"{a}-{mesh}-replicated"] = (arch, mesh, REPLICATED, {})
    out["tinyllama-2x2-data"] = (TINY, "2x2", {"pod_param_mode": "data"},
                                 {})
    out["tinyllama-2x2-adafactor"] = (TINY, "2x2", {}, ADAFACTOR)
    out["tinyllama-1x2-adafactor"] = (TINY, "1x2", {}, ADAFACTOR)
    out["tinyllama-1x4-sharded"] = (TINY, "1x4", {}, {})
    out["tinyllama-1x2-heads6of3"] = (TINY, "1x2", {}, HEADS_6_3)
    return out


CASES = _cases()
# the explicit replicated sync (the port only): name -> (arch, knobs, the
# case it is held to)
EXPLICIT = {}
for _arch in (TINY, GRANITE):
    _a = _arch.split("-")[0]
    EXPLICIT[f"{_a}-2x2-explicit"] = (
        _arch, {"pod_param_mode": "replicated"}, f"{_a}-2x2-replicated")
    EXPLICIT[f"{_a}-2x2-explicit-int8"] = (
        _arch, {"pod_param_mode": "replicated", "compress_grads": True},
        f"{_a}-2x2-sharded")


def _cfg(arch, fields):
    cfg = get_arch(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0))
    return dataclasses.replace(cfg, **fields)


def _rc(knobs) -> dict:
    return dict(steps=10, warmup_steps=1, learning_rate=1e-3, **knobs)


def _tokens(cfg) -> np.ndarray:
    return np.stack([np.random.default_rng(30 + i).integers(
        0, cfg.vocab, (B, S)) for i in range(STEPS)])


def _wkey(arch, fields) -> str:
    """The model a case trains: its arch and the fields other than the
    optimizer (``tinyllama-1.1b@head_dim16-n_heads6-n_kv_heads3``)."""
    rest = sorted((k, v) for k, v in fields.items() if k != "optimizer")
    if not rest:
        return arch
    return arch + "@" + "-".join(f"{k}{v}" for k, v in rest)


WKEYS = {_wkey(a, f): (a, {k: v for k, v in f.items() if k != "optimizer"})
         for a, _, _, f in CASES.values()}


def _one_key(arch, knobs, fields) -> str:
    """The one-rank run a case is held to: its model, optimizer and update
    kind (the mode is moot on one rank)."""
    per = "per-tensor" if knobs.get("bucketed_updates") is False else \
        "bucketed"
    return f"{_wkey(arch, fields)}|{fields.get('optimizer', 'adamw')}|{per}"


# ---------------------------------------------------------------------------
# the reference, in a subprocess on 4 host devices
# ---------------------------------------------------------------------------

_REFERENCE = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.checkpoint.checkpointing import _flatten_with_paths
from repro.configs import RunConfig, get_arch
from repro.parallel.sharding import use_mesh
from repro.training import state as jstate, step as jstep

z = np.load(sys.argv[1])
spec = json.loads(str(z["spec"]))
res, arrays = {"metrics": {}}, {}


def nest(flat):
    tree = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


for case, c in spec["cases"].items():
    cfg = get_arch(c["arch"]).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0))
    cfg = dataclasses.replace(cfg, **c["fields"])
    rc = RunConfig(**c["rc"])
    shape = tuple(c["shape"])
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devs, ("data", "model"))
    fn, _, st_sh, rules = jstep.make_train_step(cfg, rc, mesh)
    with use_mesh(mesh, rules):
        st = jstate.init_state(cfg, rc, jax.random.PRNGKey(0), mesh)
    pre = c["wkey"] + "|params/"
    st["params"] = nest({k[len(pre):]: z[k] for k in z.files
                         if k.startswith(pre)})
    st = jax.device_put(st, st_sh)
    mets = []
    for toks in z[c["arch"] + "|tokens"]:
        with use_mesh(mesh, rules):
            st, m = fn(st, {"tokens": jnp.asarray(toks)})
        mets.append({k: float(v) for k, v in m.items()})
    res["metrics"][case] = mets
    for k, v in _flatten_with_paths(st).items():
        arrays[case + "|" + k] = np.asarray(v)
np.savez(sys.argv[2], meta=json.dumps(res), **arrays)
'''


def _start_reference(tmp: Path) -> tuple:
    cases = {name: {"arch": a, "shape": list(REF_MESHES[m]), "rc": _rc(kn),
                    "fields": f, "wkey": _wkey(a, f)}
             for name, (a, m, kn, f) in CASES.items()}
    arrays, weights = {}, {}
    for wk, (arch, fields) in WKEYS.items():
        weights[wk] = _weights(arch, fields)
        arrays.update({f"{wk}|{k}": v for k, v in weights[wk].items()})
    for arch in (TINY, GRANITE):
        arrays[f"{arch}|tokens"] = _tokens(get_arch(arch).reduced())
    src, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, spec=json.dumps({"cases": cases}), **arrays)
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
    with np.load(out) as z:
        ref = json.loads(str(z["meta"]))
        ref["leaves"] = {}
        for k in z.files:
            if k != "meta":
                case, key = k.split("|", 1)
                ref["leaves"].setdefault(case, {})[key] = z[k]
    return ref


# ---------------------------------------------------------------------------
# the port, on 4 gloo ranks
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def _mesh(name):
    from repro_torch.launch.mesh import make_mesh
    if name not in _MESHES:
        shape, axes = MESHES[name]
        _MESHES[name] = make_mesh(shape, axes, device_type="cpu")
    return _MESHES[name]


def _train(cfg, rc, mesh, weights) -> tuple:
    """STEPS steps from ``weights`` -> (metrics, final state)."""
    from repro_torch.training import init_state, make_train_step
    st = init_state(cfg, rc, SEED, mesh, device="cpu", dtype=torch.float32)
    leaves = tstate.checkpoint_leaves(st)
    for k, v in weights.items():            # each rank keeps its part
        leaves[k].put(torch.from_numpy(v))
    fn = make_train_step(cfg, rc, mesh)
    mets = []
    for toks in _tokens(cfg):
        st, m = fn(st, {"tokens": toks})
        mets.append({k: v.item() for k, v in m.items()})
    return mets, st


def _numels(st) -> dict:
    """This rank's elements of each parameter, by name."""
    return {n: p.numel() for n, p in st["params"].named_parameters()}


def _run(name, rank, weights, knobs=None, arch=None) -> dict:
    a, mesh, kn, fields = CASES.get(name, (arch, "2x2", knobs, {}))
    cfg = _cfg(a, fields)
    mets, st = _train(cfg, RunConfig(**_rc(knobs if knobs is not None
                                           else kn)), _mesh(mesh),
                      weights[_wkey(a, fields)])
    leaves = _leaves(st)
    return {"metrics": mets, "numels": _numels(st),
            "leaves": leaves if rank == 0 else None}


def _one_rank(key, weights) -> dict:
    wk, optimizer, per = key.split("|")
    arch, fields = WKEYS[wk]
    cfg = _cfg(arch, {"optimizer": optimizer, **fields})
    knobs = {"bucketed_updates": False} if per == "per-tensor" else {}
    mets, st = _train(cfg, RunConfig(**_rc(knobs)), None, weights[wk])
    return {"metrics": mets, "leaves": _leaves(st)}


def _checkpoints(rank, tmp: str) -> dict:
    """``train()`` on (2, 2): 4 steps straight, and 2 + a resume of 2 from
    the step-2 checkpoint (deterministic algorithms); the step-2 state
    restored into (4, 1) and (1, 4) and, on rank 0, into one rank."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import init_state
    cfg = get_arch(TINY).reduced()
    rc = RunConfig(**_rc({"remat": "none"}))
    kw = dict(batch=B, seq=S, mesh=_mesh("2x2"), device="cpu",
              dtype=torch.float32, log_every=1000)
    torch.use_deterministic_algorithms(True)
    try:
        _, full = ttrain.train(cfg, rc, steps=4, ckpt_dir=f"{tmp}/a",
                               ckpt_every=100, **kw)
        st2, _ = ttrain.train(cfg, rc, steps=2, ckpt_dir=f"{tmp}/b",
                              ckpt_every=2, **kw)
        saved = _leaves(st2)
        _, resumed = ttrain.train(cfg, rc, steps=2, ckpt_dir=f"{tmp}/b",
                                  ckpt_every=100, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    out = {"full": full, "resumed": resumed}
    for label, shape in (("4x1", (4, 1)), ("1x4", (1, 4))):
        st = init_state(cfg, rc, SEED + 1, make_mesh(
            shape, ("data", "model"), device_type="cpu"), device="cpu",
            dtype=torch.float32)
        Checkpointer(f"{tmp}/b").restore(st, step=2)
        got = _leaves(st)
        out[label] = (sorted(got) == sorted(saved) and all(
            np.array_equal(got[k], v) for k, v in saved.items()))
    if rank == 0:
        one = init_state(cfg, rc, SEED + 1, device="cpu",
                         dtype=torch.float32)
        Checkpointer(f"{tmp}/b").restore(one, step=2)
        got = _leaves(one)
        out["one"] = (sorted(got) == sorted(saved) and all(
            np.array_equal(got[k], v) for k, v in saved.items()))
        out["saved"] = saved
    return out


def _census(weights) -> dict:
    """The all-reduces of one TinyLlama step on (1, 2) (``remat``
    "none" and "full"), from the operation census."""
    from repro_torch.core import op_census
    from repro_torch.training import init_state, make_train_step
    cfg = _cfg(TINY, {})
    toks = _tokens(cfg)[0]
    out = {}
    for remat in ("none", "full"):
        rc = RunConfig(**_rc({"remat": remat}))
        st = init_state(cfg, rc, SEED, _mesh("1x2"), device="cpu",
                        dtype=torch.float32)
        fn = make_train_step(cfg, rc, _mesh("1x2"))
        with op_census.census() as c:
            fn(st, {"tokens": toks})
        out[remat] = sum(col.op == "all-reduce" for col in c.collectives)
    return out


def _rank(rank, world, tmp, weights):
    torch.set_num_threads(1)     # the ranks share the machine's cores
    out = {"train": {n: _run(n, rank, weights) for n in CASES}}
    out["census"] = _census(weights)
    for name, (arch, knobs, _) in EXPLICIT.items():
        out["train"][name] = _run(name, rank, weights, knobs, arch)
    keys = sorted({_one_key(a, kn, f) for a, _, kn, f in CASES.values()})
    out["one_rank"] = {k: _one_rank(k, weights)
                       for i, k in enumerate(keys) if i % world == rank}
    out["ckpt"] = _checkpoints(rank, tmp)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the port's results by rank, the reference's, tmp, one-rank
    runs by key)."""
    from repro_torch.launch.mesh import spawn_world
    tmp = tmp_path_factory.mktemp("tp")
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


def _close_metrics(got, want, rtol, what):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert set(g) == set(w), (g, w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       err_msg=f"{what} step {i} {k}")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_the_reference_step(runs, case):
    """The reference's GSPMD step on the same mesh and mode: every step's
    metrics (loss, grad norm) within rtol 1e-4, the state after the
    update within ``STEP_REL`` as the FSDP tests hold it; every rank
    reports the same metrics."""
    ranks, ref = runs[0], runs[1]
    arch = CASES[case][0]
    got = ranks[0]["train"][case]
    _close_metrics(got["metrics"], ref["metrics"][case], 1e-4, case)
    assert all(r["train"][case]["metrics"] == got["metrics"] for r in ranks)
    assert_leaves_close(got["leaves"], ref["leaves"][case],
                        STEP_REL.get(arch, 2e-5), 1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_equals_the_one_rank_step(runs, case):
    """One rank's port step on the whole batch: metrics within rtol 1e-5,
    the state after the update as above."""
    ranks, one = runs[0], runs[3]
    arch, _, knobs, fields = CASES[case]
    got = ranks[0]["train"][case]
    want = one[_one_key(arch, knobs, fields)]
    _close_metrics(got["metrics"], want["metrics"], 1e-5, case)
    assert_leaves_close(got["leaves"], want["leaves"],
                        STEP_REL.get(arch, 2e-5), 1e-3)


@pytest.mark.parametrize("case", list(EXPLICIT))
def test_explicit_sync_on_a_model_axis(runs, case):
    """The explicit replicated sync on (2, 2): without compression the
    per-tensor replicated step's metrics within rtol 1e-5 and its
    parameters as above; with int8 and error feedback every rank's metrics
    equal (the copies over ``model`` quantized alike) and the loss within
    0.15 of the sharded step's."""
    ranks = runs[0]
    arch, knobs, held_to = EXPLICIT[case]
    got = ranks[0]["train"][case]
    want = ranks[0]["train"][held_to]
    assert all(r["train"][case]["metrics"] == got["metrics"] for r in ranks)
    if not knobs.get("compress_grads"):
        _close_metrics(got["metrics"], want["metrics"], 1e-5, case)
        for k, w in want["leaves"].items():
            if k.startswith("params/"):
                top = max(float(np.abs(w).max()), 1e-30)
                close_rel(got["leaves"][k], w, STEP_REL.get(arch, 2e-5), k,
                          True, loose=2e-3 / top)
        return
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        assert abs(g["loss"] - w["loss"]) < 0.15, (g, w)
        assert np.isfinite(g["grad_norm"])
    assert any(k.startswith("ef/") for k in got["leaves"])


def test_remat_repeats_the_forward_all_reduces(runs):
    """A TinyLlama step on (1, 2) runs its all-reduces over ``model``
    (the embedding, each attention and FFN output, the loss's three, each
    block input's gradient, the head's, the grad norm: 14 at 2 layers)
    and, under remat "full", the recompute's again up to the last tensor
    the backward needs: the attention output's all-reduce (the FFN's norm
    reads it), not the FFN output's, whose adjoint needs nothing past it
    (the non-reentrant checkpoint stops there); the census counts what
    runs, on every rank."""
    L = get_arch(TINY).reduced().n_layers
    for r in runs[0]:
        assert r["census"]["none"] == 1 + 2 * L + 3 + 2 * L + 1 + 1
        assert r["census"]["full"] == r["census"]["none"] + L


@pytest.mark.parametrize("case", [c for c in CASES if "2x2" in c])
def test_a_rank_holds_its_part(runs, case):
    """Each parameter on a rank is the ``ShardSpec`` of its part on this
    model rank over the F FSDP ranks: at most 1/(F tp) of a tensor the
    model axis cuts (its heads, hidden units, vocabulary rows, experts)
    and 1/F of one it leaves whole, plus one row."""
    arch, mesh, knobs, fields = CASES[case]
    cfg = _cfg(arch, fields)
    F = 1 if knobs.get("pod_param_mode") == "replicated" else 2
    tp = Tp(_StandInMesh((2, 2), ("data", "model")))
    lm = tstate.abstract_state(cfg, RunConfig(**_rc(knobs)))["params"]
    shapes, dims = tstate.param_shapes(lm), tstate.param_dims(lm)
    cut = 0
    for r in runs[0]:
        for n, k in r["train"][case]["numels"].items():
            full, local = shapes[n], tp.local_shape(shapes[n], dims[n])
            spec = ShardSpec(local, F)
            assert k == (spec.numel if F > 1 else math.prod(local)), n
            share = math.prod(full) / (F * (2 if local != full else 1))
            assert k <= share + spec.c, (n, k, share)
            cut += local != full
    assert cut >= 4 * 4 * cfg.n_layers         # w_q, w_o, the FFN a layer


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_resume_on_a_tp_mesh_is_bitwise(runs):
    """4 steps straight on (2, 2) against 2, a checkpoint and 2 resumed
    from it, under deterministic algorithms: the same losses, bit for
    bit, on every rank."""
    for r in runs[0]:
        c = r["ckpt"]
        assert c["full"][2:] == c["resumed"], (c["full"], c["resumed"])
        assert all(np.isfinite(c["full"]))


@pytest.mark.parametrize("world", ["one", "4x1", "1x4"])
def test_tp_checkpoint_restores_into_other_worlds(runs, world):
    """The step-2 checkpoint written on (2, 2) restores into one rank,
    into (4, 1) (FSDP alone) and into (1, 4) (tensor parallel alone, the
    two KV heads whole on every rank) with the same leaves, bit for bit;
    its manifest names the mesh, and every leaf is written once a
    replica."""
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


def test_reference_restores_the_tp_checkpoint(runs):
    """The reference's ``Checkpointer.restore`` reads the (2, 2)
    checkpoint into a one-device state: every leaf it asks for is there,
    in its shape, equal to the port's gathered leaf."""
    jcfg = jget_arch(TINY).reduced()
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

@pytest.mark.parametrize("arch", [TINY, GRANITE, "starcoder2-7b",
                                  "gemma2-2b", "olmo-1b",
                                  "musicgen-medium", "internvl2-2b"])
@pytest.mark.parametrize("tp", [2, 4])
def test_local_shapes_follow_the_reference_rules(arch, tp):
    """At published widths a parameter's local shape is the reference's
    ``spec_for`` over ``model`` (``parallel/sharding.py``): the first
    dimension whose rule names ``model`` and whose size the ranks divide
    is cut, an expert tensor at its experts; the query heads of every
    attention layer and the padded vocabulary always split."""
    from repro_torch.models import model as mdl
    from repro_torch.parallel import sharding
    cfg = get_arch(arch)
    mesh = _StandInMesh((1, tp), ("data", "model"))
    t = Tp.of(mesh, cfg)
    assert t is not None
    rules = sharding.make_rules(mesh)
    lm = mdl.LM(cfg, device="meta")
    shapes, dims = tstate.param_shapes(lm), tstate.param_dims(lm)
    for n, shape in shapes.items():
        spec = sharding.spec_for(shape, dims[n], mesh, rules)
        want = tuple(s // tp if i < len(spec) and spec[i] == "model" else s
                     for i, s in enumerate(shape))
        assert t.local_shape(shape, dims[n]) == want, n
        if n.endswith("attn.w_q"):
            assert want[1] == cfg.n_heads // tp
    assert t.local_shape(shapes["embed.tok"], dims["embed.tok"])[0] == \
        cfg.vocab_padded // tp


@pytest.mark.parametrize("H,Kv,tp", [(32, 4, 4), (24, 8, 2), (24, 8, 4),
                                     (4, 2, 4), (12, 3, 2), (16, 1, 4)])
def test_kv_heads_of_each_rank(H, Kv, tp):
    """``Tp.kv_heads``: a rank's query heads read the KV heads it holds
    (``Kv / tp`` where ``tp`` divides ``Kv``: TinyLlama's 32/4 is 8/1 a
    rank on 4, granite's 24/8 12/4 on 2 and 6/2 on 4), or where it does
    not, the run of whole KV heads its query heads map to, with a per-head
    index where they do not fall in equal groups (12/3 on 2: heads 0-5
    read KV heads 0, 0, 0, 0, 1, 1)."""
    for r in range(tp):
        t = Tp(_StandInMesh((1, tp), ("data", "model")))
        t.__dict__["rank"] = r
        h0, n = t.heads(H)
        lo, cnt, index = t.kv_heads(H, Kv)
        want = [(h0 + j) // (H // Kv) for j in range(n)]
        got = ([lo + int(i) for i in index] if index is not None else
               [lo + j // (n // cnt) for j in range(n)])
        assert got == want, (r, lo, cnt, index)
        if Kv % tp == 0:
            assert (lo, cnt, index) == (r * Kv // tp, Kv // tp, None)
