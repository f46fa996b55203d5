"""Tensor parallelism over the ``model`` axis for the mixers that are not
GQA attention whose heads the ranks divide (``parallel/tp.py``): the
SSM's heads (mamba2), the RG-LRU's state channels (recurrentgemma), MLA's
heads (deepseek-v3, its experts over ``model`` beside them) and the
sequence-sharded attention where the ranks do not divide the heads (the
reference's ``seq_model`` fallback), in the train step and in serving on a
mesh, held to the JAX package's GSPMD step and engine on the same mesh and
to one rank's port, on the CPU.

One gloo world of 4 ranks (``launch/mesh.py::spawn_world``, one torch
thread a rank) runs every case once (the module fixture ``runs``); the
reference runs the same cases in ``REF_PROCS`` subprocesses, each on 4
host devices, started beside it. Both start from the port's f32 weights
for ``SEED`` (the constant leaves moved by a draw, as
``test_torch_fsdp._weights``) and take
the same numpy tokens, an 8 x 16 global batch a step, two steps, the first
at warm-up learning rate 0, in "sharded" mode (FSDP over the data ranks
of a (2, 2) mesh). Meshes as ``test_torch_tp.py``'s: (2, 2) data x model,
(1, 2) twice side by side, (1, 4).

Cases, at reduced widths (``*-heads6``: fields replaced on both sides):
- mamba2 (8 SSD heads) on (1, 2), (1, 4) and (2, 2), and with ``d_model``
  48 (6 SSD heads, ``Din`` 96) on (1, 4), where the ranks do not divide
  the heads and the mixer runs whole on every rank (the reference cuts
  ``Din``; the same numbers);
- recurrentgemma (``W`` 64 in 4 gate blocks, 4 heads, MQA) on (1, 2) and
  (1, 4); with 6 heads, one KV head, ``lru_width`` 96 and window 8 on
  (1, 4): the local attention shards its 16 positions (4 a rank, the last
  rank reading keys from position 5), and 24 channels a rank straddle the
  16-channel gate blocks, as 640 channels a rank do the 256-channel ones
  at full width on 4;
- deepseek-v3 (MLA, 4 heads; MoE after a dense layer, MTP) on (1, 2) and
  (2, 2), its experts over ``model``, at ``capacity_factor`` 8 and
  ``aux_loss_coef`` 0, as ``test_torch_tp.py``'s granite;
- tinyllama with 6 heads and 2 KV heads on (1, 4): sequence-sharded GQA
  (4 ranks cannot leave its 4 reduced heads undivided);
- deepseek-v3 with 6 heads on (1, 4), whose MLA shards the sequence (the
  reference's ``seq_model`` fallback in its MLA);
- held to one rank only: mamba2 on (2, 2) in "replicated" mode with the
  explicit sync (``hierarchical_sync``).

Bounds, as ``test_torch_tp.py``'s:
- every step's metrics within rtol 1e-4 of the reference's and the state
  after the update (``training/state.py::checkpoint_leaves``) as
  ``test_torch_fsdp.assert_leaves_close`` holds it (``STEP_REL``: 2e-5,
  deepseek 2e-4); every rank reports the same metrics;
- one rank's port step on the whole batch: metrics within rtol 1e-5, the
  state as above;
- ``ServeEngine`` (6 requests, 4 slots, f32 caches) on the mesh: one
  rank's tokens and every step's logits within ``REL``, the reference's
  engine on the same mesh within ``test_torch_tp_serve.py``'s bound
  (``REL_OF``: deepseek 2e-4);
- the same engine with bf16 weights and its default bf16 cache
  (``SERVE_BF16``): every rank's logits, over the steps before their
  tokens first part from one rank's, within twice one rank's bf16 engine's
  gap from its f32 one (each bf16 run may sit that far from the f32 run;
  a TP path that rounds worse than bf16 does not);
- ``make_prefill_step`` over 48 positions then 4 decode steps: the
  logits within ``REL`` of one rank's (deepseek's ``REL_OF``), each
  rank's cache its part of one rank's (an SSM's heads and channels, the
  RG-LRU's channels, MLA's latent whole) within 1e-5;
- a (2, 2) mamba2 checkpoint restores into one rank, into (1, 4) and into
  the reference with the same leaves.
"""
import dataclasses
import json
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
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.tp import Tp, uncovered  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.training import state as tstate  # noqa: E402
from test_torch_families import REL, REL_OF, assert_logits_close  # noqa: E402
from test_torch_fsdp import (B, S, SEED, _flat, _leaves,  # noqa: E402
                             _StandInMesh, assert_leaves_close)
from test_torch_train import STEP_REL  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD, STEPS = 4, 2
MAMBA, RG = "mamba2-1.3b", "recurrentgemma-2b"
DS, TINY = "deepseek-v3-671b", "tinyllama-1.1b"
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x2": ((2, 1, 2), ("rep", "data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
REF_MESHES = {"2x2": (2, 2), "1x2": (1, 2), "1x4": (1, 4)}
MAMBA6 = {"d_model": 48}
RG6 = {"n_heads": 6, "n_kv_heads": 1, "lru_width": 96, "window": 8}
TINY6 = {"n_heads": 6, "n_kv_heads": 2}
EXPLICIT = {"pod_param_mode": "replicated"}
CASES = {               # name: (arch, mesh, RunConfig knobs, fields)
    "mamba2-1x2": (MAMBA, "1x2", {}, {}),
    "mamba2-1x4": (MAMBA, "1x4", {}, {}),
    "mamba2-2x2": (MAMBA, "2x2", {}, {}),
    "mamba2-1x4-heads6": (MAMBA, "1x4", {}, MAMBA6),
    "recurrentgemma-1x2": (RG, "1x2", {}, {}),
    "recurrentgemma-1x4": (RG, "1x4", {}, {}),
    "recurrentgemma-1x4-heads6": (RG, "1x4", {}, RG6),
    "deepseek-1x2": (DS, "1x2", {}, {}),
    "deepseek-2x2": (DS, "2x2", {}, {}),
    "tinyllama-1x4-heads6": (TINY, "1x4", {}, TINY6),
    "mamba2-2x2-explicit": (MAMBA, "2x2", EXPLICIT, {}),
    "deepseek-1x4-heads6": (DS, "1x4", {}, {"n_heads": 6}),
}
# held to one rank's step only
ONE_RANK_ONLY = ("mamba2-2x2-explicit",)
REFERENCE_CASES = [c for c in CASES if c not in ONE_RANK_ONLY]
SERVE = ["mamba2-1x4", "mamba2-1x4-heads6", "recurrentgemma-1x2",
         "recurrentgemma-1x4-heads6", "deepseek-2x2",
         "tinyllama-1x4-heads6"]
SERVE_BF16 = ["mamba2-1x4", "recurrentgemma-1x4-heads6", "deepseek-2x2"]
STEP_CASES = ["mamba2-1x4", "recurrentgemma-1x4-heads6", "deepseek-2x2",
              "deepseek-1x4-heads6"]
CKPT_CASE = "mamba2-2x2"
SLOTS, MAX_LEN, PROMPT = 4, 64, 48
REF_PROCS = 3


def _cfg(arch, fields, get=get_arch):
    """The reduced config with ``fields`` replaced (``lru_width`` in the
    RG-LRU's config), a MoE at capacity 8 without the aux loss."""
    cfg = get(arch).reduced()
    fields = dict(fields)
    if "lru_width" in fields:
        cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
            cfg.rglru, lru_width=fields.pop("lru_width")))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0))
    return dataclasses.replace(cfg, **fields)


def _wkey(arch, fields) -> str:
    return arch + "".join(f"@{k}{v}" for k, v in sorted(fields.items()))


WKEYS = {_wkey(a, f): (a, f) for a, _, _, f in CASES.values()}


def _rc(knobs) -> dict:
    return dict(steps=10, warmup_steps=1, learning_rate=1e-3, **knobs)


def _weights(cfg) -> dict:
    """The port's f32 weights for ``SEED`` as the reference's flat leaves,
    the constant-initialised ones moved by a seeded draw."""
    lm = mdl.init(cfg, SEED, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    out = {}
    for k, a in _flat(convert.params_to_numpy(lm, cfg), "params/").items():
        if a.size > 1 and np.all(a == a.flat[0]):
            a = a + (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        out[k] = a
    return out


def _tree(weights) -> dict:
    out: dict = {}
    for k, v in weights.items():
        node = out
        *head, last = k.split("/")[1:]
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _tokens(cfg) -> np.ndarray:
    return np.stack([np.random.default_rng(30 + i).integers(
        0, cfg.vocab, (B, S)) for i in range(STEPS)])


def _requests(cfg) -> list:
    rng = np.random.default_rng(9)
    return [engine.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, size=rng.integers(4, 12)).tolist(), max_new=8)
        for i in range(6)]


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
from repro.models import model as jmdl
from repro.parallel.sharding import use_mesh
from repro.serving import engine as jengine
from repro.training import state as jstate, step as jstep

z = np.load(sys.argv[1])
spec = json.loads(str(z["spec"]))
res, arrays = {"metrics": {}, "serve": {}}, {}


def cfg_of(arch, fields):
    cfg = get_arch(arch).reduced()
    fields = dict(fields)
    if "lru_width" in fields:
        cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
            cfg.rglru, lru_width=fields.pop("lru_width")))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0))
    return dataclasses.replace(cfg, **fields)


def nest(pre):
    tree = {}
    for k in z.files:
        if k.startswith(pre):
            *head, last = k[len(pre):].split("/")
            node = tree
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(z[k])
    return tree


def mesh_of(shape):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, ("data", "model"))


for case, c in spec["cases"].items():
    cfg = cfg_of(c["arch"], c["fields"])
    rc = RunConfig(**c["rc"])
    mesh = mesh_of(tuple(c["shape"]))
    fn, _, st_sh, rules = jstep.make_train_step(cfg, rc, mesh)
    with use_mesh(mesh, rules):
        st = jstate.init_state(cfg, rc, jax.random.PRNGKey(0), mesh)
    st["params"] = nest(c["wkey"] + "|params/")
    st = jax.device_put(st, st_sh)
    mets = []
    for toks in z[c["wkey"] + "|tokens"]:
        with use_mesh(mesh, rules):
            st, m = fn(st, {"tokens": jnp.asarray(toks)})
        mets.append({k: float(v) for k, v in m.items()})
    res["metrics"][case] = mets
    for k, v in _flatten_with_paths(st).items():
        arrays["train|" + case + "|" + k] = np.asarray(v)

for case, c in spec["serve"].items():
    cfg = cfg_of(c["arch"], c["fields"])
    mesh = mesh_of(tuple(c["shape"]))
    _, bschema = jmdl.model_schema(cfg)
    biases = jax.tree.map(lambda pd: jnp.zeros(pd.shape, jnp.float32),
                          bschema, is_leaf=lambda x: hasattr(x, "dims"))
    eng = jengine.ServeEngine(cfg, RunConfig(remat="none"),
                              nest(c["wkey"] + "|params/"), biases, mesh,
                              slots=c["slots"], max_len=c["max_len"])
    eng.cache = jax.tree.map(lambda a: a.astype(jnp.float32), eng.cache)
    logits = []
    step = eng.decode

    def rec(*a, step=step):
        out, cache = step(*a)
        logits.append(np.asarray(out, np.float32))
        return out, cache
    eng.decode = rec
    reqs = [jengine.Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(c["prompts"])]
    for r in reqs:
        eng.submit(r)
    steps = eng.run(max_steps=c["max_len"] - 1)
    res["serve"][case] = {"steps": steps, "outs": [r.out for r in reqs]}
    arrays["serve|" + case] = np.stack(logits)
np.savez(sys.argv[2], meta=json.dumps(res), **arrays)
'''


def _start_reference(tmp: Path) -> tuple:
    """The reference's cases in ``REF_PROCS`` subprocesses, started
    together (its compiles take most of the module's time). -> (the
    processes and their outputs, the weights by key)."""
    def spec(name):
        a, m, kn, f = CASES[name]
        return {"arch": a, "shape": list(REF_MESHES[m]), "rc": _rc(kn),
                "fields": f, "wkey": _wkey(a, f)}
    cases = {n: spec(n) for n in REFERENCE_CASES}
    serve = {n: dict(spec(n), slots=SLOTS, max_len=MAX_LEN,
                     prompts=[r.prompt for r in _requests(
                         _cfg(*CASES[n][::3]))]) for n in SERVE}
    arrays, weights = {}, {}
    for wk, (arch, fields) in WKEYS.items():
        cfg = _cfg(arch, fields)
        weights[wk] = _weights(cfg)
        arrays.update({f"{wk}|{k}": v for k, v in weights[wk].items()})
        arrays[f"{wk}|tokens"] = _tokens(cfg)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    procs = []
    for i in range(REF_PROCS):
        part = {"cases": {n: c for j, (n, c) in enumerate(cases.items())
                          if j % REF_PROCS == i},
                "serve": {n: c for j, (n, c) in enumerate(serve.items())
                          if j % REF_PROCS == i}}
        src, out = tmp / f"in{i}.npz", tmp / f"out{i}.npz"
        np.savez(src, spec=json.dumps(part), **arrays)
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(src), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out))
    return procs, weights


def _finish_reference(procs) -> dict:
    ref = {"metrics": {}, "serve": {}, "leaves": {}, "logits": {}}
    for proc, out in procs:
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log[-4000:]
        with np.load(out) as z:
            meta = json.loads(str(z["meta"]))
            ref["metrics"].update(meta["metrics"])
            ref["serve"].update(meta["serve"])
            for k in z.files:
                if k.startswith("train|"):
                    _, case, key = k.split("|", 2)
                    ref["leaves"].setdefault(case, {})[key] = z[k]
                elif k.startswith("serve|"):
                    ref["logits"][k.split("|", 1)[1]] = z[k]
    return ref


# ---------------------------------------------------------------------------
# the port, on 4 gloo ranks
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def _mesh(name):
    from repro_torch.launch.mesh import make_mesh
    if name is None:
        return None
    if name not in _MESHES:
        _MESHES[name] = make_mesh(*MESHES[name], device_type="cpu")
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


def _serve(cfg, lm, mesh, cache_dtype=torch.float32) -> dict:
    eng = engine.ServeEngine(cfg, RunConfig(), lm, slots=SLOTS,
                             max_len=MAX_LEN, device="cpu", mesh=mesh,
                             cache_dtype=cache_dtype)
    logits = []
    step = eng.decode

    def rec(*a):
        out, cache = step(*a)
        logits.append(out.float().numpy().copy())
        return out, cache
    eng.decode = rec
    reqs = _requests(cfg)
    for r in reqs:
        eng.submit(r)
    steps = eng.run(max_steps=MAX_LEN - 1)
    return {"steps": steps, "outs": [r.out for r in reqs],
            "logits": np.stack(logits)}


def _prefill_decode(cfg, lm, mesh) -> dict:
    """Prefill over ``PROMPT`` positions then 4 greedy decode steps: the
    logits, and this rank's cache of the first two layers. ``lm`` is this
    rank's model part whole over the data ranks: the "replicated"
    layout."""
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, PROMPT))
    rc = RunConfig(pod_param_mode="replicated")
    pre = engine.make_prefill_step(cfg, rc, MAX_LEN, device="cpu",
                                   mesh=mesh)
    dec = engine.make_decode_step(cfg, rc, device="cpu", mesh=mesh)
    cache, last = pre(lm, {"tokens": toks})
    logits = [last.numpy().copy()]
    tok = last.argmax(-1, keepdim=True)
    for i in range(4):
        out, cache = dec(lm, cache, tok, PROMPT + i)
        logits.append(out.numpy().copy())
        tok = out.argmax(-1, keepdim=True)
    return {"logits": np.stack(logits),
            "cache": [{f"{m}/{k}": t.float().numpy().copy()
                       for m, d in layer.items() for k, t in d.items()}
                      for layer in cache[:2]]}


def _lm(name, weights, mesh, dtype=torch.float32):
    arch, _, _, fields = CASES[name]
    cfg = _cfg(arch, fields)
    tp = Tp.of(mesh, cfg) if mesh is not None else None
    return cfg, convert.params_from_numpy(
        _tree(weights[_wkey(arch, fields)]), cfg, device="cpu",
        dtype=dtype, tp=tp)


def _serve_bf16(name, weights, mesh) -> dict:
    """``_serve`` with bf16 weights and the engine's default bf16 cache."""
    return _serve(*_lm(name, weights, mesh, torch.bfloat16), mesh, None)


def _checkpoints(rank, tmp, st, want) -> dict:
    """The (2, 2) state ``st`` saved, then restored into (1, 4) and, on
    rank 0, into one rank: whether each holds the leaves ``want``."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.training import init_state
    arch, _, knobs, fields = CASES[CKPT_CASE]
    cfg, rc = _cfg(arch, fields), RunConfig(**_rc(knobs))
    Checkpointer(f"{tmp}/ckpt").save(STEPS, st, mesh_shape=(2, 2),
                                     blocking=True)
    dist.barrier()

    def same(mesh):
        other = init_state(cfg, rc, SEED + 1, mesh, device="cpu",
                           dtype=torch.float32)
        Checkpointer(f"{tmp}/ckpt").restore(other, step=STEPS)
        got = _leaves(other)
        return sorted(got) == sorted(want) and all(
            np.array_equal(got[k], v) for k, v in want.items())
    out = {"1x4": same(_mesh("1x4"))}
    if rank == 0:
        out["one"] = same(None)
    return out


def _rank(rank, world, tmp, weights):
    torch.set_num_threads(1)     # the ranks share the machine's cores
    out = {"train": {}, "serve": {}, "serve_bf16": {}, "steps": {}}
    for name, (arch, mesh, knobs, fields) in CASES.items():
        cfg = _cfg(arch, fields)
        mets, st = _train(cfg, RunConfig(**_rc(knobs)), _mesh(mesh),
                          weights[_wkey(arch, fields)])
        leaves = _leaves(st)
        out["train"][name] = {"metrics": mets,
                              "leaves": leaves if rank == 0 else None}
        if name == CKPT_CASE:
            out["ckpt"] = _checkpoints(rank, tmp, st, leaves)
    keys = sorted(WKEYS)
    out["one_rank"] = {}
    for i, k in enumerate(keys):
        if i % world == rank:
            arch, fields = WKEYS[k]
            mets, st = _train(_cfg(arch, fields), RunConfig(**_rc({})),
                              None, weights[k])
            out["one_rank"][k] = {"metrics": mets, "leaves": _leaves(st)}
    for name in SERVE:
        mesh = _mesh(CASES[name][1])
        out["serve"][name] = _serve(*_lm(name, weights, mesh), mesh)
    for name in SERVE_BF16:
        out["serve_bf16"][name] = _serve_bf16(name, weights,
                                              _mesh(CASES[name][1]))
    for name in STEP_CASES:
        mesh = _mesh(CASES[name][1])
        out["steps"][name] = _prefill_decode(*_lm(name, weights, mesh),
                                             mesh)
        out["steps"][name]["model_rank"] = mesh.get_local_rank("model")
        out["steps"][name]["data_rank"] = mesh.get_local_rank("data")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the port's results by rank, the reference's, one rank's serving
    and prefill runs, tmp)."""
    from repro_torch.launch.mesh import spawn_world
    tmp = tmp_path_factory.mktemp("tp_mixers")
    procs, weights = _start_reference(tmp)
    try:
        ranks = spawn_world(_rank, WORLD, str(tmp), weights, init_file=str(
            tmp / "store"), timeout_s=900)
    except BaseException:
        for proc, _ in procs:
            proc.kill()
        raise
    one = {"train": {}, "serve": {}, "serve_bf16": {}, "steps": {}}
    for r in ranks:
        one["train"].update(r["one_rank"])
    for name in SERVE:
        one["serve"][name] = _serve(*_lm(name, weights, None), None)
    for name in SERVE_BF16:
        one["serve_bf16"][name] = _serve_bf16(name, weights, None)
    for name in STEP_CASES:
        one["steps"][name] = _prefill_decode(*_lm(name, weights, None), None)
    return ranks, _finish_reference(procs), one, tmp


def _close_metrics(got, want, rtol, what):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert set(g) == set(w), (g, w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       err_msg=f"{what} step {i} {k}")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_step_matches_the_reference_step(runs, case):
    """The reference's GSPMD step on the same mesh: every step's metrics
    within rtol 1e-4, the state after the update within ``STEP_REL``;
    every rank reports the same metrics."""
    ranks, ref = runs[0], runs[1]
    arch = CASES[case][0]
    got = ranks[0]["train"][case]
    _close_metrics(got["metrics"], ref["metrics"][case], 1e-4, case)
    assert all(r["train"][case]["metrics"] == got["metrics"] for r in ranks)
    assert_leaves_close(got["leaves"], ref["leaves"][case],
                        STEP_REL.get(arch, 2e-5), 1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_step_equals_the_one_rank_step(runs, case):
    """One rank's port step on the whole batch: metrics within rtol 1e-5,
    the state after the update as above."""
    ranks, one = runs[0], runs[2]
    arch, _, _, fields = CASES[case]
    got = ranks[0]["train"][case]
    want = one["train"][_wkey(arch, fields)]
    _close_metrics(got["metrics"], want["metrics"], 1e-5, case)
    assert all(r["train"][case]["metrics"] == got["metrics"]
               for r in runs[0])
    assert_leaves_close(got["leaves"], want["leaves"],
                        STEP_REL.get(arch, 2e-5), 1e-3)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SERVE)
def test_serve_engine_on_a_mesh(runs, case):
    """Every rank's engine: one rank's step count and tokens, every step's
    logits within ``REL`` of one rank's; the reference's engine on the
    same mesh: its tokens, the logits within the families' bound."""
    ranks, ref, one = runs[:3]
    arch = CASES[case][0]
    want = one["serve"][case]
    for r in ranks:
        got = r["serve"][case]
        assert got["steps"] == want["steps"] and got["outs"] == want["outs"]
        assert_logits_close(got["logits"], want["logits"], REL)
    got = ranks[0]["serve"][case]
    assert got["steps"] == ref["serve"][case]["steps"]
    assert got["outs"] == ref["serve"][case]["outs"]
    assert_logits_close(got["logits"], ref["logits"][case],
                        REL_OF.get(arch, REL))


def _gap(a: dict, b: dict) -> float:
    """Max |logit| difference between two engines' runs (``_serve``) over
    the steps before their tokens first part, that step included."""
    a, b = a["logits"], b["logits"]
    n = min(len(a), len(b))
    same = (a[:n].argmax(-1) == b[:n].argmax(-1)).reshape(n, -1).all(-1)
    upto = n if same.all() else int(np.argmin(same)) + 1
    return float(np.abs(a[:upto] - b[:upto]).max())


@pytest.mark.parametrize("case", SERVE_BF16)
def test_bf16_serving_within_bf16_rounding(runs, case):
    """bf16 weights and cache on the mesh: every rank's logits within
    twice one rank's bf16 engine's gap from its f32 engine of one rank's
    bf16 logits, and that gap is bf16's (above f32's ``REL``)."""
    ranks, one = runs[0], runs[2]
    want = one["serve_bf16"][case]
    spread = _gap(want, one["serve"][case])
    assert spread > REL * np.abs(want["logits"]).max()
    for r in ranks:
        assert _gap(r["serve_bf16"][case], want) <= 2 * spread


def _cache_part(cfg, key: str, full, model_rank: int, tp: int):
    """This model rank's part of one rank's cache tensor ``key``
    (``mixer/leaf``): the SSM's ``conv_x`` channels and ``state`` heads,
    the RG-LRU's channels, MLA's latent ``ckv`` over ``kv_lora`` (the
    reference's ``head_dim`` cut); the rest whole."""
    if key in ("ssm/conv_x", "rec/conv", "rec/state", "attn/ckv"):
        n = full.shape[-1] // tp
        return full[..., model_rank * n:(model_rank + 1) * n]
    if key == "ssm/state":
        n = full.shape[1] // tp
        return full[:, model_rank * n:(model_rank + 1) * n]
    return full


@pytest.mark.parametrize("case", STEP_CASES)
def test_prefill_and_decode_on_a_mesh(runs, case):
    """``make_prefill_step`` over 48 positions (recurrentgemma's 6-head
    local layer and deepseek's 6-head MLA sharding them, 12 a rank, the
    local layer past its window of 8) and 4 decode steps: every rank's
    logits within ``REL`` (deepseek's ``REL_OF``) of one rank's, each
    rank's cache of the first two layers its slots and its part of one
    rank's cache within 1e-5."""
    arch, mesh, _, fields = CASES[case]
    cfg = _cfg(arch, fields)
    tp = MESHES[mesh][0][-1]
    want = runs[2]["steps"][case]
    for r in runs[0]:
        got = r["steps"][case]
        assert_logits_close(got["logits"], want["logits"],
                            REL_OF.get(arch, REL))
        d = got["data_rank"]
        rows = slice(0, 2) if mesh != "2x2" else slice(d, d + 1)
        for g, w in zip(got["cache"], want["cache"], strict=True):
            assert sorted(g) == sorted(w)
            for k in w:
                part = _cache_part(cfg, k, w[k][rows], got["model_rank"], tp)
                assert g[k].shape == part.shape, k
                np.testing.assert_allclose(g[k], part, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ["one", "1x4"])
def test_checkpoint_restores_into_other_worlds(runs, world):
    """The (2, 2) mamba2 state after two steps, saved, restores into one
    rank and into (1, 4) (every SSM tensor cut another way) with the same
    leaves, bit for bit."""
    c = [r["ckpt"] for r in runs[0]]
    if world == "one":
        assert c[0]["one"]
    else:
        assert all(x[world] for x in c)


def test_reference_restores_the_checkpoint(runs):
    """The reference's ``Checkpointer.restore`` reads the (2, 2) mamba2
    checkpoint into a one-device state: every leaf it asks for is there,
    in its shape, equal to the port's gathered leaf."""
    arch, _, knobs, fields = CASES[CKPT_CASE]
    jcfg = _cfg(arch, fields, jget_arch)
    like = jstate.init_state(jcfg, JRunConfig(**_rc(knobs)),
                             jax.random.PRNGKey(0))
    back, _ = JCheckpointer(str(runs[3] / "ckpt")).restore(like, step=STEPS)
    saved = runs[0][0]["train"][CKPT_CASE]["leaves"]
    flat = _flat(jax.tree.map(np.asarray, back), "")
    shapes = {k: np.shape(v) for k, v in _flat(
        jax.tree.map(np.asarray, like), "").items()}
    assert sorted(flat) == sorted(saved)
    for k, v in flat.items():
        assert v.shape == shapes[k], k
        assert np.array_equal(v, saved[k]), k


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MAMBA, RG, DS])
@pytest.mark.parametrize("tp", [2, 4])
def test_local_shapes_follow_the_reference_rules(arch, tp):
    """At published widths every config runs on a model axis
    (``uncovered`` is None) and a parameter's local shape is the
    reference's ``spec_for`` over ``model``: the SSM's ``Din`` and heads,
    the RG-LRU's width, MLA's heads and the vocabulary split;
    recurrentgemma's 10 heads on 4 ranks stay whole (its attention shards
    the sequence)."""
    cfg = get_arch(arch)
    mesh = _StandInMesh((1, tp), ("data", "model"))
    assert uncovered(cfg, tp) is None
    t = Tp.of(mesh, cfg)
    rules = sharding.make_rules(mesh)
    lm = mdl.LM(cfg, device="meta")
    shapes, dims = tstate.param_shapes(lm), tstate.param_dims(lm)
    cut = 0
    for n, shape in shapes.items():
        spec = sharding.spec_for(shape, dims[n], mesh, rules)
        want = tuple(s // tp if i < len(spec) and spec[i] == "model" else s
                     for i, s in enumerate(shape))
        assert t.local_shape(shape, dims[n]) == want, n
        cut += want != tuple(shape)
    assert cut > cfg.n_layers
    if arch == RG:
        n = "stack.2.attn.w_q"
        assert t.local_shape(shapes[n], dims[n])[1] == (5 if tp == 2
                                                        else 10)


def test_a_mixer_the_ranks_do_not_divide_stays_whole():
    """6 SSD heads on 4 model ranks: the SSM's tensors stay whole on every
    rank (the reference cuts ``Din``, 96, over ``state``), so the mixer
    runs whole; the vocabulary still splits."""
    cfg = _cfg(MAMBA, MAMBA6)
    t = Tp.of(_StandInMesh((1, 4), ("data", "model")), cfg)
    lm = mdl.LM(cfg, device="meta")
    shapes, dims = tstate.param_shapes(lm), tstate.param_dims(lm)
    for n, shape in shapes.items():
        local = t.local_shape(shape, dims[n])
        assert (local != tuple(shape)) == n.startswith("embed."), n


def test_experts_that_do_not_split_still_raise():
    """The one case a model axis does not run, as the reference's
    ``shard_map`` does not: experts that do not split over its ranks (8
    reduced experts on 3). ``check_mesh`` (and so the train step and the
    state) and ``ServeEngine(mesh=)`` raise before any work."""
    from repro_torch.training import make_train_step
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    mesh = _StandInMesh((1, 3), ("data", "model"))
    mesh.device_type = "cpu"
    assert uncovered(cfg, 3) == "8 experts do not split over 3 model ranks"
    for call in (lambda: make_train_step(cfg, RunConfig(), mesh),
                 lambda: tstate.abstract_state(cfg, RunConfig(), mesh),
                 lambda: engine.make_decode_step(cfg, RunConfig(),
                                                 device="cpu", mesh=mesh)):
        with pytest.raises(ValueError, match="8 experts do not split"):
            call()
