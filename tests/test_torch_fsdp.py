"""FSDP over the data axes (``pod_param_mode`` "sharded" and "data") in the
port's train step, held to the JAX package's GSPMD step on the CPU.

One gloo world of 4 ranks (``launch/mesh.py::spawn_world``, one torch
thread a rank) runs every case once (the module fixture ``runs``); the
reference runs the same cases in one subprocess on 4 host devices
(``XLA_FLAGS`` forces the count), its ``make_train_step`` in "sharded" or
"data" mode with the state placed by its own shardings. Both start from
the port's weights for ``SEED`` (``models/convert.py::params_to_numpy``,
written to an ``.npz``: the reference's init folds in ``hash()``, which
differs from one process to the next) and take the same numpy tokens, an
8-row global batch a step, three steps, the first at warm-up learning
rate 0.

Cases (reduced widths): tinyllama with bucketed AdamW on (4,) ("data");
tinyllama in "data" mode on (2, 2) ("pod", "data"), the pods replicas;
tinyllama with two micro-batches; granite-moe with per-tensor AdamW and
remat "dots" (the MoE on a data mesh, each rank chunking its own tokens as
the reference's shards do, and the tied embedding: one gather, one
reduce-scatter of both gradients); deepseek-v3 with Adafactor (factored
statistics over sharded rows, the router-bias update from the summed
loads, MTP).

- Every step's metrics within rtol 1e-4 of the reference's, and the final
  state (as the reference's checkpoint leaves: ``training/state.py::
  checkpoint_leaves``, buckets in the reference's element order) within
  ``test_torch_train.py``'s ``STEP_REL`` of its leaves: parameters with
  the Adam-flip slack of ``assert_states_close``, moments at 5x.
- Every rank's gathered parameters equal, bit for bit (in "data" mode the
  two pods gather from different ranks).
- The port's replicated step on the same mesh gives the same numbers:
  metrics within rtol 1e-5 (1e-4 after the first update), parameters as
  above.
- Each rank's resident bytes of parameters, optimizer state and residuals
  are at most the one-rank state's over F, the FSDP ranks, plus one
  ``pad_multiple`` of elements for each tensor or bucket it holds.
- ``abstract_state`` at full widths, "sharded" on (4,): each rank's bytes
  at most the reference's per-device bytes (``shard_shape`` of each leaf
  of its ``abstract_state``) plus the same padding.
- Checkpoints: a state saved on 4 ranks at step 2 restores into one rank
  and into 2 FSDP ranks with the same leaves; resuming on 4 ranks gives
  the uninterrupted run's losses bit for bit (deterministic algorithms);
  the reference's ``Checkpointer.restore`` reads it into a one-device
  state.
- ``compress_grads`` under "sharded" without ``donate_state``: ``ef``
  sharded and carried unchanged, the numbers the bucketed case's.
- The reference's explicit replicated sync disagrees with its own sharded
  step on the MoE (ROADMAP queue 3); the port's replicated explicit step
  on granite-moe holds to the sharded one (the gradient of the global mean
  loss).
"""
import dataclasses
import hashlib
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
from repro.models import model as jmdl  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro.training import state as jstate  # noqa: E402
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.core import buckets as bk  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.training import state as tstate  # noqa: E402
from test_torch_train import STEP_REL, close_rel  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD, SEED, B, S, STEPS = 4, 3, 8, 16, 3
CASES = {       # name: (arch, mesh shape, axes, RunConfig knobs)
    "adamw_b": ("tinyllama-1.1b", (4,), ("data",), {}),
    "data_mode": ("tinyllama-1.1b", (2, 2), ("pod", "data"),
                  {"pod_param_mode": "data"}),
    "microbatch": ("tinyllama-1.1b", (4,), ("data",), {"microbatch": 2}),
    "moe_per_tensor_dots": ("granite-moe-3b-a800m", (4,), ("data",),
                            {"bucketed_updates": False, "remat": "dots"}),
    "adafactor": ("deepseek-v3-671b", (4,), ("data",), {}),
}
# the reference's sharded step that the port's replicated explicit step on
# granite-moe is held to
EXPLICIT = ("granite-moe-3b-a800m", (4,), ("data",), {})
ABSTRACT = ("tinyllama-1.1b", "granite-moe-3b-a800m", "deepseek-v3-671b")
CKPT_ARCH = "tinyllama-1.1b"


def _rc(knobs) -> dict:
    return dict(steps=10, warmup_steps=1, learning_rate=1e-3, **knobs)


def _tokens(cfg) -> np.ndarray:
    return np.stack([np.random.default_rng(30 + i).integers(
        0, cfg.vocab, (B, S)) for i in range(STEPS)])


def _flat(tree, prefix) -> dict:
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for kk, vv in items
                for k, v in _flat(vv, f"{prefix}{kk}/").items()}
    return {prefix[:-1]: tree}


def _weights(arch, fields=None) -> dict:
    """The port's f32 weights for ``SEED`` as the reference's tree, flat
    (``params/stack/g0/l0/attn/w_q``), every constant-initialised leaf (the
    norm scales) moved by a seeded draw, as ``test_torch_families.
    make_fam`` moves them: a leaf that starts at zero holds only Adam's
    moves, whose roundings are then its whole size. ``fields``: the
    reduced config's fields to replace (e.g. its head counts)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), **(fields or {}))
    lm = mdl.init(cfg, SEED, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    out = {}
    for k, a in _flat(convert.params_to_numpy(lm, cfg), "params/").items():
        if a.size > 1 and np.all(a == a.flat[0]):
            a = a + (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        out[k] = a
    return out


# ---------------------------------------------------------------------------
# the reference, in a subprocess on 4 host devices
# ---------------------------------------------------------------------------

_REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.checkpoint.checkpointing import _flatten_with_paths
from repro.configs import RunConfig, get_arch
from repro.core.compat import make_mesh
from repro.parallel.sharding import make_rules, use_mesh
from repro.training import state as jstate, step as jstep

z = np.load(sys.argv[1])
spec = json.loads(str(z["spec"]))
res, arrays = {"metrics": {}, "abstract": {}}, {}


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
    rc = RunConfig(**c["rc"])
    mesh = make_mesh(tuple(c["shape"]), tuple(c["axes"]))
    fn, _, st_sh, rules = jstep.make_train_step(cfg, rc, mesh)
    with use_mesh(mesh, rules):
        st = jstate.init_state(cfg, rc, jax.random.PRNGKey(0), mesh)
    pre = c["arch"] + "|params/"
    st["params"] = nest({k[len(pre):]: z[k] for k in z.files
                         if k.startswith(pre)})
    st = jax.device_put(st, st_sh)
    mets = []
    for i, toks in enumerate(z[c["arch"] + "|tokens"]):
        with use_mesh(mesh, rules):
            st, m = fn(st, {"tokens": jnp.asarray(toks)})
        mets.append({k: float(v) for k, v in m.items()})
        if i == 0 and c.get("first"):
            for k, v in _flatten_with_paths(st["opt"]["m"]).items():
                arrays[f"{case}#first|opt/m/{k}"] = np.asarray(v)
    res["metrics"][case] = mets
    for k, v in _flatten_with_paths(st).items():
        arrays[case + "|" + k] = np.asarray(v)
for arch in spec["abstract"]:
    mesh = make_mesh((4,), ("data",))
    a = jstate.abstract_state(get_arch(arch), RunConfig(), mesh,
                              make_rules(mesh))
    res["abstract"][arch] = sum(
        int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
        for x in jax.tree.leaves(a))
np.savez(sys.argv[2], meta=json.dumps(res), **arrays)
'''


def _start_reference(tmp: Path) -> tuple:
    cases = {name: {"arch": a, "shape": list(sh), "axes": list(ax),
                    "rc": _rc(kn)} for name, (a, sh, ax, kn) in
             CASES.items()}
    a, sh, ax, kn = EXPLICIT
    cases["explicit"] = {"arch": a, "shape": list(sh), "axes": list(ax),
                         "rc": _rc(kn), "first": True}
    cases["reference_explicit"] = dict(cases["explicit"], rc=_rc(dict(
        kn, pod_param_mode="replicated", hierarchical_sync=True)))
    arrays, weights = {}, {}
    for arch in sorted({c["arch"] for c in cases.values()}):
        cfg = get_arch(arch).reduced()
        weights[arch] = _weights(arch)
        arrays.update({f"{arch}|{k}": v for k, v in weights[arch].items()})
        arrays[f"{arch}|tokens"] = _tokens(cfg)
    src, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, spec=json.dumps({"cases": cases, "abstract": ABSTRACT}),
             **arrays)
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

def _resident_bytes(st) -> int:
    """Parameters, optimizer state and residuals this rank holds."""
    ts = list(st["params"].parameters())

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        else:
            ts.append(x)
    walk(st["opt"])
    walk(st.get("ef", {}))
    return sum(t.numel() * t.element_size() for t in ts)


def _held(st) -> int:
    """Tensors (a bucket counts once) of ``_resident_bytes``."""
    n = len(list(st["params"].parameters()))
    for tree in (st["opt"], st.get("ef", {})):
        n += len(jax.tree.leaves(tree, is_leaf=torch.is_tensor))
    return n


def _leaves(st) -> dict:
    """The state as the reference's checkpoint leaves (a collective under
    FSDP: every rank calls it)."""
    return {k: lf.get().detach().cpu().numpy().copy()
            for k, lf in tstate.checkpoint_leaves(st).items()}


def _digest(leaves: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(leaves):
        if k.startswith("params/"):
            h.update(k.encode() + leaves[k].tobytes())
    return h.hexdigest()


def _run(arch, shape, axes, knobs, rank, weights):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import init_state, make_train_step
    cfg = get_arch(arch).reduced()
    mesh = make_mesh(shape, axes, device_type="cpu")
    rc = RunConfig(**_rc(knobs))
    st = init_state(cfg, rc, SEED, mesh, device="cpu", dtype=torch.float32)
    leaves = tstate.checkpoint_leaves(st)
    for k, v in weights[arch].items():     # each rank keeps its rows
        leaves[k].put(torch.from_numpy(v))
    fn = make_train_step(cfg, rc, mesh)
    mets = []
    for toks in _tokens(cfg):
        st, m = fn(st, {"tokens": toks})
        mets.append({k: v.item() for k, v in m.items()})
    leaves = _leaves(st)
    return {"metrics": mets, "digest": _digest(leaves),
            "bytes": _resident_bytes(st), "held": _held(st),
            "leaves": leaves if rank == 0 else None}


def _checkpoints(rank, tmp: str) -> dict:
    """``train()`` on 4 ranks: 4 steps straight, and 2 + a resume of 2
    from the step-2 checkpoint (deterministic algorithms); the step-2
    state restored into 2 FSDP ranks ("data" on (2, 2)) and, on rank 0,
    into one rank."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import init_state
    cfg = get_arch(CKPT_ARCH).reduced()
    rc = RunConfig(**_rc({"remat": "none"}))
    mesh = make_mesh((4,), ("data",), device_type="cpu")
    kw = dict(batch=B, seq=S, mesh=mesh, device="cpu", dtype=torch.float32,
              log_every=1000)
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
    two = make_mesh((2, 2), ("pod", "data"), device_type="cpu")
    rc2 = RunConfig(**_rc({"remat": "none", "pod_param_mode": "data"}))
    st = init_state(cfg, rc2, SEED + 1, two, device="cpu",
                    dtype=torch.float32)
    Checkpointer(f"{tmp}/b").restore(st, step=2)
    into_two = _leaves(st)
    out = {"full": full, "resumed": resumed,
           "same_in_two": all(np.array_equal(into_two[k], v)
                              for k, v in saved.items()),
           "keys_in_two": sorted(into_two) == sorted(saved)}
    if rank == 0:
        one = init_state(cfg, RunConfig(**_rc({"remat": "none"})), SEED + 1,
                         device="cpu", dtype=torch.float32)
        Checkpointer(f"{tmp}/b").restore(one, step=2)
        into_one = _leaves(one)
        out.update(saved=saved, keys_in_one=sorted(into_one) == sorted(saved),
                   same_in_one=all(np.array_equal(into_one[k], v)
                                   for k, v in saved.items()))
    return out


def _carry_ef(rank, weights) -> dict:
    """"sharded" with ``compress_grads`` and without ``donate_state``:
    each step returns a new state; its ``ef`` is this rank's shard of the
    one-rank residuals and stays zero (the reference's GSPMD step builds
    ``ef`` and never touches it)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import init_state, make_train_step
    arch = "tinyllama-1.1b"
    cfg = get_arch(arch).reduced()
    mesh = make_mesh((4,), ("data",), device_type="cpu")
    rc = RunConfig(**_rc({"compress_grads": True, "donate_state": False}))
    st = init_state(cfg, rc, SEED, mesh, device="cpu", dtype=torch.float32)
    leaves = tstate.checkpoint_leaves(st)
    for k, v in weights[arch].items():
        leaves[k].put(torch.from_numpy(v))
    fn = make_train_step(cfg, rc, mesh)
    mets, fresh = [], []
    for toks in _tokens(cfg):
        new, m = fn(st, {"tokens": toks})
        fresh.append(new is not st and new["params"] is not st["params"])
        st = new
        mets.append({k: v.item() for k, v in m.items()})
    return {"metrics": mets, "fresh": fresh,
            "ef_numel": [e.numel() for e in st["ef"]],
            "ef_zero": all(not e.any() for e in st["ef"]),
            "digest": _digest(_leaves(st))}


def _rank(rank, world, tmp, weights):
    torch.set_num_threads(1)     # the ranks share the machine's cores
    out = {}
    for name, (arch, shape, axes, knobs) in CASES.items():
        out[name] = {
            "fsdp": _run(arch, shape, axes, knobs, rank, weights),
            "replicated": _run(arch, shape, axes,
                               _replicated_knobs(arch, knobs), rank,
                               weights)}
    arch, shape, axes, knobs = EXPLICIT
    out["explicit"] = _run(arch, shape, axes,
                           dict(knobs, pod_param_mode="replicated",
                                hierarchical_sync=True), rank, weights)
    out["carry_ef"] = _carry_ef(rank, weights)
    out["ckpt"] = _checkpoints(rank, tmp)
    return out


def _replicated_knobs(arch, knobs) -> dict:
    """The replicated step for a case: the explicit sync where it takes
    the call (bucketed, not Adafactor), the per-tensor all-reduce
    otherwise."""
    explicit = (knobs.get("bucketed_updates", True) and
                get_arch(arch).optimizer != "adafactor")
    return dict(knobs, pod_param_mode="replicated",
                hierarchical_sync=explicit)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the port's results by rank, the reference's results)."""
    from repro_torch.launch.mesh import spawn_world
    tmp = tmp_path_factory.mktemp("fsdp")
    proc, out, weights = _start_reference(tmp)
    try:
        ranks = spawn_world(_rank, WORLD, str(tmp), weights, init_file=str(
            tmp / "store"), timeout_s=900)
    except BaseException:
        proc.kill()
        raise
    return ranks, _finish_reference(proc, out), tmp


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def assert_leaves_close(got: dict, want: dict, rel: float, lr: float):
    """The port's checkpoint leaves against the reference's state leaves
    (``assert_states_close``'s bounds): parameters within ``rel`` of each
    leaf's max but the Adam flips, router biases and Adafactor's states
    within ``rel``, moments 5 ``rel``; a reference bucket is padded to its
    mesh, the port's holds the real elements. After three steps the third
    gradient is taken at weights the second step's Adam flips moved, so a
    moment element that is the small difference of large terms may pass
    its bound too: at most a thousandth of a leaf's elements, none past
    ``FLIP_REL`` (granite's explicit case: 2 of 140,608 at 1.08e-4)."""
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        if k.startswith(("opt/m/", "opt/v/")) and w.shape != g.shape:
            assert not np.any(w[g.shape[0]:]), k
            w = w[:g.shape[0]]
        if k == "step":
            assert int(g) == int(w)
        elif k.startswith("params/"):
            top = max(float(np.abs(w).max()), 1e-30)
            close_rel(g, w, rel, k, True, loose=max(2 * lr / top, 0.0))
        elif k.startswith(("opt/m/", "opt/v/")):
            close_rel(g, w, 5 * rel, k, True)
        else:
            close_rel(g, w, rel, k)


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_matches_the_reference_sharded_step(runs, case):
    """Every step's metrics within rtol 1e-4 of the reference's GSPMD step
    on a 4-device mesh in the same mode; the final parameters, biases and
    moments (bucketed ones element by element in the reference's order)
    close to its state's."""
    ranks, ref, _ = runs
    arch = CASES[case][0]
    got = ranks[0][case]["fsdp"]
    want = ref["metrics"][case]
    for i, (g, w) in enumerate(zip(got["metrics"], want, strict=True)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert_leaves_close(got["leaves"], ref["leaves"][case],
                        STEP_REL.get(arch, 2e-5), 1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_parameters_equal_across_ranks(runs, case):
    """Every rank gathers the same parameters, bit for bit, and reports
    the same metrics."""
    ranks = [r[case]["fsdp"] for r in runs[0]]
    assert len({r["digest"] for r in ranks}) == 1
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_equals_the_replicated_step_on_the_mesh(runs, case):
    """The port's replicated step on the same mesh (each rank chunks the
    same tokens) computes the same function: metrics within rtol 1e-5
    (1e-4 after the first update), parameters within 2e-5 of each leaf's
    max but the Adam flips."""
    got = runs[0][0][case]["fsdp"]
    want = runs[0][0][case]["replicated"]
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"],
                                   strict=True)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k],
                                       rtol=1e-5 if i < 2 else 1e-4,
                                       err_msg=f"step {i} {k}")
    for k, w in want["leaves"].items():
        if k.startswith("params/"):
            top = max(float(np.abs(w).max()), 1e-30)
            close_rel(got["leaves"][k], w, STEP_REL.get(CASES[case][0],
                                                         2e-5),
                      k, True, loose=2e-3 / top)


@pytest.mark.parametrize("case", list(CASES))
def test_resident_bytes_are_a_shard(runs, case):
    """Each rank holds at most 1/F of the one-rank state's parameter,
    optimizer and residual bytes (F the FSDP ranks: 4 "sharded" on (4,), 2
    "data" on (2, 2)), plus one ``pad_multiple`` of f32 elements for each
    tensor or bucket it holds."""
    arch, shape, axes, knobs = CASES[case]
    cfg = get_arch(arch).reduced()
    F = 2 if knobs.get("pod_param_mode") == "data" else 4
    one = tstate.abstract_state(cfg, RunConfig(**_rc(knobs)),
                                dtype=torch.float32)
    whole = _resident_bytes(one)
    for r in runs[0]:
        got = r[case]["fsdp"]
        assert got["bytes"] <= whole / F + 4 * math.prod(shape) * \
            got["held"], (got["bytes"], whole / F)


class _StandInMesh:
    """Only the axis names and sizes are read."""

    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("arch", ABSTRACT)
def test_abstract_state_per_rank_bytes_within_the_reference(runs, arch):
    """Full widths on ``meta``, "sharded" on (4,): a rank's bytes (the
    whole state: parameters, biases, optimizer, step) are at most the
    reference's per-device bytes plus one ``pad_multiple`` of elements a
    tensor, and about a quarter of the one-rank state's."""
    cfg = get_arch(arch)
    st = tstate.abstract_state(cfg, RunConfig(),
                               _StandInMesh((4,), ("data",)))
    assert all(p.is_meta for p in st["params"].parameters())
    ts = [t for t in jax.tree.leaves(
        {k: v for k, v in st.items() if k not in ("params", "layout")},
        is_leaf=torch.is_tensor)] + list(st["params"].parameters())
    got = sum(t.numel() * t.element_size() for t in ts)
    ref = runs[1]["abstract"][arch]
    assert got <= ref + 4 * 4 * len(ts), (got, ref)
    one = tstate.abstract_state(cfg, RunConfig())
    whole = sum(t.numel() * t.element_size() for t in jax.tree.leaves(
        {k: v for k, v in one.items() if k not in ("params", "layout")},
        is_leaf=torch.is_tensor) + list(one["params"].parameters()))
    assert got <= whole / 4 * 1.01 + 4 * 4 * len(ts), (got, whole)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_resume_on_four_ranks_is_bitwise(runs):
    """4 steps straight against 2, a checkpoint, and 2 resumed from it,
    every rank under deterministic algorithms: the same losses, bit for
    bit."""
    for r in runs[0]:
        c = r["ckpt"]
        assert c["full"][2:] == c["resumed"], (c["full"], c["resumed"])
        assert all(np.isfinite(c["full"]))


@pytest.mark.parametrize("ranks", [1, 2])
def test_sharded_checkpoint_restores_into_other_worlds(runs, ranks):
    """The step-2 checkpoint written by 4 FSDP ranks restores into one
    rank and into 2 FSDP ranks (pods as replicas) with the same leaves,
    bit for bit; its manifest names the mesh, and every file is written
    once a replica."""
    c = [r["ckpt"] for r in runs[0]]
    if ranks == 1:
        assert c[0]["keys_in_one"] and c[0]["same_in_one"]
    else:
        assert all(x["keys_in_two"] and x["same_in_two"] for x in c)
    d = runs[2] / "b" / "step_00000002"
    manifest = json.load(open(d / "manifest.json"))
    assert manifest["mesh_shape"] == [4]
    files = sorted(str(p.relative_to(d)) for p in d.rglob("*.npy"))
    assert len(files) == 2 * len(manifest["leaves"])
    assert sorted(manifest["leaves"]) == sorted(c[0]["saved"])


def test_reference_restores_the_sharded_checkpoint(runs):
    """The reference's ``Checkpointer.restore`` reads the port's sharded
    checkpoint into a one-device state: every leaf it asks for is there,
    in its shape, equal to the port's gathered leaf."""
    jcfg = jget_arch(CKPT_ARCH).reduced()
    like = jstate.init_state(jcfg, JRunConfig(**_rc({"remat": "none"})),
                             jax.random.PRNGKey(0))
    back, manifest = JCheckpointer(str(runs[2] / "b")).restore(like, step=2)
    saved = runs[0][0]["ckpt"]["saved"]
    flat = {k: np.asarray(v) for k, v in _flat(
        jax.tree.map(np.asarray, back), "").items()}
    want_shapes = {k: np.shape(v) for k, v in _flat(
        jax.tree.map(np.asarray, like), "").items()}
    assert sorted(flat) == sorted(saved)
    for k, v in flat.items():
        assert v.shape == want_shapes[k], k
        assert np.array_equal(v, saved[k]), k


def test_sharded_step_carries_ef_without_donation(runs):
    """``compress_grads`` under "sharded" builds ``ef`` as this rank's
    bucket shards (a quarter of the one-rank buckets) and carries it
    unchanged, as the reference's GSPMD step does, so the step computes
    what it computes without it: the metrics and parameters of the
    bucketed case bit for bit. Without ``donate_state`` every step returns
    a new state and a new LM."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    one = tstate.abstract_state(cfg, RunConfig(**_rc({
        "compress_grads": True})), dtype=torch.float32)
    for r in runs[0]:
        got = r["carry_ef"]
        assert all(got["fresh"]) and got["ef_zero"]
        assert got["metrics"] == r["adamw_b"]["fsdp"]["metrics"]
        assert got["digest"] == r["adamw_b"]["fsdp"]["digest"]
        assert sum(got["ef_numel"]) * 4 == sum(e.numel() for e in one["ef"])


# ---------------------------------------------------------------------------
# the reference's explicit sync on the MoE (a reference fault)
# ---------------------------------------------------------------------------

def test_replicated_explicit_step_holds_to_the_reference_sharded_step(runs):
    """granite-moe, bucketed AdamW, 4 ranks: the port's replicated step
    with the explicit (hierarchical) sync against the reference's sharded
    step, which computes the gradient of the global mean loss (the
    reference's own explicit sync does not, ROADMAP queue 3): metrics
    within rtol 1e-4, the state as in the FSDP cases."""
    ranks, ref, _ = runs
    got = ranks[0]["explicit"]
    for i, (g, w) in enumerate(zip(got["metrics"], ref["metrics"]["explicit"],
                                   strict=True)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert_leaves_close(got["leaves"], ref["leaves"]["explicit"], 2e-5, 1e-3)


def test_reference_explicit_sync_shrinks_the_moe_gradient(runs):
    """The reference fault the test above steers around (ROADMAP queue 3):
    the reference's replicated step with the explicit sync on granite-moe
    (2 MoE layers) returns its sharded step's loss but not its gradient.
    After the first step (learning rate 0, so the first moment is a tenth
    of the synced gradient) every leaf downstream of the last MoE layer's
    input (the final norm, that layer's experts and router) is the sharded
    step's; the cotangent that flows back into a MoE layer's input through
    ``moe_apply``'s nested ``shard_map`` inside the manual region comes
    back divided by the data-parallel size, 4, so a leaf upstream of it
    shrinks: through both MoE layers (layer 0's attention) to about a
    quarter, through one (layer 1's attention, which the residual also
    reaches) to about 0.6."""
    ref = runs[1]
    cfg = get_arch(EXPLICIT[0]).reduced()
    sharded, explicit = ref["metrics"]["explicit"], \
        ref["metrics"]["reference_explicit"]
    assert sharded[0]["loss"] == pytest.approx(explicit[0]["loss"], rel=1e-6)
    assert explicit[0]["grad_norm"] < 0.5 * sharded[0]["grad_norm"]
    plan = tstate.make_bucket_plan(cfg, RunConfig(), None, mdl.LM(
        cfg, device="meta", dtype=torch.float32))
    ratio = {}
    for n, (bi, off), size in zip(tstate.ordered_names(cfg), plan.assign,
                                  plan.sizes):
        norm = {c: np.linalg.norm(ref["leaves"][c + "#first"][f"opt/m/{bi}"]
                                  [off:off + size])
                for c in ("explicit", "reference_explicit")}
        ratio[n] = norm["reference_explicit"] / norm["explicit"]
    last = cfg.n_layers - 1
    for n, r in ratio.items():
        if n == "final_norm.scale" or n.startswith(f"stack.{last}.moe."):
            assert r == pytest.approx(1.0, rel=1e-4), (n, r)
        elif n.startswith("stack.0.attn."):
            assert 0.15 < r < 0.35, (n, r)
        else:
            assert r < 0.75, (n, r)


# ---------------------------------------------------------------------------
# pieces: spec_for, bucket shards, the model-axis repair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ABSTRACT)
def test_spec_for_matches_the_reference(arch):
    """``spec_for`` gives the reference's partition of every parameter at
    full widths, "sharded" and "data" on (2, 4) pod x data and on a
    (2, 2, 2) mesh with a model axis."""
    jschema, _ = jmdl.model_schema(jget_arch(arch))
    for shape, axes in (((2, 4), ("pod", "data")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        mesh = _StandInMesh(shape, axes)
        for mode in ("sharded", "data"):
            rules = sharding.make_rules(mesh, pod_param_mode=mode)
            jrules = jsharding.AxisRules(rules=dict(rules.rules))
            specs = {}
            jsharding.tree_map_schema(
                lambda path, pd: specs.__setitem__(path, (pd.shape, pd.dims)),
                jschema)
            for path, (shp, dims) in specs.items():
                want = _ref_spec(shp, dims, shape, axes, jrules)
                got = sharding.spec_for(shp, dims, mesh, rules)
                assert got == want, (path, got, want)


def _ref_spec(shape, dims, mesh_shape, axes, rules):
    """The reference's ``spec_for`` on a mesh of ``mesh_shape``, as a
    tuple."""
    class M:
        axis_names = axes
        shape = dict(zip(axes, mesh_shape))
    return tuple(jsharding.spec_for(shape, dims, M, rules))


def test_bucket_shards_round_trip():
    """``shard_plan``, ``shard_bucket`` and ``unshard_bucket``: tensors of
    sizes that do not divide the ranks, split into 3 ranks' buckets and put
    back, give the reference-order bucket; each rank's bucket is its
    tensors' shards laid end to end."""
    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(n, generator=g) for n in (7, 12, 5, 9)]
    plan = bk.make_plan([ts[0], (ts[1], ts[2]), ts[3]], bucket_bytes=80,
                        pad_multiple=4)
    R = 3
    ks = [-(-t.numel() // R) for t in ts]
    splan = bk.shard_plan(plan, ks)
    full = bk.flatten(plan, ts)
    for bi, b in enumerate(full):
        real = b[:bk.real_sizes(plan)[bi]]
        mine = [bk.shard_bucket(plan, splan, bi, real, i) for i in range(R)]
        assert all(m.shape[0] == splan.bucket_sizes[bi] for m in mine)
        assert torch.equal(bk.unshard_bucket(plan, splan, bi,
                                             torch.stack(mine)), real)
    shards = [[torch.nn.functional.pad(t[i * k:(i + 1) * k],
                                       (0, k - t[i * k:(i + 1) * k].numel()))
               for t, k in zip(ts, ks)] for i in range(R)]
    for i in range(R):
        got = bk.flatten(splan, shards[i])
        for bi, b in enumerate(got):
            assert torch.equal(b, bk.shard_bucket(
                plan, splan, bi, full[bi][:bk.real_sizes(plan)[bi]], i))


class _RankZeroMesh(_StandInMesh):
    """A stand-in that is rank 0 of every axis, on the CPU."""
    device_type = "cpu"

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("entry", ["make_train_step", "init_state",
                                   "abstract_state"])
@pytest.mark.parametrize("arch,item", [("granite-moe-3b-a800m", 3),
                                       ("tinyllama-1.1b", 5)])
def test_a_model_axis_is_not_ported(entry, arch, item):
    """A mesh whose ``model`` axis is larger than 1. Items 3 and 5 are
    ported: on (1, 2) granite-moe (experts over ``model``, ``E_pad / 2`` a
    rank, and tensor parallelism) and tinyllama (tensor parallelism) are
    taken in "sharded" (one data rank: no FSDP), per-tensor "replicated"
    and explicit "replicated" modes, each rank holding half the query
    heads and half the vocabulary rows. So are the mixers that are not GQA
    (item 5's rest): mamba2's SSM holds half its SSD heads and their
    channels a rank, recurrentgemma's RG-LRU half its state channels (its
    gate blocks whole), and tinyllama's 4 reduced heads on 8 ranks stay
    whole (its attention shards the sequence) beside an eighth of the
    vocabulary."""
    from repro_torch.training import init_state, make_train_step
    cfg = get_arch(arch).reduced()
    mesh = _RankZeroMesh((1, 2), ("data", "model"))

    def calls(cfg, rc, mesh):
        return {"make_train_step": lambda: make_train_step(cfg, rc, mesh),
                "init_state": lambda: init_state(cfg, rc, 0, mesh,
                                                 device="cpu"),
                "abstract_state": lambda: tstate.abstract_state(cfg, rc,
                                                                mesh)}
    for knobs in ({}, {"pod_param_mode": "replicated",
                       "hierarchical_sync": False},
                  {"pod_param_mode": "replicated"}):
        rc = RunConfig(**knobs)
        got = calls(cfg, rc, mesh)[entry]()
        if entry == "make_train_step":
            assert callable(got)
            continue
        H, Vp = cfg.n_heads, cfg.vocab_padded
        lm = got["params"]
        assert lm.embed.shapes["tok"] == (Vp, cfg.d_model)
        for layer in lm.stack:
            assert layer.attn.shapes["w_q"][1] == H
            if "moe" in layer:
                E = cfg.moe.n_experts_padded
                for n in ("w_gate", "w_up", "w_down"):
                    assert layer.moe.shapes[n][0] == E
                    assert layer.moe[n].shape[0] == E // 2, n
                assert layer.moe["router"].shape == (cfg.d_model, E)
            assert layer.attn["w_q"].shape[1] == H // 2
        assert lm.embed["tok"].shape == (Vp // 2, cfg.d_model)
    if item != 5:
        return
    for name in ("mamba2-1.3b", "recurrentgemma-2b"):
        c = get_arch(name).reduced()
        got = calls(c, RunConfig(), mesh)[entry]()
        if entry == "make_train_step":
            assert callable(got)
            continue
        D = c.d_model
        for layer in got["params"].stack:
            if "ssm" in layer:
                s = layer.ssm
                Din, Hs = c.ssm.d_inner(D), c.ssm.n_heads(D)
                assert s["w_z"].shape == s["w_x"].shape == (D, Din // 2)
                assert s["w_dt"].shape == (D, Hs // 2)
                assert s["A_log"].shape == (Hs // 2,)
                assert s["gn"].shape == (Din // 2,)
                assert s["w_out"].shape == (Din // 2, D)
                assert s["w_B"].shape == s.shapes["w_B"]
            if "rec" in layer:
                r, W = layer.rec, c.rglru.lru_width
                assert r["w_in"].shape == (D, W // 2)
                assert r["conv"].shape == (c.rglru.conv_width, W // 2)
                assert r["w_out"].shape == (W // 2, D)
                assert r["w_r"].shape == r.shapes["w_r"]
                assert r["lam"].shape == (W,)
            if "attn" in layer:
                assert layer.attn["w_q"].shape[1] == c.n_heads // 2
    got = calls(cfg, RunConfig(), _RankZeroMesh((1, 8), ("data", "model"))
                )[entry]()
    if entry == "make_train_step":
        assert callable(got)
        return
    lm = got["params"]
    for layer in lm.stack:
        assert layer.attn["w_q"].shape == layer.attn.shapes["w_q"]
        assert layer.ffn["w_up"].shape[1] == cfg.d_ff // 8
    assert lm.embed["tok"].shape == (cfg.vocab_padded // 8, cfg.d_model)


@pytest.mark.parametrize("entry", ["make_train_step", "init_state",
                                   "abstract_state"])
def test_the_explicit_sync_on_a_model_axis_is_not_ported(entry):
    """The explicit replicated sync (``hierarchical_sync``, the default,
    or ``compress_grads`` in "replicated" mode) on a ``model`` axis is
    taken (ROADMAP queue 1 item 3): each rank's buckets hold the copies
    over ``model`` whole, first, then its part of each cut tensor, and
    ``ef`` (under ``compress_grads``) is laid out on that plan."""
    from repro_torch.training import init_state, make_train_step
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    mesh = _RankZeroMesh((1, 2), ("data", "model"))
    for knobs in ({}, {"hierarchical_sync": False, "compress_grads": True}):
        rc = RunConfig(pod_param_mode="replicated", **knobs)
        call = {"make_train_step": lambda: make_train_step(cfg, rc, mesh),
                "init_state": lambda: init_state(cfg, rc, 0, mesh,
                                                 device="cpu"),
                "abstract_state": lambda: tstate.abstract_state(cfg, rc,
                                                                mesh)}
        got = call[entry]()
        if entry == "make_train_step":
            assert callable(got)
            continue
        lay = got["layout"]
        whole = sum(p.numel() for p in mdl.LM(cfg, device="meta")
                    .parameters())
        mine = sum(p.numel() for p in got["params"].parameters())
        assert sum(lay.splan.bucket_sizes) == mine < whole
        assert [b.numel() for b in got["opt"]["m"]] == \
            list(lay.splan.bucket_sizes)
        assert all(0 < c <= n for c, n in zip(lay.copies,
                                              lay.splan.bucket_sizes))
        if rc.compress_grads:
            assert [e.numel() for e in got["ef"]] == \
                list(lay.splan.bucket_sizes)
