"""``tests/md_check.py::check_train_step_sharded`` for the port: reduced
TinyLlama on a (2, 2, 2) pod x data x model mesh of 8 gloo ranks, tensor
parallel over ``model`` (``parallel/tp.py``), in "sharded" mode (FSDP over
pod and data) and in "replicated" mode with the explicit sync
(``hierarchical_sync``: the buckets of each rank's plan reduce-scattered
over ``data``, summed over ``pod``, int8 there under ``compress_grads``,
gathered over ``data``; the copies over ``model`` and the cut parts of a
bucket as two vectors). granite-moe (experts over ``model`` too) alike.

The reference's GSPMD step runs in one subprocess on 8 host devices
(``XLA_FLAGS`` forces the count). Both sides start from the port's f32
weights for ``SEED`` (``test_torch_fsdp._weights``) and take the same
numpy tokens, [8, 32] a step, two steps, ``remat="none"`` as md_check
runs them.

- "sharded": every step's loss and gradient norm within rtol 1e-4 of the
  reference's sharded step.
- The explicit step with ``compress_grads``: every step's loss within
  0.15 of the reference's sharded loss (md_check's bound), every rank the
  same numbers.
- The explicit step without it: within rtol 1e-5 of the port's
  per-tensor replicated step on the same mesh (granite's too: the
  reference's own explicit sync shrinks the MoE gradient, ROADMAP queue
  3, so it is no oracle there).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from test_torch_fsdp import SEED, _weights  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD, STEPS, B, S = 8, 2, 8, 32
SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
TINY, GRANITE = "tinyllama-1.1b", "granite-moe-3b-a800m"
MODES = {
    "sharded": {"pod_param_mode": "sharded"},
    "explicit_int8": {"pod_param_mode": "replicated", "compress_grads": True,
                      "hierarchical_sync": True},
    "explicit": {"pod_param_mode": "replicated", "hierarchical_sync": True},
    "per_tensor": {"pod_param_mode": "replicated", "hierarchical_sync": False,
                   "bucketed_updates": False},
}


def _cfg(arch):
    import dataclasses
    cfg = get_arch(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0))
    return cfg


def _rc(knobs) -> dict:
    return dict(remat="none", steps=10, warmup_steps=1, learning_rate=1e-3,
                **knobs)


def _tokens(cfg) -> np.ndarray:
    return np.stack([np.random.default_rng(50 + i).integers(
        0, cfg.vocab, (B, S)) for i in range(STEPS)])


_REFERENCE = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import RunConfig, get_arch
from repro.core.compat import make_mesh
from repro.parallel.sharding import use_mesh
from repro.training import state as jstate, step as jstep

z = np.load(sys.argv[1])
spec = json.loads(str(z["spec"]))
res = {}


def nest(flat):
    tree = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
for arch in spec["archs"]:
    cfg = get_arch(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0))
    rc = RunConfig(**spec["rc"])
    fn, _, st_sh, rules = jstep.make_train_step(cfg, rc, mesh)
    with use_mesh(mesh, rules):
        st = jstate.init_state(cfg, rc, jax.random.PRNGKey(0), mesh)
    pre = arch + "|params/"
    st["params"] = nest({k[len(pre):]: z[k] for k in z.files
                         if k.startswith(pre)})
    st = jax.device_put(st, st_sh)
    mets = []
    for toks in z[arch + "|tokens"]:
        with use_mesh(mesh, rules):
            st, m = fn(st, {"tokens": jnp.asarray(toks)})
        mets.append({k: float(v) for k, v in m.items()})
    res[arch] = mets
print("RESULT " + json.dumps(res))
'''


def _start_reference(tmp: Path) -> tuple:
    arrays, weights = {}, {}
    for arch in (TINY, GRANITE):
        weights[arch] = _weights(arch)
        arrays.update({f"{arch}|{k}": v for k, v in weights[arch].items()})
        arrays[f"{arch}|tokens"] = _tokens(_cfg(arch))
    src = tmp / "in.npz"
    np.savez(src, spec=json.dumps({"archs": [TINY, GRANITE],
                                   "rc": _rc(MODES["sharded"])}), **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(src)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, weights


def _finish_reference(proc) -> dict:
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    line = [s for s in log.splitlines() if s.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _rank(rank, world, weights):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import init_state, make_train_step
    from repro_torch.training import state as tstate
    torch.set_num_threads(1)
    mesh = make_mesh(SHAPE, AXES, device_type="cpu")
    out = {}
    for arch in (TINY, GRANITE):
        cfg = _cfg(arch)
        for mode, knobs in MODES.items():
            rc = RunConfig(**_rc(knobs))
            st = init_state(cfg, rc, SEED, mesh, device="cpu",
                            dtype=torch.float32)
            leaves = tstate.checkpoint_leaves(st)
            for k, v in weights[arch].items():
                leaves[k].put(torch.from_numpy(v))
            fn = make_train_step(cfg, rc, mesh)
            mets = []
            for toks in _tokens(cfg):
                st, m = fn(st, {"tokens": toks})
                mets.append({k: v.item() for k, v in m.items()})
            out[f"{arch}|{mode}"] = mets
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the port's metrics by rank, the reference's sharded metrics)."""
    from repro_torch.launch.mesh import spawn_world
    tmp = tmp_path_factory.mktemp("tp_pod")
    proc, weights = _start_reference(tmp)
    try:
        ranks = spawn_world(_rank, WORLD, weights, init_file=str(
            tmp / "store"), timeout_s=900)
    except BaseException:
        proc.kill()
        raise
    return ranks, _finish_reference(proc)


@pytest.mark.parametrize("arch", [TINY, GRANITE])
def test_sharded_matches_the_reference_on_the_pod_mesh(runs, arch):
    """"sharded" (FSDP over pod and data, tensor parallel over model): the
    loss and the gradient norm of both steps within rtol 1e-4 of the
    reference's."""
    ranks, ref = runs
    for r in ranks:
        for g, w in zip(r[f"{arch}|sharded"], ref[arch], strict=True):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                           err_msg=k)


@pytest.mark.parametrize("arch", [TINY, GRANITE])
def test_explicit_compressed_sync_within_md_check_bound(runs, arch):
    """The explicit replicated step with ``compress_grads`` and
    ``hierarchical_sync``: both losses within 0.15 of the reference's
    sharded losses, finite, and the same on every rank."""
    ranks, ref = runs
    got = ranks[0][f"{arch}|explicit_int8"]
    assert all(r[f"{arch}|explicit_int8"] == got for r in ranks)
    for g, w in zip(got, ref[arch], strict=True):
        assert abs(g["loss"] - w["loss"]) < 0.15, (g, w)
        assert np.isfinite(g["grad_norm"])


@pytest.mark.parametrize("arch", [TINY, GRANITE])
def test_explicit_sync_equals_the_per_tensor_step(runs, arch):
    """The explicit step without compression: within rtol 1e-5 of the
    port's per-tensor replicated step on the same mesh, on every rank."""
    for r in runs[0]:
        for g, w in zip(r[f"{arch}|explicit"], r[f"{arch}|per_tensor"],
                        strict=True):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=k)
