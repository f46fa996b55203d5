"""Serving on a mesh (``serving/engine.py``'s ``mesh=``): the model tensor
parallel over the ``model`` ranks (``parallel/tp.py``), the slots over
the data ranks, held to one rank's engine and to the JAX package's engine
on the same mesh, on the CPU.

One gloo world of 4 ranks (``launch/mesh.py::spawn_world``) runs every
case once (the module fixture ``runs``); the reference runs the same cases
in one subprocess on 4 host devices (its (1, 2) mesh takes the first
two). Both compute from the port's f32 weights for ``SEED``
(``test_torch_fsdp._weights``, the constant leaves moved by a draw),
carried into each rank's part by ``convert.params_from_numpy(...,
tp=)``. Meshes: (2, 2) data x model (two slots a data rank), (1, 2)
twice side by side (``test_torch_tp.py``'s (2, 1, 2) mesh), and (1, 4)
for tinyllama, whose 2 KV heads 4 ranks do not divide (each rank then
projects the one whole KV head its query head reads and caches it).

- ``ServeEngine``: the same 6 requests (4 slots, two re-seated) with f32
  caches (``cache_dtype``), for tinyllama and granite-moe (its experts over
  ``model``, each decode step's tokens dispatched by the expert-parallel
  body): the same
  step count and tokens as one rank's engine and as the reference's
  engine on the same mesh, every step's logits within ``REL`` (1e-5 of
  max |logit|) of one rank's, and of the reference's within the bound of
  ``test_torch_families.py`` (granite's derived 2.5e-5); every rank
  takes the same tokens.
- ``make_prefill_step`` and ``make_decode_step`` on (2, 2): the last
  logits whole on every rank, each rank's cache its two slots and its KV
  head, equal to that slice of one rank's cache.
- One forward of each GQA family at tp = 2 (olmo, starcoder2, gemma2 with
  its local ring and softcaps, musicgen with cross attention, internvl2
  with its prefix): the gathered logits within ``REL`` of one rank's and
  of the reference's forward on the (1, 2) mesh.
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

from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from test_torch_families import (REL, REL_OF, SERVE_REL_OF,  # noqa: E402
                                 assert_logits_close)
from test_torch_fsdp import _weights  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
TINY, GRANITE = "tinyllama-1.1b", "granite-moe-3b-a800m"
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x2": ((2, 1, 2), ("rep", "data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
REF_MESHES = {"2x2": (2, 2), "1x2": (1, 2), "1x4": (1, 4)}
SERVE = [(a, m) for a in (TINY, GRANITE) for m in ("2x2", "1x2")] + [
    (TINY, "1x4")]
FAMILIES = ["olmo-1b", "starcoder2-7b", "gemma2-2b", "musicgen-medium",
            "internvl2-2b"]
SLOTS, MAX_LEN, PROMPT = 4, 64, 12


def _tree(arch) -> dict:
    """The port's f32 weights for ``SEED`` as the reference's nested tree."""
    out: dict = {}
    for k, v in _weights(arch).items():
        node = out
        *head, last = k.split("/")[1:]
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _requests(cfg) -> list:
    rng = np.random.default_rng(9)
    return [engine.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, size=rng.integers(4, 12)).tolist(), max_new=8)
        for i in range(6)]


def _family_batch(cfg) -> dict:
    """tokens [2, 16] and the ``cond``/``prefix`` the config reads, f32
    numpy (bf16-representable draws)."""
    rng = np.random.default_rng(21)
    out = {"tokens": rng.integers(0, cfg.vocab, (2, 16))}
    if cfg.cross_attn:
        out["cond"] = rng.normal(size=(2, cfg.cond_len, cfg.d_model))
    if cfg.prefix_embeds:
        out["prefix"] = rng.normal(size=(2, cfg.prefix_embeds, cfg.d_model))
    for k in ("cond", "prefix"):
        if k in out:
            out[k] = torch.as_tensor(out[k], dtype=torch.bfloat16).float(
                ).numpy()
    return out


# ---------------------------------------------------------------------------
# the reference, in a subprocess on 4 host devices
# ---------------------------------------------------------------------------

_REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import RunConfig, get_arch
from repro.models import model as jmdl
from repro.parallel.sharding import make_rules, use_mesh
from repro.serving import engine as jengine

z = np.load(sys.argv[1], allow_pickle=False)
spec = json.loads(str(z["spec"]))
res, arrays = {"serve": {}}, {}


def tree(arch):
    pre = arch + "|"
    out = {}
    for k in z.files:
        if k.startswith(pre):
            *head, last = k[len(pre):].split("/")
            node = out
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(z[k])
    return out


def mesh_of(shape):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, ("data", "model"))


for case, c in spec["serve"].items():
    cfg = get_arch(c["arch"]).reduced()
    mesh = mesh_of(tuple(c["shape"]))
    _, bschema = jmdl.model_schema(cfg)
    biases = jax.tree.map(lambda pd: jnp.zeros(pd.shape, jnp.float32),
                          bschema, is_leaf=lambda x: hasattr(x, "dims"))
    eng = jengine.ServeEngine(cfg, RunConfig(remat="none"), tree(c["arch"]),
                              biases, mesh, slots=c["slots"],
                              max_len=c["max_len"])
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

for arch in spec["families"]:
    cfg = get_arch(arch).reduced()
    mesh = mesh_of((1, 2))
    rules = make_rules(mesh)
    batch = {"tokens": jnp.asarray(z["batch|" + arch + "|tokens"])}
    for k in ("cond", "prefix"):
        if "batch|" + arch + "|" + k in z.files:
            batch[k] = jnp.asarray(z["batch|" + arch + "|" + k],
                                   jnp.bfloat16)

    def fwd(p, b, cfg=cfg, mesh=mesh, rules=rules):
        with use_mesh(mesh, rules):
            return jmdl.forward(cfg, RunConfig(remat="none"), p, {}, b)[0]
    arrays["forward|" + arch] = np.asarray(
        jax.jit(fwd)(tree(arch), batch), np.float32)
np.savez(sys.argv[2], meta=json.dumps(res), **arrays)
'''


def _start_reference(tmp: Path) -> tuple:
    serve = {}
    for arch, m in SERVE:
        cfg = get_arch(arch).reduced()
        serve[f"{arch}|{m}"] = {"arch": arch, "shape": list(REF_MESHES[m]),
                                "slots": SLOTS, "max_len": MAX_LEN,
                                "prompts": [r.prompt for r in
                                            _requests(cfg)]}
    arrays = {}
    for arch in {a for a, _ in SERVE} | set(FAMILIES):
        arrays.update({f"{arch}|{k.split('/', 1)[1]}": v
                       for k, v in _weights(arch).items()})
    for arch in FAMILIES:
        for k, v in _family_batch(get_arch(arch).reduced()).items():
            arrays[f"batch|{arch}|{k}"] = v
    src, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, spec=json.dumps({"serve": serve, "families": FAMILIES}),
             **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(src),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def _finish_reference(proc, out) -> dict:
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    with np.load(out) as z:
        ref = json.loads(str(z["meta"]))
        ref["logits"] = {k.split("|", 1)[1]: z[k] for k in z.files
                         if k.startswith("serve|")}
        ref["forward"] = {k.split("|", 1)[1]: z[k] for k in z.files
                          if k.startswith("forward|")}
    return ref


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def _serve(cfg, params, mesh) -> dict:
    eng = engine.ServeEngine(cfg, RunConfig(), params, slots=SLOTS,
                             max_len=MAX_LEN, device="cpu", mesh=mesh,
                             cache_dtype=torch.float32)
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
            "logits": np.stack(logits),
            "k0": eng.cache[0]["attn"]["k"].numpy().copy()}


def _lm(arch, tp=None):
    cfg = get_arch(arch).reduced()
    return cfg, convert.params_from_numpy(_tree(arch), cfg, device="cpu",
                                          dtype=torch.float32, tp=tp)


def _torch_batch(b: dict) -> dict:
    return {k: (torch.as_tensor(v) if k == "tokens" else
                torch.as_tensor(v).to(torch.bfloat16)) for k, v in b.items()}


def _prefill(mesh, tp) -> dict:
    """Prefill and 4 decode steps of tinyllama on ``mesh``: the logits,
    and this rank's cache."""
    cfg, lm = _lm(TINY, tp)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (SLOTS, PROMPT))
    pre = engine.make_prefill_step(cfg, RunConfig(), MAX_LEN, device="cpu",
                                   mesh=mesh)
    dec = engine.make_decode_step(cfg, RunConfig(), device="cpu", mesh=mesh)
    cache, last = pre(lm, {"tokens": toks})
    logits = [last.numpy().copy()]
    tok = last.argmax(-1, keepdim=True)
    for i in range(4):
        out, cache = dec(lm, cache, tok, PROMPT + i)
        logits.append(out.numpy().copy())
        tok = out.argmax(-1, keepdim=True)
    return {"logits": np.stack(logits),
            "k0": cache[0]["attn"]["k"].float().numpy().copy()}


def _rank(rank, world):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.tp import Tp
    torch.set_num_threads(1)
    meshes = {m: make_mesh(*MESHES[m], device_type="cpu") for m in MESHES}
    out = {"serve": {}, "forward": {}}
    for arch, m in SERVE:
        cfg = get_arch(arch).reduced()
        out["serve"][f"{arch}|{m}"] = _serve(
            cfg, _lm(arch, Tp.of(meshes[m], cfg))[1], meshes[m])
    # a whole LM handed to the engine is cut into this rank's part
    out["serve"]["whole"] = _serve(*_lm(TINY), meshes["2x2"])
    out["prefill"] = _prefill(meshes["2x2"], Tp.of(meshes["2x2"], get_arch(
        TINY).reduced()))
    tiny = get_arch(TINY).reduced()
    out["model_rank_1x4"] = meshes["1x4"].get_local_rank("model")
    out["kv_1x4"] = Tp.of(meshes["1x4"], tiny).kv_heads(tiny.n_heads,
                                                         tiny.n_kv_heads)
    out["model_rank"] = meshes["2x2"].get_local_rank("model")
    out["data_rank"] = meshes["2x2"].get_local_rank("data")
    for arch in FAMILIES:
        cfg = get_arch(arch).reduced()
        tp = Tp.of(meshes["1x2"], cfg)
        _, lm = _lm(arch, tp)
        with torch.no_grad():
            logits = mdl.forward(cfg, RunConfig(), lm, _torch_batch(
                _family_batch(cfg)), tp=tp)[0]
        out["forward"][arch] = tp.gather_vocab(logits).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the port's results by rank, the reference's, one rank's)."""
    from repro_torch.launch.mesh import spawn_world
    tmp = tmp_path_factory.mktemp("tp_serve")
    proc, out = _start_reference(tmp)
    try:
        ranks = spawn_world(_rank, WORLD, init_file=str(tmp / "store"),
                            timeout_s=900)
    except BaseException:
        proc.kill()
        raise
    one = {"serve": {a: _serve(*_lm(a), None) for a in (TINY, GRANITE)},
           "prefill": _prefill(None, None), "forward": {}}
    for arch in FAMILIES:
        cfg, lm = _lm(arch)
        with torch.no_grad():
            one["forward"][arch] = mdl.forward(cfg, RunConfig(), lm,
                                               _torch_batch(_family_batch(
                                                   cfg)))[0].numpy()
    return ranks, _finish_reference(proc, out), one


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh", SERVE)
def test_serve_engine_on_a_mesh_matches_one_rank(runs, arch, mesh):
    """Every rank's engine on the mesh: one rank's step count and tokens,
    every step's logits within ``REL`` of one rank's."""
    ranks, _, one = runs
    want = one["serve"][arch]
    for r in ranks:
        got = r["serve"][f"{arch}|{mesh}"]
        assert got["steps"] == want["steps"] and got["outs"] == want["outs"]
        assert_logits_close(got["logits"], want["logits"], REL)


@pytest.mark.parametrize("arch,mesh", SERVE)
def test_serve_engine_on_a_mesh_matches_the_reference(runs, arch, mesh):
    """The reference's engine on the same mesh: the same step count and
    tokens, the logits within the families' bound (granite's derived
    2.5e-5, ``test_torch_families.py``)."""
    ranks, ref, _ = runs
    got = ranks[0]["serve"][f"{arch}|{mesh}"]
    want = ref["serve"][f"{arch}|{mesh}"]
    assert got["steps"] == want["steps"] and got["outs"] == want["outs"]
    assert_logits_close(got["logits"], ref["logits"][f"{arch}|{mesh}"],
                        SERVE_REL_OF.get(arch, REL_OF.get(arch, REL)))


def test_serve_engine_caches_whole_kv_heads_at_tp4(runs):
    """On (1, 4) tinyllama's 2 KV heads stay whole: each rank's cache holds
    the one KV head its query head reads (rank r: head r // 2), equal to
    that head of one rank's cache after the same run, in f32."""
    want = runs[2]["serve"][TINY]["k0"]
    for r in runs[0]:
        lo, cnt, index = r["kv_1x4"]
        assert (cnt, index) == (1, None)
        assert lo == r["model_rank_1x4"] // 2
        got = r["serve"][f"{TINY}|1x4"]["k0"]
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want[:, :, lo:lo + cnt], rtol=1e-5,
                                   atol=1e-5)


def test_engine_cache_dtype():
    """``ServeEngine``'s cache is bf16 by default (the reference's) and
    ``cache_dtype``'s dtype where given."""
    cfg, lm = _lm(TINY)
    for dt, want in ((None, torch.bfloat16), (torch.float32, torch.float32)):
        eng = engine.ServeEngine(cfg, RunConfig(), lm, slots=2, max_len=8,
                                 device="cpu", cache_dtype=dt)
        assert {t.dtype for lay in eng.cache for d in lay.values()
                for t in d.values()} == {want}


def test_serve_engine_cuts_a_whole_lm(runs):
    """A whole ``LM`` handed to ``ServeEngine(mesh=)`` is cut into each
    rank's part: the same tokens and logits as one rank's engine."""
    _, _, one = runs
    for r in runs[0]:
        got = r["serve"]["whole"]
        assert got["outs"] == one["serve"][TINY]["outs"]
        assert_logits_close(got["logits"], one["serve"][TINY]["logits"], REL)


def test_prefill_and_decode_on_a_mesh(runs):
    """``make_prefill_step`` and ``make_decode_step`` on (2, 2): every
    rank's logits (the last prompt position, then 4 greedy steps) within
    ``REL`` of one rank's; each rank's layer-0 key cache is its two slots
    and its KV head of one rank's cache."""
    _, _, one = runs
    want = one["prefill"]
    for r in runs[0]:
        got = r["prefill"]
        assert_logits_close(got["logits"], want["logits"], REL)
        d, m = r["data_rank"], r["model_rank"]
        k = want["k0"][2 * d:2 * d + 2, :, m:m + 1]
        assert got["k0"].shape == k.shape
        np.testing.assert_allclose(got["k0"], k, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_at_tp2(runs, arch):
    """One forward at tp = 2: the gathered logits within ``REL`` of one
    rank's forward and of the reference's forward on the (1, 2) mesh."""
    ranks, ref, one = runs
    for r in ranks:
        got = r["forward"][arch]
        assert_logits_close(got, one["forward"][arch], REL)
        assert_logits_close(got, ref["forward"][arch], REL)
