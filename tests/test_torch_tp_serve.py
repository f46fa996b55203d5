"""Serving on a mesh (``serving/engine.py``'s ``mesh=``) in the reference's
layout: the model tensor parallel over the ``model`` ranks
(``parallel/tp.py``), the weights cut into FSDP row shards over the data
axes by ``pod_param_mode`` ("sharded", the default), the slots over the
data ranks, each layer's cache cut over ``model`` by KV heads, head dim or
positions (``models/attention.py::cache_cut``), MLA's latent over
``kv_lora``; held to one rank's engine and to the JAX package's engine on
the same mesh, on the CPU.

One gloo world of 4 ranks (``launch/mesh.py::spawn_world``) runs every
case once (the module fixture ``runs``); the reference runs the same cases
in one subprocess on 4 host devices (its (1, 2) mesh takes the first
two). Both compute from the port's f32 weights for ``SEED``
(``test_torch_fsdp._weights``, the constant leaves moved by a draw),
carried into each rank's part by ``convert.params_from_numpy(...,
tp=)``, which the engine cuts into its layout. Meshes: (2, 2) data x
model (two slots a data rank, the weights sharded over the 2 data ranks),
(1, 2) twice side by side (``test_torch_tp.py``'s (2, 1, 2) mesh), and
(1, 4) for tinyllama, whose 2 KV heads 4 ranks do not divide (each rank
caches a quarter of each head's dimension).

- ``ServeEngine``: the same 6 requests (4 slots, two re-seated) with f32
  caches (``cache_dtype``), for tinyllama and granite-moe (its experts over
  ``model``, each decode step's tokens dispatched by the expert-parallel
  body): the same
  step count and tokens as one rank's engine and as the reference's
  engine on the same mesh, every step's logits within ``REL`` (1e-5 of
  max |logit|) of one rank's, and of the reference's within the bound of
  ``test_torch_families.py`` (granite's derived 2.5e-5); every rank
  takes the same tokens. On (2, 2) every ``pod_param_mode``: a rank's
  parameters are FSDP row shards of its model part under "sharded" and
  "data" (1/F of them plus padding), its part whole under "replicated".
- ``make_prefill_step`` and ``make_decode_step`` on (2, 2), the weights
  sharded: the last logits whole on every rank, each rank's cache its two
  slots and its KV head, equal to that slice of one rank's cache; the
  steps built with ``batch_rows`` (each rank its rows) give the same; a
  step handed weights in another layout than its mode's raises.
- The cache cuts (``CUTS``): tinyllama's head dim on (1, 4), internvl2's
  positions on (1, 2) (``cache_seq_shard``), deepseek-v3's latent on
  (1, 2) (``kv_lora`` 16), musicgen's cross and self caches by head dim on
  (1, 4) (its heads cut to 2, which 4 ranks divide neither as heads nor
  as KV heads), and two prompts of 13 positions, which the model ranks do
  not divide, in layers whose heads they do not divide either (tinyllama
  with 6 heads on (1, 4), deepseek-v3 with 3 on (1, 2)), so prefill runs
  the layer whole and cuts its cache: each rank's cache leaves have the reference's shard
  shapes on the same mesh and equal that part of one rank's cache after
  a prefill and 4 decode steps; logits within ``REL`` of one rank's; the
  engine's tokens one rank's.
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
from test_torch_fsdp import SEED, _weights  # noqa: E402
from repro_torch.parallel.fsdp import Fsdp  # noqa: E402

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
MODES = ("sharded", "data", "replicated")
# the cache cuts: case -> (arch, the reduced config's fields, the MoE's,
# mesh, the cut). deepseek-v3's capacity is raised so no token is dropped:
# which tokens share a dispatch chunk (one rank's or a model rank's slice)
# decides the drops (test_torch_families.py), and the test holds the
# latent's cut, not the routing.
CUTS = {
    "tiny_head_dim": (TINY, {}, {}, "1x4", "head_dim"),
    "internvl2_seq": ("internvl2-2b", {}, {}, "1x2", "seq"),
    "deepseek_latent": ("deepseek-v3-671b", {}, {"capacity_factor": 16.0},
                        "1x2", "latent"),
    "musicgen_cross": ("musicgen-medium", {"n_heads": 2, "n_kv_heads": 2},
                       {}, "1x4", "head_dim"),
    "tiny_odd_prompt": (TINY, {"n_heads": 6, "n_kv_heads": 2}, {}, "1x4",
                        "head_dim"),
    "deepseek_odd_prompt": ("deepseek-v3-671b", {"n_heads": 3},
                            {"capacity_factor": 16.0}, "1x2", "latent"),
}
# the prompt length of a cut case where it is not ``PROMPT``
CUT_PROMPT = {"tiny_odd_prompt": 13, "deepseek_odd_prompt": 13}


def _cut_cfg(case):
    arch, fields, moe, _, _ = CUTS[case]
    cfg = dataclasses.replace(get_arch(arch).reduced(), **fields)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


class _StandIn:
    """A mesh as ``Tp`` reads it for shapes: dim names and sizes."""

    def __init__(self, shape):
        self.shape = shape
        self.mesh_dim_names = ("data", "model")

    def size(self, i):
        return self.shape[i]


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
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import RunConfig, get_arch
from repro.models import model as jmdl
from repro.models.transformer import cache_schema
from repro.parallel.sharding import (abstract_params, make_rules,
                                     sharding_tree, use_mesh)
from repro.serving import engine as jengine

z = np.load(sys.argv[1], allow_pickle=False)
spec = json.loads(str(z["spec"]))
res, arrays = {"serve": {}, "cuts": {}}, {}


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
for case, c in spec["cuts"].items():
    cfg = dataclasses.replace(get_arch(c["arch"]).reduced(), **c["fields"])
    mesh = mesh_of(tuple(c["shape"]))
    rules = make_rules(mesh)
    sch = cache_schema(cfg, c["slots"], c["max_len"])
    with use_mesh(mesh, rules):
        shapes = jax.tree.map(
            lambda a, s: list(s.shard_shape(a.shape)), abstract_params(sch),
            sharding_tree(sch, mesh, rules))
    res["cuts"][case] = {
        "/".join(str(getattr(q, "key", q)) for q in path): v
        for path, v in jax.tree_util.tree_flatten_with_path(
            shapes, is_leaf=lambda x: isinstance(x, list))[0]}
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
    cuts = {case: {"arch": arch, "fields": fields,
                   "shape": list(REF_MESHES[m]), "slots": SLOTS,
                   "max_len": MAX_LEN}
            for case, (arch, fields, _, m, _) in CUTS.items()}
    np.savez(src, spec=json.dumps({"serve": serve, "families": FAMILIES,
                                   "cuts": cuts}), **arrays)
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

def _serve(cfg, params, mesh, mode="sharded") -> dict:
    eng = engine.ServeEngine(cfg, RunConfig(pod_param_mode=mode), params,
                             slots=SLOTS, max_len=MAX_LEN, device="cpu",
                             mesh=mesh, cache_dtype=torch.float32)
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
            "k0": next(iter(eng.cache[0]["attn"].values())).numpy().copy(),
            "params": {n: tuple(p.shape)
                       for n, p in eng.params.named_parameters()}}


def _lm(arch, tp=None, fsdp=None):
    cfg = get_arch(arch).reduced()
    return cfg, convert.params_from_numpy(_tree(arch), cfg, device="cpu",
                                          dtype=torch.float32, tp=tp,
                                          fsdp=fsdp)


def _torch_batch(b: dict) -> dict:
    return {k: (torch.as_tensor(v) if k == "tokens" else
                torch.as_tensor(v).to(torch.bfloat16)) for k, v in b.items()}


def _steps(cfg, lm, mesh, batch, local=False) -> dict:
    """Prefill over ``batch`` and 4 greedy decode steps on ``mesh`` (None:
    one rank; ``local``: the steps built with ``batch_rows``, each rank
    handed its rows): the logits, and this rank's cache of layer 0."""
    from repro_torch.parallel.sharding import rank_rows
    rows = rank_rows(SLOTS, mesh) if local else slice(None)
    n = SLOTS if local else None
    pre = engine.make_prefill_step(cfg, RunConfig(), MAX_LEN, device="cpu",
                                   mesh=mesh, batch_rows=n)
    dec = engine.make_decode_step(cfg, RunConfig(), device="cpu", mesh=mesh,
                                  batch_rows=n)
    cache, last = pre(lm, {k: v[rows] for k, v in batch.items()})
    logits = [last.numpy().copy()]
    tok = last.argmax(-1, keepdim=True)
    S = batch["tokens"].shape[1]
    for i in range(4):
        out, cache = dec(lm, cache, tok[rows], S + i)
        logits.append(out.numpy().copy())
        tok = out.argmax(-1, keepdim=True)
    return {"logits": np.stack(logits),
            "cache0": {f"{m}/{k}": t.float().numpy().copy()
                       for m, d in cache[0].items() for k, t in d.items()},
            "shapes": [{f"{m}/{k}": tuple(t.shape) for m, d in layer.items()
                        for k, t in d.items()} for layer in cache]}


def _prefill(mesh, part, local=False) -> dict:
    """Prefill and 4 decode steps of tinyllama on ``mesh``, its weights in
    ``part``'s layout (``engine.rank_part``)."""
    fs = part if isinstance(part, Fsdp) else None
    cfg, lm = _lm(TINY, None if fs else part, fs)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (SLOTS, PROMPT))
    return _steps(cfg, lm, mesh, {"tokens": toks}, local)


def _cut_batch(cfg, prompt: int) -> dict:
    """tokens [SLOTS, prompt] and the ``cond``/``prefix`` the config
    reads."""
    rng = np.random.default_rng(13)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                  (SLOTS, prompt)))}
    if cfg.cross_attn:
        out["cond"] = torch.as_tensor(rng.normal(
            size=(SLOTS, cfg.cond_len, cfg.d_model)), dtype=torch.float32)
    if cfg.prefix_embeds:
        out["prefix"] = torch.as_tensor(rng.normal(
            size=(SLOTS, cfg.prefix_embeds, cfg.d_model)),
            dtype=torch.float32)
    return out


def _cut_run(case, mesh) -> dict:
    """A cut case on ``mesh`` (None: one rank): ``_steps`` with weights
    drawn from ``SEED`` in this rank's part, and the engine's tokens."""
    cfg = _cut_cfg(case)
    part = engine.rank_part(cfg, mesh, RunConfig()) if mesh else None
    lm = mdl.init(cfg, SEED, device="cpu", dtype=torch.float32, part=part)
    out = _steps(cfg, lm, mesh, _cut_batch(cfg, CUT_PROMPT.get(case,
                                                                PROMPT)))
    eng = _serve(cfg, lm, mesh)
    out.update(steps=eng["steps"], outs=eng["outs"])
    return out


def _rank(rank, world):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.tp import Tp
    torch.set_num_threads(1)
    meshes = {m: make_mesh(*MESHES[m], device_type="cpu") for m in MESHES}
    out = {"serve": {}, "forward": {}, "modes": {}, "cuts": {}}
    for arch, m in SERVE:
        cfg = get_arch(arch).reduced()
        out["serve"][f"{arch}|{m}"] = _serve(
            cfg, _lm(arch, Tp.of(meshes[m], cfg))[1], meshes[m])
    # a whole LM handed to the engine is cut into this rank's part
    out["serve"]["whole"] = _serve(*_lm(TINY), meshes["2x2"])
    tiny = get_arch(TINY).reduced()
    for mode in MODES:
        out["modes"][mode] = _serve(tiny, _lm(TINY, Tp.of(
            meshes["2x2"], tiny))[1], meshes["2x2"], mode)
    part = engine.rank_part(tiny, meshes["2x2"], RunConfig())
    out["prefill"] = _prefill(meshes["2x2"], part)
    out["prefill_local"] = _prefill(meshes["2x2"], part, local=True)
    whole = _lm(TINY, Tp.of(meshes["2x2"], tiny))[1]
    out["mismatch"] = {}
    for mode, lm in (("sharded", whole), ("replicated", _lm(
            TINY, fsdp=part)[1])):
        try:
            engine.make_decode_step(
                tiny, RunConfig(pod_param_mode=mode), device="cpu",
                mesh=meshes["2x2"])(lm, None, np.zeros((SLOTS, 1), int), 0)
        except ValueError as e:
            out["mismatch"][mode] = str(e)
    for case, (_, _, _, m, _) in CUTS.items():
        out["cuts"][case] = _cut_run(case, meshes[m])
    out["model_rank_1x4"] = meshes["1x4"].get_local_rank("model")
    out["model_rank_1x2"] = meshes["1x2"].get_local_rank("model")
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
           "prefill": _prefill(None, None), "forward": {},
           "cuts": {case: _cut_run(case, None) for case in CUTS}}
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
    """On (1, 4) tinyllama's 2 KV heads do not split over 4 ranks, so each
    rank's cache holds every KV head at its quarter of the head dim (the
    reference's ``head_dim`` fallback): [slots, L, 2, dh / 4], equal to
    that slice of one rank's cache after the same run, in f32."""
    want = runs[2]["serve"][TINY]["k0"]
    dh = want.shape[-1]
    for r in runs[0]:
        m = r["model_rank_1x4"]
        got = r["serve"][f"{TINY}|1x4"]["k0"]
        assert got.dtype == np.float32
        assert got.shape == want.shape[:3] + (dh // 4,)
        np.testing.assert_allclose(got, want[..., m * dh // 4:
                                             (m + 1) * dh // 4],
                                   rtol=1e-5, atol=1e-5)


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
    """``make_prefill_step`` and ``make_decode_step`` on (2, 2), the weights
    FSDP-sharded over the data ranks ("sharded"): every rank's logits (the
    last prompt position, then 4 greedy steps) within ``REL`` of one
    rank's; each rank's layer-0 key cache is its two slots and its KV head
    of one rank's cache. Built with ``batch_rows`` and handed each rank's
    rows, the steps give the same logits and cache."""
    _, _, one = runs
    want = one["prefill"]
    for r in runs[0]:
        got = r["prefill"]
        assert_logits_close(got["logits"], want["logits"], REL)
        d, m = r["data_rank"], r["model_rank"]
        k = want["cache0"]["attn/k"][2 * d:2 * d + 2, :, m:m + 1]
        assert got["cache0"]["attn/k"].shape == k.shape
        np.testing.assert_allclose(got["cache0"]["attn/k"], k, rtol=1e-5,
                                   atol=1e-5)
        local = r["prefill_local"]
        np.testing.assert_array_equal(local["logits"], got["logits"])
        for key, t in got["cache0"].items():
            np.testing.assert_array_equal(local["cache0"][key], t)


def test_steps_take_only_the_layout_of_their_mode(runs):
    """On (2, 2) a decode step under "sharded" handed a rank's model part
    whole over the data ranks, and one under "replicated" handed FSDP row
    shards, raise before any work."""
    for r in runs[0]:
        got = r["mismatch"]
        assert sorted(got) == ["replicated", "sharded"]
        assert "wants FSDP row shards" in got["sharded"]
        assert "are FSDP row shards" in got["replicated"]


@pytest.mark.parametrize("mode", MODES)
def test_serve_engine_lays_weights_out_by_pod_param_mode(runs, mode):
    """``ServeEngine`` on (2, 2) under each ``pod_param_mode``: one rank's
    tokens and step count, logits within ``REL``; a rank's parameters are
    its model part (``Tp.local_shape``) whole under "replicated", else
    that part's FSDP row shard over the 2 data ranks (flat, ceil(rows / 2)
    rows of its last dimension), so a rank holds 1/(F tp) of each cut
    tensor and 1/F of each copy, plus padding."""
    from repro_torch.parallel.sharding import ShardSpec
    from repro_torch.parallel.tp import Tp
    from repro_torch.training.state import param_dims, param_shapes
    cfg = get_arch(TINY).reduced()
    whole = mdl.LM(cfg, device="meta")
    shapes, dims = param_shapes(whole), param_dims(whole)
    tp = Tp(_StandIn((2, 2)))
    want = runs[2]["serve"][TINY]
    total = sum(np.prod(v) for v in shapes.values())
    for r in runs[0]:
        got = r["modes"][mode]
        assert got["steps"] == want["steps"] and got["outs"] == want["outs"]
        assert_logits_close(got["logits"], want["logits"], REL)
        held = 0
        for n, shape in got["params"].items():
            local = tp.local_shape(shapes[n], dims[n])
            if mode == "replicated":
                assert shape == local, n
            else:
                assert shape == (ShardSpec(local, 2).numel,), n
            held += np.prod(shape)
        F = 1 if mode == "replicated" else 2
        assert total / (F * 2) <= held <= total / F + len(shapes) * 64


@pytest.mark.parametrize("case", sorted(CUTS))
def test_cache_cut_holds_the_reference_layout(runs, case):
    """Each rank's cache leaves, layer by layer, have the reference's shard
    shapes on the same mesh (its ``cache_schema`` through ``spec_for``:
    the head dim, the positions under ``cache_seq_shard``, MLA's
    ``kv_lora``; a scan group's stacked layer axis dropped), and the
    layer-0 leaves equal that part of one rank's cache after a prefill
    and 4 decode steps."""
    from repro_torch.models.transformer import plan_layers
    ranks, ref, one = runs
    want = ref["cuts"][case]
    cfg = _cut_cfg(case)
    groups, tail = plan_layers(cfg)
    keys = [f"g{gi}/l{li}" for gi, (sig, cnt) in enumerate(groups)
            for _ in range(cnt) for li in range(len(sig))]
    keys += [f"tail/l{li}" for li in range(len(tail or ()))]
    stacked = [not k.startswith("tail") for k in keys]
    full = one["cuts"][case]["cache0"]
    tp = int(CUTS[case][3][-1])
    for r in ranks:
        got = r["cuts"][case]
        m = r[f"model_rank_1x{tp}"]
        for key, st, layer in zip(keys, stacked, got["shapes"],
                                  strict=True):
            for leaf, shape in layer.items():
                w = want[f"{key}/{leaf}"]
                assert list(shape) == (w[1:] if st else w), (key, leaf)
        for leaf, t in got["cache0"].items():
            f = full[leaf]
            cut = [i for i in range(f.ndim) if t.shape[i] != f.shape[i]]
            for ax in cut:                  # one axis, or none (MLA's kr)
                k = f.shape[ax] // tp
                f = np.take(f, range(m * k, (m + 1) * k), axis=ax)
            np.testing.assert_allclose(t, f, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CUTS))
def test_cache_cut_gives_one_ranks_tokens(runs, case):
    """Prefill and 4 decode steps against the cut cache: every rank's
    logits within ``REL`` of one rank's; ``ServeEngine`` on the same mesh:
    one rank's tokens and step count."""
    ranks, _, one = runs
    want = one["cuts"][case]
    for r in ranks:
        got = r["cuts"][case]
        assert_logits_close(got["logits"], want["logits"], REL)
        assert got["outs"] == want["outs"] and got["steps"] == want["steps"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_at_tp2(runs, arch):
    """One forward at tp = 2: the gathered logits within ``REL`` of one
    rank's forward and of the reference's forward on the (1, 2) mesh."""
    ranks, ref, one = runs
    for r in ranks:
        got = r["forward"][arch]
        assert_logits_close(got, one["forward"][arch], REL)
        assert_logits_close(got, ref["forward"][arch], REL)
