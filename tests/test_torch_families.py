"""The port's LM serving path for olmo-1b, starcoder2-7b, gemma2-2b,
recurrentgemma-2b (RG-LRU), mamba2-1.3b (SSD), granite-moe-3b-a800m (MoE),
deepseek-v3-671b (MLA, MoE after a dense layer, MTP parameters),
musicgen-medium (sinusoidal positions, cross attention to ``cond``) and
internvl2-2b (patch embeddings as a ``prefix``) against the JAX package's,
on the CPU, at ``get_arch(name).reduced()`` widths (d_model 64, 4 heads,
head dim 16, vocab 256; window 32; SSD chunk 16; 8 experts top-2, 64-token
dispatch chunks, so the prompts here run a zero-padded second chunk;
``cond_len`` 8, 4 prefix embeddings). recurrentgemma keeps its published
shape of full ``(rglru, rglru, local)`` units plus a ``(rglru, rglru)``
tail: 5 layers here, 26 at full width. ``cond`` and ``prefix`` are bf16
numpy draws from a seed, as ``test_smoke_archs.py::_batch`` makes them,
fed to both sides (``ServeEngine`` runs no prefill in either package, so
its requests carry neither).

Both sides compute from one parameter tree: the JAX package's
``init_params(..., dtype_override="float32")`` (which folds
``hash(path)`` into each leaf's key; ``make_fam`` gives it the hashes of a
fixed salt, 0 unless the case says ``name@salt``, so every process draws
the same weights), every constant-initialised
leaf (norm scales, biases, RG-LRU's ``lam``, SSD's ``A_log``, ``D``,
``dt_bias``, ``gn``, the MoE router biases) moved by a seeded draw so it is
exercised too, carried into the port by ``convert.params_from_numpy``.
Caches cross the same way (``convert.cache_from_numpy``). Inputs are numpy
draws from a seed. The JAX side runs eagerly, as ``test_torch_lm.py`` runs
it, under the conftest's 1 x 1 mesh (``moe_apply`` needs one).

Tolerance (f32): the largest logit difference is at most 1e-5 of the
largest |logit| (``REL``, ``test_torch_lm.py``'s); caches to 1e-5
(relative and absolute). Both sides do the same f32 arithmetic in another
order of sums, and the RG-LRU scan runs chunks here against the
reference's ``associative_scan`` tree. deepseek-v3 is held to 2e-4, its
caches too (``REL_OF``): the reference's init puts its reduced MoE layer's
output near 2,200 and its MLA output near 17 against an embedding near
0.5, so f32 roundings grow: a run of either framework is 1.1-1.7e-5 of
max |logit| from the same run with f64 weights, and the reference's own
prefill + decode is up to 5.1e-5 from its own forward on rows routed
alike (the port's up to 8e-5 from the reference's forward, over seven
draws of the weights). bf16: the reference's own 0.07
(``test_smoke_archs.py``).

granite-moe's serving engine (``SERVE_REL_OF``, 2.5e-5). Its 27 decode
steps were held, each framework, to the port's run of the same weights in
f64 (every ``float()`` cast made f64) over eight draws (hash salts 0-7):
the port's f32 logits are 3.3e-6 to 1.26e-5 of max |logit| from f64, the
reference's 3.0e-6 to 1.01e-5 (it alone passes 1e-5 on draw 0). The two
errors are independent, so their difference reaches up to the sum of the
worst, 2.27e-5; the frameworks differ by 4.6e-6 to 1.23e-5. Localised on
draw 2 (``granite-moe-3b-a800m@2``, 1.23e-5, which failed the former
1e-5): embedding exact; each layer's attention output within 6e-7 of f64
in both frameworks; the router logits within 8e-7; the first MoE layer's
output 3.1e-6 (port) and 1.7e-6 (reference), the second's 6.4e-6 and
5.0e-6, where the two frameworks first differ by 1.1e-5 of that layer's
output; the head 1.0e-5 and 7.2e-6 on the worst step. On identical f32
inputs one MoE layer is within 1.8e-6 (port) and 0.9e-6 (reference) of
f64, and its expert GEMMs and activation agree to the bit, so no
formula differs: the gap is the two frameworks' f32 roundings in the
router's softmax, the gates and the combine, carried through two MoE
layers.

MoE routing. Where two calls route a token to different kept experts the
token's output differs by a whole expert's share, so those rows are not
held to a tolerance (``test_torch_cases.routed_alike``). Two causes:
capacity drops depend on a dispatch chunk's composition (prefill and
decode against one forward over more tokens), and top-k near-ties flip
under bf16 roundings. Every row whose kept experts agree in every MoE
layer is held to the bound.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import use_mesh  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert, transformer  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from test_torch_cases import (kept_experts, recorded_routing,  # noqa: E402
                              routed_alike, salted_init)

NAMES = ["olmo-1b", "starcoder2-7b", "gemma2-2b", "recurrentgemma-2b",
         "mamba2-1.3b", "granite-moe-3b-a800m", "deepseek-v3-671b",
         "musicgen-medium", "internvl2-2b"]
GRANITE = "granite-moe-3b-a800m"
REL = 1e-5
REL_OF = {"deepseek-v3-671b": 2e-4}
# the serving engine's 27 decode steps (derived in the module docstring)
SERVE_REL_OF = {GRANITE: 2.5e-5}
B, S, MAX_LEN, N_DEC = 2, 40, 56, 8


def small(name, get=get_arch):
    """The reduced config; recurrentgemma with its tail group."""
    cfg = get(name).reduced()
    if cfg.rglru is not None:
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern) + 2)
    return cfg


@dataclasses.dataclass
class Fam:
    """One architecture on both sides: the port's and the JAX configs, the
    f32 numpy parameter and router-bias trees (``biases`` empty without
    MoE), and the port's LM built from them."""
    name: str
    cfg: object
    jcfg: object
    tree: dict
    biases: dict
    lm: object

    def __iter__(self):
        """Unpacks as (name, cfg, jcfg, tree, lm)."""
        return iter((self.name, self.cfg, self.jcfg, self.tree, self.lm))

    @property
    def jb(self):
        return _jax(self.biases)


@pytest.fixture(scope="module", params=NAMES + [f"{GRANITE}@2"])
def fam(request):
    return make_fam(request.param)


def make_fam(name) -> Fam:
    """``name``, or ``name@salt``: the weights the reference's
    ``init_params`` draws in a process whose hash salt is ``salt`` (0 by
    default; it folds ``hash(path)`` into each leaf's key), the same in
    every process."""
    name, _, salt = name.partition("@")
    cfg, jcfg = small(name), small(name, jax_get_arch)
    schema, bschema = jmdl.model_schema(jcfg)
    key = jax.random.PRNGKey(0)
    params = salted_init(jsharding, schema, key, int(salt or 0),
                         dtype_override="float32")
    biases = salted_init(jsharding, bschema, key, int(salt or 0))
    rng = np.random.default_rng(7)

    def leaf(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):     # constant init
            a = a + (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        return a
    tree, biases = jax.tree.map(leaf, params), jax.tree.map(leaf, biases)
    return Fam(name, cfg, jcfg, tree, biases, convert.params_from_numpy(
        tree, cfg, device="cpu", biases=biases))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _inputs(cfg, seed, batch=B) -> dict:
    """The bf16 ``cond`` [B, cond_len, D] and ``prefix`` [B, P, D] the
    config reads (``test_smoke_archs.py::_batch``'s), as numpy
    (``ml_dtypes``' bfloat16)."""
    rng = np.random.default_rng(seed + 100)
    out = {}
    if cfg.cross_attn:
        out["cond"] = rng.normal(size=(batch, cfg.cond_len, cfg.d_model))
    if cfg.prefix_embeds:
        out["prefix"] = rng.normal(size=(batch, cfg.prefix_embeds,
                                         cfg.d_model))
    return {k: v.astype(jnp.bfloat16) for k, v in out.items()}


def batches(cfg, toks, seed) -> tuple[dict, dict]:
    """(the port's batch, the JAX package's) over ``toks`` with the same
    ``_inputs``."""
    extra = _inputs(cfg, seed, toks.shape[0])
    return ({"tokens": torch.as_tensor(toks),
             **{k: torch.as_tensor(v.astype(np.float32)).to(torch.bfloat16)
                for k, v in extra.items()}},
            {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extra.items()}})


def assert_logits_close(got, want, rel=REL, rows=None):
    """max |got - want| <= rel * max |want|, over ``rows`` (a bool mask of
    the leading dims) where given."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if rows is not None:
        got, want = got[rows], want[rows]
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= rel * float(np.max(np.abs(want))), (err, np.abs(want).max())


def assert_caches_close(got: list, want: list, rtol=1e-5, atol=1e-5,
                        rows=None):
    """Per layer, per mixer key, per entry: shape, dtype and values (of
    the positions ``rows`` [B, S] marks, where given: attention caches are
    [B, L >= S, ...])."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), i
        for key in g:
            assert g[key].keys() == w[key].keys(), (i, key)
            for name, t in g[key].items():
                ref = w[key][name]
                assert t.shape == ref.shape and t.dtype == ref.dtype, \
                    (i, key, name, t.shape, ref.shape, t.dtype, ref.dtype)
                a, b = t.float().numpy(), ref.float().numpy()
                if rows is not None:
                    a, b = (c[:, :rows.shape[1]][rows] for c in (a, b))
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                           err_msg=f"{i} {key} {name}")


def port_cache(jcache, cfg):
    return convert.cache_from_numpy(_np(jcache), cfg, device="cpu")


@contextlib.contextmanager
def jax_routing():
    """Records the expert ids ``[n, K]`` of every dispatch chunk the JAX
    package routes (through an ordered debug callback), in call order."""
    calls, route = [], jmoe.route

    def recorded(m, logits, bias):
        out = route(m, logits, bias)
        jax.debug.callback(lambda i: calls.append(np.asarray(i)), out[1],
                           ordered=True)
        return out
    jmoe.route = recorded
    try:
        yield calls
    finally:
        jmoe.route = route
        jax.effects_barrier()


def alike(cfg, got, want) -> np.ndarray:
    """``routed_alike`` of two ``kept_experts``, as a numpy mask."""
    return routed_alike(cfg, got, want).numpy()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_reads_as_the_reference(name, reduced):
    cfg, jcfg = get_arch(name), jax_get_arch(name)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.dh, cfg.vocab_padded, cfg.layer_kinds) == \
        (jcfg.dh, jcfg.vocab_padded, jcfg.layer_kinds)
    assert cfg.n_params() == jcfg.n_params()
    assert mdl.count_params_total(cfg) == jmdl.count_params_total(jcfg)
    assert transformer.plan_layers(cfg) == jtfm.plan_layers(jcfg)


@pytest.mark.parametrize("name", NAMES)
def test_module_layout_matches_the_reference_schema(name):
    """Full width on the meta device: every parameter has the reference's
    name, per-layer shape and dtype (bf16; RG-LRU's ``lam`` and the MoE
    router f32), the tail group's layers and deepseek's ``mtp`` block
    included, and every MoE layer's router bias is an f32 buffer
    ``stack.<i>.moe.bias`` (the reference's separate biases tree)."""
    jschema, jbiases = jmdl.model_schema(jax_get_arch(name))
    groups, tail = jtfm.plan_layers(jax_get_arch(name))
    starts, n = {}, 0
    for gi, (sig, cnt) in enumerate(groups):
        starts[f"g{gi}"] = (n, len(sig))
        n += cnt * len(sig)
    starts["tail"] = (n, 0)
    want = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        {**jschema, "biases": jbiases}, is_leaf=lambda x: hasattr(x, "dims"))[0]
    for path, pd in leaves:
        keys = [p.key for p in path]
        if keys[0] == "biases":                  # a MoE layer's buffer
            keys = ["stack", *keys[1:], "moe", "bias"]
        if keys[0] == "stack":
            first, unit = starts[keys[1]]
            li = int(keys[2][1:])
            if keys[1] == "tail":
                want[".".join(["stack", str(first + li), *keys[3:]])] = \
                    (pd.shape, pd.dtype)
                continue
            for u in range(pd.shape[0]):
                want[".".join(["stack", str(first + u * unit + li),
                               *keys[3:]])] = (pd.shape[1:], pd.dtype)
        else:
            want[".".join(keys)] = (pd.shape, pd.dtype)
    lm = mdl.LM(get_arch(name), device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in lm.state_dict().items()}
    assert got == want


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_forward_matches_jax(fam, cpu_mesh):
    """Logits and, for the MoE layers, ``load`` and ``aux_loss``."""
    name, cfg, jcfg, tree, lm = fam
    batch, jbatch = batches(cfg, _tokens(cfg, 4, (B, S)), 4)
    got, _, aux, _ = mdl.forward(cfg, RunConfig(), lm, batch)
    with use_mesh(cpu_mesh):
        want, _, jaux, _ = jmdl.forward(jcfg, JRunConfig(), _jax(tree),
                                        fam.jb, jbatch)
    assert got.shape == (B, S, cfg.vocab_padded)
    assert_logits_close(got, want, REL_OF.get(name, REL))
    moe_layers = [i for i, (_, f) in enumerate(transformer.layer_plan(cfg))
                  if f == "moe"]
    assert [i for i, a in enumerate(aux) if a] == moe_layers
    want_aux = [a for a in convert._unstack(_np(jaux), cfg) if a]
    for a, w in zip([aux[i] for i in moe_layers], want_aux, strict=True):
        assert np.array_equal(a["load"].numpy(), w["load"])
        np.testing.assert_allclose(a["aux_loss"].numpy(), w["aux_loss"],
                                   rtol=1e-5, atol=1e-7)


def test_prefill_matches_jax(fam, cpu_mesh):
    """Last logits and every layer's cache: attention keys and values (a
    local layer's ring of the last window, S > window), SSD's conv windows
    and f32 state, RG-LRU's conv window and f32 state, MLA's latent and
    rotated key, cross attention's keys and values of ``cond``."""
    name, cfg, jcfg, tree, lm = fam
    batch, jbatch = batches(cfg, _tokens(cfg, 5, (B, S)), 5)
    cache, last = engine.make_prefill_step(cfg, RunConfig(), MAX_LEN,
                                           device="cpu")(lm, batch)
    with use_mesh(cpu_mesh):
        jcache, jlast = jmdl.prefill(jcfg, JRunConfig(), _jax(tree), fam.jb,
                                     jbatch, MAX_LEN)
    rel = REL_OF.get(name, REL)
    assert_logits_close(last, jlast, rel)
    assert_caches_close(cache, port_cache(jcache, cfg), rtol=rel, atol=rel)


def test_decode_steps_match_jax(fam, cpu_mesh):
    """N_DEC decode steps from the reference's own prefill cache, carried
    across: every step's logits and the final cache."""
    name, cfg, jcfg, tree, lm = fam
    toks = _tokens(cfg, 6, (B, S + N_DEC))
    jtree = _jax(tree)
    with use_mesh(cpu_mesh):
        jcache, _ = jmdl.prefill(jcfg, JRunConfig(), jtree, fam.jb,
                                 batches(cfg, toks[:, :S], 6)[1], MAX_LEN)
    cache = port_cache(jcache, cfg)
    step = engine.make_decode_step(cfg, RunConfig(), device="cpu")
    for i in range(N_DEC):
        tok = toks[:, S + i:S + i + 1]
        got, cache = step(lm, cache, tok, S + i)
        with use_mesh(cpu_mesh):
            want, jcache = jmdl.decode_step(jcfg, JRunConfig(), jtree,
                                            fam.jb, jcache, jnp.asarray(tok),
                                            jnp.int32(S + i))
        assert_logits_close(got, want, REL_OF.get(name, REL))
    rel = REL_OF.get(name, REL)
    assert_caches_close(cache, port_cache(jcache, cfg), rtol=rel, atol=rel)


@pytest.mark.parametrize("prompt", [28, 40])
def test_prefill_then_decode_matches_forward(fam, cpu_mesh, prompt):
    """The port's prefill over ``prompt`` tokens and N_DEC decode steps give
    the logits of the reference's full forward at each decoded position.
    For gemma2 and recurrentgemma the local layers' window is 32: at 28 the
    prompt is shorter than the window (the port's cache is the window,
    slot = position) and decode crosses it into the ring; at 40 prefill
    already wrapped. For mamba2 both lengths pad the last SSD chunk. For
    the MoE families the rows whose routing differs between the two
    (``routed_alike``) are left out: at 40 the prefill's 64-token
    dispatch chunks hold other tokens than the forward's. musicgen's decode
    reads the cross cache its prefill made of ``cond``; internvl2's prefix
    covers the first positions of both calls."""
    name, cfg, jcfg, tree, lm = fam
    toks = _tokens(cfg, 8, (B, prompt + N_DEC))
    batch, _ = batches(cfg, toks[:, :prompt], 8)
    _, jbatch = batches(cfg, toks, 8)
    step = engine.make_decode_step(cfg, RunConfig(), device="cpu")
    with recorded_routing() as calls:
        cache, last = engine.make_prefill_step(cfg, RunConfig(), MAX_LEN,
                                               device="cpu")(lm, batch)
        got = [last]
        for i in range(N_DEC):
            pos = prompt + i
            logits, cache = step(lm, cache, toks[:, pos:pos + 1], pos)
            got.append(logits)
    with use_mesh(cpu_mesh), jax_routing() as jcalls:
        full, _, _, _ = jmdl.forward(jcfg, JRunConfig(), _jax(tree), fam.jb,
                                     jbatch)
    want = np.asarray(full)[:, prompt - 1:]
    got = torch.stack(got, 1)
    rows = None
    if cfg.moe is not None:
        rows = alike(cfg, kept_experts(cfg, calls, B, prompt, N_DEC),
                     kept_experts(cfg, jcalls, B, prompt + N_DEC))
        rows = rows[:, prompt - 1:]
        assert rows.any()
    assert_logits_close(got, want, REL_OF.get(name, REL), rows)


def f32_cache(cache):
    return [{k: {n: t.float() for n, t in c.items()} for k, c in layer.items()}
            for layer in cache]


def test_serve_engine_matches_jax(fam, cpu_mesh):
    """The same 6 requests through both engines (4 slots, so two requests
    are re-seated in used slots), with f32 caches on both, as
    ``test_torch_lm.py`` runs TinyLlama's: equal step counts and token
    lists, every step's logits to ``REL``, and every row's top-2 margin
    above twice the largest logit difference. The reference re-seats a
    request without zeroing the slot's recurrent state and shares one
    position cursor; the port does the same (ROADMAP queue 3)."""
    name, cfg, jcfg, tree, lm = fam
    rng = np.random.default_rng(9)
    reqs = [engine.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, size=rng.integers(4, 12)).tolist(), max_new=8)
        for i in range(6)]
    runs = {}
    for side in ("torch", "jax"):
        if side == "torch":
            eng = engine.ServeEngine(cfg, RunConfig(), lm, slots=4,
                                     max_len=64, device="cpu")
            eng.cache = f32_cache(eng.cache)
        else:
            eng = jengine.ServeEngine(jcfg, JRunConfig(remat="none"),
                                      _jax(tree), fam.jb, cpu_mesh, slots=4,
                                      max_len=64)
            eng.cache = jax.tree.map(lambda a: a.astype(jnp.float32),
                                     eng.cache)
        mine = [dataclasses.replace(r, out=[]) for r in reqs]
        logits = []
        step = eng.decode

        def recorded(*args, step=step, logits=logits):
            out, cache = step(*args)
            logits.append(np.asarray(out, np.float32))
            return out, cache
        eng.decode = recorded
        for r in mine:
            eng.submit(r)
        steps = eng.run(max_steps=63)
        assert eng.closed and all(r.done for r in mine)
        runs[side] = (steps, [r.out for r in mine], np.stack(logits))
    (steps, outs, lt), (jsteps, jouts, lj) = runs["torch"], runs["jax"]
    assert steps == jsteps and outs == jouts
    assert_logits_close(lt, lj, SERVE_REL_OF.get(name, REL_OF.get(name,
                                                                  REL)))
    top2 = np.sort(lj, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > 2 * float(np.max(np.abs(lt - lj)))


def _bf16_tree(jcfg, tree):
    """The f32 tree in the schema's dtypes: bf16 but RG-LRU's f32 ``lam``,
    as the reference's ``init_params`` makes them."""
    schema, _ = jmdl.model_schema(jcfg)
    dts = jax.tree.map(lambda pd: pd.dtype, schema,
                       is_leaf=lambda x: hasattr(x, "dims"))
    return jax.tree.map(lambda a, dt: jnp.asarray(a).astype(dt), tree, dts)


def test_bf16_stream_dtypes_follow_the_reference(fam, cpu_mesh):
    """bf16 weights: the reference's embedding scale multiplies by a numpy
    f32 scalar, so gemma2's and recurrentgemma's stream, logits and prefill
    caches turn f32; the others stay bf16. The port's dtypes equal the
    reference's everywhere, and its values are within the reference's
    0.07. For the MoE families: on the rows that the bf16 and the f32
    forwards of both frameworks on the same weights all route alike
    (``routed_alike``: bf16 roundings flip top-k near-ties), to 0.07 or,
    where larger, what the triangle inequality allows: the reference's
    bf16 distance from its f32 forward, plus the port's from its own, plus
    the two f32 forwards' distance (the experts' outputs are large against
    the stream at reduced widths, and the reference's own bf16 error
    measured 0.06-0.26 of max |logit|). One decode
    step on the engines' bf16 ``init_cache`` then keeps the attention
    cache bf16 (the new key is cast into it) and, as ``jnp.concatenate``
    promotes, turns RG-LRU's conv window f32."""
    name, cfg, jcfg, tree, _ = fam
    jtree = _bf16_tree(jcfg, tree)
    lm16 = convert.params_from_numpy(_np(jtree), cfg, device="cpu",
                                     biases=fam.biases)
    toks = _tokens(cfg, 10, (B, S))
    batch, jbatch = batches(cfg, toks, 10)
    with recorded_routing() as calls:
        logits, cache, _, _ = mdl.forward(cfg, RunConfig(), lm16, batch,
                                          make_cache_len=MAX_LEN)
    with use_mesh(cpu_mesh), jax_routing() as jcalls:
        want, jcache, _, _ = jmdl.forward(jcfg, JRunConfig(), jtree, fam.jb,
                                          jbatch, make_cache_len=MAX_LEN)
    promoted = cfg.scale_embedding
    assert str(logits.dtype).split(".")[-1] == str(want.dtype) == \
        ("float32" if promoted else "bfloat16")
    got, want = logits.float().numpy(), np.asarray(want, np.float32)
    rows, bound, cache_bound = None, 0.07, 0.07
    if cfg.moe is not None:
        with use_mesh(cpu_mesh), jax_routing() as fcalls:
            want32, jcache32, _, _ = jmdl.forward(
                jcfg, JRunConfig(), _jax(tree), fam.jb, jbatch,
                make_cache_len=MAX_LEN)
        with recorded_routing() as pcalls:
            got32, cache32, _, _ = mdl.forward(
                cfg, RunConfig(), fam.lm, batch, make_cache_len=MAX_LEN)
        p16, j16, j32, p32 = (kept_experts(cfg, c, B, S) for c in
                              (calls, jcalls, fcalls, pcalls))
        rows = alike(cfg, p16, j16) & alike(cfg, j16, j32) & \
            alike(cfg, p16, p32)
        assert rows.any()
        got, want = got[rows], want[rows]
        want32, got32 = np.asarray(want32)[rows], got32.numpy()[rows]

        def dist(a, b):
            return float(np.max(np.abs(a - b)))
        bound = max(bound, (dist(want, want32) + dist(got, got32)
                            + dist(got32, want32))
                    / max(np.max(np.abs(want)), 1.0))
        mask = torch.as_tensor(rows)
        cache_bound = max([cache_bound] + [
            sum((a.float() - b.float())[:, :S][mask].abs().max().item()
                for a, b in ((j, j_), (t, t_), (t_, j_)))
            for j, j_, t, t_ in zip(
                jax.tree.leaves(port_cache(jcache, cfg)),
                jax.tree.leaves(port_cache(jcache32, cfg)),
                jax.tree.leaves(cache), jax.tree.leaves(cache32))])
    rel = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0)
    assert rel < bound, (rel, bound)
    assert_caches_close(cache, port_cache(jcache, cfg), rtol=0.07,
                        atol=cache_bound, rows=rows)

    tok = toks[:, :1]
    c16 = mdl.init_cache(cfg, B, MAX_LEN, device="cpu")
    _, c16 = engine.make_decode_step(cfg, RunConfig(), device="cpu")(
        lm16, c16, tok, 0)
    with use_mesh(cpu_mesh):
        _, j16 = jmdl.decode_step(jcfg, JRunConfig(), jtree, fam.jb,
                                  jmdl.init_cache(jcfg, B, MAX_LEN),
                                  jnp.asarray(tok), jnp.int32(0))
    want16 = port_cache(j16, cfg)
    assert [{k: {n: t.dtype for n, t in c.items()} for k, c in layer.items()}
            for layer in c16] == \
        [{k: {n: t.dtype for n, t in c.items()} for k, c in layer.items()}
         for layer in want16]


@pytest.mark.parametrize("name", NAMES)
def test_serve_cli_runs_on_the_cpu(name, capsys):
    eng, reqs, steps, _ = serve.main(["--arch", name, "--reduced",
                                      "--device", "cpu", "--requests", "3",
                                      "--max-new", "4"])
    assert eng.closed and steps > 0
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert "3/3 finished" in capsys.readouterr().out


def test_the_cpu_launches_no_kernel(fam):
    """On the CPU every attention call runs the plain formula."""
    name, cfg, jcfg, tree, lm = fam
    batch, _ = batches(cfg, _tokens(cfg, 11, (1, S)), 11)
    reset_launch_counts()
    with torch.inference_mode():
        lm(**batch)
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("name", ["musicgen-medium", "deepseek-v3-671b"])
def test_blocked_causal_forward_matches_jax(name, cpu_mesh):
    """``attention_impl="blocked_causal"`` over chunks of 16 (S = 40: the
    last q block is zero-padded), through the reference's
    ``_attend_blocked``: musicgen's self attention beside its cross
    attention (always the masked formula), deepseek's MLA at q/k head dim
    24 against v's 16."""
    f = make_fam(name)
    batch, jbatch = batches(f.cfg, _tokens(f.cfg, 12, (B, S)), 12)
    got, _, _, _ = mdl.forward(
        f.cfg, RunConfig(attention_impl="blocked_causal", attn_chunk=16),
        f.lm, batch)
    with use_mesh(cpu_mesh):
        want, _, _, _ = jmdl.forward(
            f.jcfg, JRunConfig(attention_impl="blocked_causal",
                               attn_chunk=16), _jax(f.tree), f.jb, jbatch)
    assert_logits_close(got, want, REL_OF.get(name, REL))
