"""The port's LM serving path for olmo-1b, starcoder2-7b, gemma2-2b,
recurrentgemma-2b (RG-LRU) and mamba2-1.3b (SSD) against the JAX package's,
on the CPU, at ``get_arch(name).reduced()`` widths (d_model 64, 4 heads,
head dim 16, vocab 256; window 32; SSD chunk 16). recurrentgemma keeps its
published shape of full ``(rglru, rglru, local)`` units plus a
``(rglru, rglru)`` tail: 5 layers here, 26 at full width.

Both sides compute from one parameter tree: the JAX package's
``init_params(..., dtype_override="float32")``, every constant-initialised
leaf (norm scales, biases, RG-LRU's ``lam``, SSD's ``A_log``, ``D``,
``dt_bias``, ``gn``) moved by a seeded draw so it is exercised too, carried
into the port by ``convert.params_from_numpy``. Caches cross the same way
(``convert.cache_from_numpy``). Inputs are numpy draws from a seed. The JAX
side runs eagerly, as ``test_torch_lm.py`` runs it.

Tolerance (f32): the largest logit difference is at most 1e-5 of the
largest |logit| (``REL``, ``test_torch_lm.py``'s); caches to 1e-5
(relative and absolute). Both sides do the same f32 arithmetic in another
order of sums, and the RG-LRU scan runs chunks here against the
reference's ``associative_scan`` tree. bf16: the reference's own 0.07
(``test_smoke_archs.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import init_params  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert, transformer  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

NAMES = ["olmo-1b", "starcoder2-7b", "gemma2-2b", "recurrentgemma-2b",
         "mamba2-1.3b"]
REL = 1e-5
B, S, MAX_LEN, N_DEC = 2, 40, 56, 8


def small(name, get=get_arch):
    """The reduced config; recurrentgemma with its tail group."""
    cfg = get(name).reduced()
    if cfg.rglru is not None:
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern) + 2)
    return cfg


@pytest.fixture(scope="module", params=NAMES)
def fam(request):
    """(name, port config, JAX config, f32 numpy tree, port LM)."""
    name = request.param
    cfg, jcfg = small(name), small(name, jax_get_arch)
    schema, _ = jmdl.model_schema(jcfg)
    params = init_params(schema, jax.random.PRNGKey(0),
                         dtype_override="float32")
    rng = np.random.default_rng(7)

    def leaf(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):     # constant init
            a = a + (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        return a
    tree = jax.tree.map(leaf, params)
    return name, cfg, jcfg, tree, convert.params_from_numpy(tree, cfg,
                                                            device="cpu")


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def assert_logits_close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * float(np.max(np.abs(want))), (err, np.abs(want).max())


def assert_caches_close(got: list, want: list, rtol=1e-5, atol=1e-5):
    """Per layer, per mixer key, per entry: shape, dtype and values."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), i
        for key in g:
            assert g[key].keys() == w[key].keys(), (i, key)
            for name, t in g[key].items():
                ref = w[key][name]
                assert t.shape == ref.shape and t.dtype == ref.dtype, \
                    (i, key, name, t.shape, ref.shape, t.dtype, ref.dtype)
                np.testing.assert_allclose(t.float().numpy(),
                                           ref.float().numpy(), rtol=rtol,
                                           atol=atol, err_msg=f"{i} {key} "
                                           f"{name}")


def port_cache(jcache, cfg):
    return convert.cache_from_numpy(_np(jcache), cfg, device="cpu")


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

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
    name, per-layer shape and dtype (bf16, RG-LRU's ``lam`` f32), the tail
    group's layers included."""
    jschema, _ = jmdl.model_schema(jax_get_arch(name))
    groups, tail = jtfm.plan_layers(jax_get_arch(name))
    starts, n = {}, 0
    for gi, (sig, cnt) in enumerate(groups):
        starts[f"g{gi}"] = (n, len(sig))
        n += cnt * len(sig)
    starts["tail"] = (n, 0)
    want = {}
    for path, pd in jax.tree_util.tree_flatten_with_path(
            jschema, is_leaf=lambda x: hasattr(x, "dims"))[0]:
        keys = [p.key for p in path]
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

def test_forward_matches_jax(fam):
    name, cfg, jcfg, tree, lm = fam
    toks = _tokens(cfg, 4, (B, S))
    got, _, _ = mdl.forward(cfg, RunConfig(), lm,
                            {"tokens": torch.as_tensor(toks)})
    want, _, _, _ = jmdl.forward(jcfg, JRunConfig(), _jax(tree), {},
                                 {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, S, cfg.vocab_padded)
    assert_logits_close(got, want)


def test_prefill_matches_jax(fam):
    """Last logits and every layer's cache: attention keys and values (a
    local layer's ring of the last window, S > window), SSD's conv windows
    and f32 state, RG-LRU's conv window and f32 state."""
    name, cfg, jcfg, tree, lm = fam
    toks = _tokens(cfg, 5, (B, S))
    cache, last = engine.make_prefill_step(cfg, RunConfig(), MAX_LEN,
                                           device="cpu")(lm, {"tokens": toks})
    jcache, jlast = jmdl.prefill(jcfg, JRunConfig(), _jax(tree), {},
                                 {"tokens": jnp.asarray(toks)}, MAX_LEN)
    assert_logits_close(last, jlast)
    assert_caches_close(cache, port_cache(jcache, cfg))


def test_decode_steps_match_jax(fam):
    """N_DEC decode steps from the reference's own prefill cache, carried
    across: every step's logits and the final cache."""
    name, cfg, jcfg, tree, lm = fam
    toks = _tokens(cfg, 6, (B, S + N_DEC))
    jtree = _jax(tree)
    jcache, _ = jmdl.prefill(jcfg, JRunConfig(), jtree, {},
                             {"tokens": jnp.asarray(toks[:, :S])}, MAX_LEN)
    cache = port_cache(jcache, cfg)
    step = engine.make_decode_step(cfg, RunConfig(), device="cpu")
    for i in range(N_DEC):
        tok = toks[:, S + i:S + i + 1]
        got, cache = step(lm, cache, tok, S + i)
        want, jcache = jmdl.decode_step(jcfg, JRunConfig(), jtree, {},
                                        jcache, jnp.asarray(tok),
                                        jnp.int32(S + i))
        assert_logits_close(got, want)
    assert_caches_close(cache, port_cache(jcache, cfg))


@pytest.mark.parametrize("prompt", [28, 40])
def test_prefill_then_decode_matches_forward(fam, prompt):
    """The port's prefill over ``prompt`` tokens and N_DEC decode steps give
    the logits of the reference's full forward at each decoded position.
    For gemma2 and recurrentgemma the local layers' window is 32: at 28 the
    prompt is shorter than the window (the port's cache is the window,
    slot = position) and decode crosses it into the ring; at 40 prefill
    already wrapped. For mamba2 both lengths pad the last SSD chunk."""
    name, cfg, jcfg, tree, lm = fam
    toks = _tokens(cfg, 8, (B, prompt + N_DEC))
    cache, last = engine.make_prefill_step(cfg, RunConfig(), MAX_LEN,
                                           device="cpu")(
        lm, {"tokens": toks[:, :prompt]})
    full, _, _, _ = jmdl.forward(jcfg, JRunConfig(), _jax(tree), {},
                                 {"tokens": jnp.asarray(toks)})
    full = np.asarray(full)
    assert_logits_close(last, full[:, prompt - 1])
    step = engine.make_decode_step(cfg, RunConfig(), device="cpu")
    for i in range(N_DEC):
        pos = prompt + i
        got, cache = step(lm, cache, toks[:, pos:pos + 1], pos)
        assert_logits_close(got, full[:, pos])


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
                                      _jax(tree), {}, cpu_mesh, slots=4,
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
    assert_logits_close(lt, lj)
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


def test_bf16_stream_dtypes_follow_the_reference(fam):
    """bf16 weights: the reference's embedding scale multiplies by a numpy
    f32 scalar, so gemma2's and recurrentgemma's stream, logits and prefill
    caches turn f32; the others stay bf16. The port's dtypes equal the
    reference's everywhere, and its values are within the reference's
    0.07. One decode step on the engines' bf16 ``init_cache`` then keeps
    the attention cache bf16 (the new key is cast into it) and, as
    ``jnp.concatenate`` promotes, turns RG-LRU's conv window f32."""
    name, cfg, jcfg, tree, _ = fam
    jtree = _bf16_tree(jcfg, tree)
    lm16 = convert.params_from_numpy(_np(jtree), cfg, device="cpu")
    toks = _tokens(cfg, 10, (B, S))
    logits, cache, _ = mdl.forward(cfg, RunConfig(), lm16,
                                   {"tokens": torch.as_tensor(toks)},
                                   make_cache_len=MAX_LEN)
    want, jcache, _, _ = jmdl.forward(jcfg, JRunConfig(), jtree, {},
                                      {"tokens": jnp.asarray(toks)},
                                      make_cache_len=MAX_LEN)
    promoted = cfg.scale_embedding
    assert str(logits.dtype).split(".")[-1] == str(want.dtype) == \
        ("float32" if promoted else "bfloat16")
    got, want = logits.float().numpy(), np.asarray(want, np.float32)
    rel = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0)
    assert rel < 0.07, rel
    assert_caches_close(cache, port_cache(jcache, cfg), rtol=0.07, atol=0.07)

    tok = toks[:, :1]
    c16 = mdl.init_cache(cfg, B, MAX_LEN, device="cpu")
    _, c16 = engine.make_decode_step(cfg, RunConfig(), device="cpu")(
        lm16, c16, tok, 0)
    _, j16 = jmdl.decode_step(jcfg, JRunConfig(), jtree, {},
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
    reset_launch_counts()
    with torch.inference_mode():
        lm(torch.as_tensor(_tokens(cfg, 11, (1, S))))
    assert not any(LAUNCHES.values())
