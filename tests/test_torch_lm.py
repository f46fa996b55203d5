"""The port's LM serving path against the JAX package's, on the CPU, at
``get_arch("tinyllama-1.1b").reduced()`` (2 layers, d_model 64, 4 heads, 2
kv heads, head dim 16, d_ff 128, vocab 256).

Both sides compute from one parameter tree: the JAX package's
``init_params(..., dtype_override="float32")``, with the zero-initialised
norm scales replaced by seeded numpy draws so the norms are exercised too,
carried into the port by ``convert.params_from_numpy``. Inputs are numpy
draws from a seed.

Tolerance (f32): the largest logit difference is at most 1e-5 of the largest
|logit| (``REL``). Both sides do the same f32 arithmetic and differ only in
the order of sums (XLA's dots against PyTorch's) and the last bit of
``cos``/``sin``/``exp``; the largest measured error was about 1e-6 of
max |logit|. bf16: the reference's own 0.07 (``test_smoke_archs.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.parallel.sharding import init_params  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.configs import RunConfig, get_arch, registry  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (attention, common, convert, ffn,  # noqa: E402
                                moe, transformer)
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.params import schema_leaves  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

ARCH = "tinyllama-1.1b"
CFG = get_arch(ARCH).reduced()
JCFG = jax_get_arch(ARCH).reduced()
REL = 1e-5
B, S = 2, 32


@pytest.fixture(scope="module")
def tree():
    """The JAX package's f32 parameters as numpy, norm scales drawn."""
    schema, _ = jmdl.model_schema(JCFG)
    params = init_params(schema, jax.random.PRNGKey(0),
                         dtype_override="float32")
    rng = np.random.default_rng(7)

    def leaf(path, a):
        a = np.asarray(a)
        if "scale" in jax.tree_util.keystr(path):
            a = (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def lm(tree):
    return convert.params_from_numpy(tree, CFG, device="cpu")


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab, shape)


def assert_logits_close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * float(np.max(np.abs(want))), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_reads_as_the_reference(reduced):
    cfg, jcfg = get_arch(ARCH), jax_get_arch(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.dh, cfg.vocab_padded, cfg.layer_kinds) == \
        (jcfg.dh, jcfg.vocab_padded, jcfg.layer_kinds)
    assert cfg.n_params() == jcfg.n_params()
    assert mdl.count_params_total(cfg) == jmdl.count_params_total(jcfg)
    for impl in ("masked", "blocked_causal"):
        rc = RunConfig(attention_impl=impl, attn_chunk=16)
        jrc = JRunConfig(attention_impl=impl, attn_chunk=16)
        for s in (8, 16, 17, 4096):
            assert rc.attention_impl_for(s) == jrc.attention_impl_for(s)


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_get_arch_refuses_what_is_not_ported(name):
    """No architecture is refused any more: every one of the JAX package's
    ten reads as the reference's config, field for field."""
    assert not registry.NOT_PORTED
    assert sorted(registry.ARCHS) == sorted(JAX_ARCHS)
    assert dataclasses.asdict(get_arch(name)) == \
        dataclasses.asdict(jax_get_arch(name))


def test_module_layout_matches_the_reference_schema():
    """Full-width TinyLlama on the meta device: every parameter has the
    reference's name and per-layer shape."""
    jschema, _ = jmdl.model_schema(jax_get_arch(ARCH))
    want = {}
    for path, pd in jax.tree_util.tree_flatten_with_path(
            jschema, is_leaf=lambda x: hasattr(x, "dims"))[0]:
        keys = [p.key for p in path]
        if keys[0] == "stack":                   # [n_layers, ...] per group
            for i in range(pd.shape[0]):
                want[".".join(["stack", str(i), *keys[3:]])] = pd.shape[1:]
        else:
            want[".".join(keys)] = pd.shape
    lm = mdl.LM(get_arch(ARCH), device="meta")
    got = {k: tuple(v.shape) for k, v in lm.state_dict().items()}
    assert got == want
    assert all(v.dtype == torch.bfloat16 for v in lm.state_dict().values())


_BLOCKS = {
    "init_params": lambda **kw: tparams.init_params(
        ffn.ffn_schema(CFG), **kw),
    "ParamModule": lambda **kw: tparams.ParamModule(
        ffn.ffn_schema(CFG), **kw),
    "Attention": lambda **kw: attention.Attention(
        CFG, transformer.layer_plan(CFG)[0][0], **kw),
    "FFN": lambda **kw: ffn.FFN(CFG, **kw),
    "Layer": lambda **kw: transformer.Layer(
        CFG, *transformer.layer_plan(CFG)[0], **kw),
}


@pytest.mark.parametrize("block", list(_BLOCKS))
def test_building_blocks_default_to_the_card(monkeypatch, block):
    """Built alone, each of the LM's building blocks goes to the card unless
    asked for the CPU: without one it raises rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _BLOCKS[block]()
    built = _BLOCKS[block](device="cpu")
    tensors = (built.parameters() if isinstance(built, torch.nn.Module)
               else built.values())
    devices = {t.device.type for t in tensors}
    assert devices == {"cpu"}


def test_init_is_seeded_per_path():
    a = mdl.init(CFG, 3, device="cpu")
    b = mdl.init(CFG, 3, device="cpu")
    c = mdl.init(CFG, 4, device="cpu")
    leaves = schema_leaves(mdl.model_schema(CFG))
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if "scale" in name:                      # zeros, as in the reference
            assert not x.any()
            continue
        assert not torch.equal(x, z), name
        # N(0, 1/fan_in): the fan-in is the dim marked "embed", else the first
        pd = leaves[name]
        fan_in = pd.shape[pd.dims.index("embed")]
        assert abs(x.float().std().item() * fan_in ** 0.5 - 1) < 0.1, name


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["rmsnorm", "layernorm", "layernorm_np",
                                  "gelu", "rope", "rope_decode", "ffn"])
def test_primitives_match_jax(tree, what):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, CFG.d_model)).astype(np.float32)
    sc = tree["stack"]["g0"]["l0"]["norm1"]["scale"][0]
    if what == "rmsnorm":
        got = common.rmsnorm(torch.as_tensor(x), torch.as_tensor(sc))
        want = jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(sc))
    elif what.startswith("layernorm"):
        p = {"scale": 1 + sc, "bias": sc[::-1].copy()}
        got = common.apply_norm(what, torch.as_tensor(x),
                                {k: torch.as_tensor(v) for k, v in p.items()})
        want = jcommon.apply_norm(what, jnp.asarray(x), _jax(p))
    elif what == "gelu":
        got = common.activate("gelu", torch.as_tensor(x))
        want = jcommon.activate("gelu", jnp.asarray(x))
    elif what.startswith("rope"):
        xh = rng.normal(size=(B, 1 if what == "rope_decode" else S, 4, 16))
        xh = xh.astype(np.float32)
        pos = np.array([37]) if what == "rope_decode" else np.arange(S)
        got = common.rope(torch.as_tensor(xh), torch.as_tensor(pos), 1e4)
        want = jcommon.rope(jnp.asarray(xh), jnp.asarray(pos), 1e4)
    else:
        p = {k: v[0] for k, v in tree["stack"]["g0"]["l0"]["ffn"].items()}
        got = ffn.ffn_apply(CFG, {k: torch.tensor(v) for k, v in p.items()},
                            torch.as_tensor(x))
        want = jffn.ffn_apply(JCFG, _jax(p), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["masked", "chunked"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 0.0), (0, 30.0)])
def test_attend_matches_jax(impl, window, cap):
    """S = 40 over chunks of 16: the chunked loop pads its last chunk."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, 40, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(B, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, cap=cap, impl=impl, chunk=16)
    got = attention.attend(*map(torch.as_tensor, (q, k, v)), **kw)
    want = jattn.attend(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("impl", ["masked", "chunked"])
def test_attend_decode_mask_matches_jax(impl):
    """One query against a cache of 40 with the first 23 keys valid."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(B, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    valid = np.arange(40) <= 22
    got = attention.attend(*map(torch.as_tensor, (q, k, v)), causal=False,
                           impl=impl, chunk=16, k_valid=torch.as_tensor(valid))
    want = jattn.attend(*map(jnp.asarray, (q, k, v)), causal=False,
                        impl=impl, chunk=16, k_valid=jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


# (q shape, k shape, v shape, dtype, whether the flash kernel takes it)
FLASH_ELIGIBILITY = {
    "tinyllama": ((2, 16, 32, 64), (2, 16, 4, 64), None, torch.bfloat16, True),
    "f32": ((1, 8, 4, 128), (1, 8, 2, 128), None, torch.float32, True),
    "dh48": ((2, 16, 4, 48), (2, 16, 2, 48), None, torch.float32, False),
    "dv_ne_dh": ((2, 16, 4, 64), (2, 16, 2, 64), (2, 16, 2, 32),
                 torch.float32, False),
    "f16": ((2, 16, 32, 64), (2, 16, 4, 64), None, torch.float16, False),
    "heads_not_multiple": ((2, 16, 6, 64), (2, 16, 4, 64), None,
                           torch.bfloat16, False),
    "kv_length": ((2, 16, 4, 64), (2, 12, 2, 64), None, torch.float32,
                  False),
}


@pytest.mark.parametrize("case", list(FLASH_ELIGIBILITY))
def test_flash_supports_only_what_the_kernel_takes(case):
    """The predicate ``attend`` asks before it sends a call to the kernel,
    decided on CPU tensors from dtypes and shapes alone."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    qs, ks, vs, dtype, ok = FLASH_ELIGIBILITY[case]
    q, k, v = (torch.zeros(sh, dtype=dtype) for sh in (qs, ks, vs or ks))
    assert fkernel.supports(q, k, v) is ok


def test_attend_never_calls_the_kernel_on_the_cpu(monkeypatch):
    """A call the kernel would take on the card runs the plain formula on
    the CPU (the reference's answer), for every impl."""
    def refuse(*args, **kwargs):
        raise AssertionError("the flash kernel was called on the CPU")

    monkeypatch.setattr(attention, "flash_attention", refuse)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(B, 16, 4, 64)).astype(np.float32)
    k, v = (rng.normal(size=(B, 16, 2, 64)).astype(np.float32)
            for _ in range(2))
    reset_launch_counts()
    for impl in ("masked", "chunked", "blocked_causal"):
        got = attention.attend(*map(torch.as_tensor, (q, k, v)), causal=True,
                               impl=impl, chunk=16)
        want = jattn.attend(*map(jnp.asarray, (q, k, v)), causal=True,
                            impl=impl, chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=0)
    assert LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("S", [20, 8])
def test_local_attention_ring_cache_matches_jax(tree, S):
    """A local layer (window 8 < max_len 32): prefill keeps the last window
    of keys in ring order (slot = pos % window), and two decode steps write
    into the ring and mask by it. At S = window both layouts agree; the
    reference keeps only S rows for S < window (ROADMAP queue 3), so that
    case is not compared."""
    cfg, jcfg = (dataclasses.replace(c, window=8) for c in (CFG, JCFG))
    p = {k: v[0] for k, v in tree["stack"]["g0"]["l0"]["attn"].items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    x = np.random.default_rng(12).normal(size=(B, S + 2, 64)).astype(np.float32)
    kw = dict(kind="local", impl="masked", chunk=1024, make_cache=32)
    y, cache = attention.gqa_apply(cfg, tp, torch.as_tensor(x[:, :S]),
                                   positions=torch.arange(S), **kw)
    jy, jc = jattn.gqa_apply(jcfg, _jax(p), jnp.asarray(x[:, :S]),
                             positions=jnp.arange(S), **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        assert cache[name].shape == (B, 8, 2, 16)
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=1e-5)
    for pos in (S, S + 1):
        x1 = x[:, pos:pos + 1]
        y, cache = attention.gqa_decode(cfg, tp, torch.as_tensor(x1), cache,
                                        pos, kind="local")
        jy, jc = jattn.gqa_decode(jcfg, _jax(p), jnp.asarray(x1), jc,
                                  jnp.int32(pos), kind="local")
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)


def test_unported_paths_raise():
    """What is still unported on a mesh with a ``model`` axis (ROADMAP
    queue 1 item 5, what is left of it): tensor parallelism of MLA's heads
    (deepseek-v3 serves on a mesh only once it is ported; its train step
    keeps the expert-parallel layout with the rest as copies) and of heads
    the model ranks do not divide. The explicit replicated sync (item 3)
    and tensor parallelism of the GQA transformer are ported. Deepseek's
    MTP loss and the router-bias update, unported until the training
    slice, now compute."""
    cfg = get_arch("deepseek-v3-671b").reduced()
    lm = mdl.init(cfg, 0, device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.long)
    loss = mdl.mtp_loss(cfg, RunConfig(), lm, toks,
                        torch.zeros(1, 8, 64, dtype=torch.bfloat16))
    assert loss.shape == () and torch.isfinite(loss)
    layer = lm.stack[cfg.moe.start_layer]
    bias = moe.update_router_bias(cfg.moe, layer.moe.bias,
                                  torch.ones(cfg.moe.n_experts_padded))
    assert bias.shape == layer.moe.bias.shape

    class Mesh:                  # model ranks: only names and sizes read
        mesh_dim_names = ("data", "model")
        device_type = "cpu"

        def __init__(self, tp=2):
            self.tp = tp

        def size(self, i):
            return (1, self.tp)[i]
    from repro_torch.serving import engine
    from repro_torch.training import make_train_step
    with pytest.raises(NotImplementedError,
                       match="tensor parallelism.*MLA.*queue 1 item 5"):
        engine.make_decode_step(cfg, RunConfig(), device="cpu", mesh=Mesh())
    assert callable(make_train_step(cfg, RunConfig(), Mesh()))
    tiny = get_arch("tinyllama-1.1b").reduced()
    assert callable(make_train_step(
        tiny, RunConfig(pod_param_mode="replicated"), Mesh()))
    with pytest.raises(NotImplementedError,
                       match="tensor parallelism.*4 heads on 8.*item 5"):
        make_train_step(tiny, RunConfig(), Mesh(8))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1024, 16])
def test_forward_matches_jax(tree, lm, chunk):
    toks = _tokens(4, (B, S))
    got, _, _, _ = mdl.forward(CFG, RunConfig(attn_chunk=chunk), lm,
                            {"tokens": torch.as_tensor(toks)})
    want, _, _, _ = jmdl.forward(JCFG, JRunConfig(attn_chunk=chunk),
                                 _jax(tree), {}, {"tokens": jnp.asarray(toks)})
    assert got.shape == (B, S, CFG.vocab_padded)
    assert_logits_close(got, want)


def test_prefill_matches_jax(tree, lm):
    toks = _tokens(5, (B, S))
    cache, last = engine.make_prefill_step(CFG, RunConfig(), S + 8,
                                           device="cpu")(lm, {"tokens": toks})
    jcache, jlast = jmdl.prefill(JCFG, JRunConfig(), _jax(tree), {},
                                 {"tokens": jnp.asarray(toks)}, S + 8)
    assert_logits_close(last, jlast)
    want = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), CFG,
                                    device="cpu")
    assert len(cache) == len(want) == CFG.n_layers
    for c, w in zip(cache, want):
        for name in ("k", "v"):
            assert c["attn"][name].shape == (B, S + 8, 2, 16)
            np.testing.assert_allclose(c["attn"][name].numpy(),
                                       w["attn"][name].numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_decode_step_matches_jax(tree, lm):
    """One decode step from the reference's own prefill cache, carried
    across: logits and the updated cache."""
    toks = _tokens(6, (B, S + 1))
    jcache, _ = jmdl.prefill(JCFG, JRunConfig(), _jax(tree), {},
                             {"tokens": jnp.asarray(toks[:, :S])}, S + 8)
    cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), CFG,
                                     device="cpu")
    step = engine.make_decode_step(CFG, RunConfig(), device="cpu")
    got, cache = step(lm, cache, toks[:, S:], S)
    want, jcache = jmdl.decode_step(JCFG, JRunConfig(), _jax(tree), {},
                                    jcache, jnp.asarray(toks[:, S:]),
                                    jnp.int32(S))
    assert_logits_close(got, want)
    want_cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                          CFG, device="cpu")
    for c, w in zip(cache, want_cache):
        for name in ("k", "v"):
            np.testing.assert_allclose(c["attn"][name].numpy(),
                                       w["attn"][name].numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_prefill_then_decode_matches_forward(tree, lm):
    """test_smoke_archs' consistency check, in f32, against the reference's
    full forward over the S + 1 tokens."""
    toks = _tokens(8, (B, S + 1))
    cache, _ = engine.make_prefill_step(CFG, RunConfig(), S + 8,
                                        device="cpu")(lm, {"tokens": toks[:, :S]})
    dec, _ = engine.make_decode_step(CFG, RunConfig(), device="cpu")(
        lm, cache, toks[:, S:], S)
    full, _, _, _ = jmdl.forward(JCFG, JRunConfig(), _jax(tree), {},
                                 {"tokens": jnp.asarray(toks)})
    assert_logits_close(dec, full[:, S])


def f32_cache(cache):
    return [{"attn": {n: t.float() for n, t in c["attn"].items()}}
            for c in cache]


def test_serve_engine_matches_jax(tree, lm, cpu_mesh):
    """The same requests through both engines, with f32 caches on both:
    equal step counts and token lists, the logits of every step to ``REL``,
    and every row's top-2 logit margin above twice the largest logit
    difference, so no argmax can differ by rounding.

    The engines' default cache is bf16 (the reference's ``init_cache``).
    There a key whose f32 value differs in its last bit between the
    frameworks (sums in another order) can round to the neighbouring bf16
    value, about once a run, which moves a later logit by ~1e-3; with f32
    caches the comparison is of the serving logic and the model alone."""
    rng = np.random.default_rng(9)
    reqs = [engine.Request(rid=i, prompt=rng.integers(
        0, CFG.vocab, size=rng.integers(4, 12)).tolist(), max_new=8)
        for i in range(6)]
    runs = {}
    for side in ("torch", "jax"):
        if side == "torch":
            eng = engine.ServeEngine(CFG, RunConfig(), lm, slots=4,
                                     max_len=64, device="cpu")
            eng.cache = f32_cache(eng.cache)
        else:
            eng = jengine.ServeEngine(JCFG, JRunConfig(remat="none"),
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
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(reqs[0])
        runs[side] = (steps, [r.out for r in mine], np.stack(logits))
    (steps, outs, lt), (jsteps, jouts, lj) = runs["torch"], runs["jax"]
    assert steps == jsteps and outs == jouts
    assert_logits_close(lt, lj)
    top2 = np.sort(lj, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > 2 * float(np.max(np.abs(lt - lj)))


def test_forward_bf16_matches_jax(tree):
    """bf16 weights on both sides (the f32 tree rounded to nearest even by
    each framework, so the weights are equal), to the reference's 0.07."""
    lm16 = convert.params_from_numpy(tree, CFG, device="cpu",
                                     dtype=torch.bfloat16)
    toks = _tokens(10, (B, S))
    got, _, _, _ = mdl.forward(CFG, RunConfig(), lm16,
                            {"tokens": torch.as_tensor(toks)})
    jtree = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    want, _, _, _ = jmdl.forward(JCFG, JRunConfig(), jtree, {},
                                 {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    rel = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0)
    assert rel < 0.07, rel


def test_modules_run_the_plain_functions(lm):
    """``LM``, ``Layer`` and ``FFN`` called as modules compute what the
    plain functions compute, and on the CPU launch no kernel."""
    toks = torch.as_tensor(_tokens(11, (1, 20)))
    rc = RunConfig()
    reset_launch_counts()
    with torch.inference_mode():
        assert torch.equal(lm(toks), mdl.forward(CFG, rc, lm,
                                                 {"tokens": toks})[0])
        x = lm.embed.tok[toks]
        pos = torch.arange(20)
        layer = lm.stack[0]
        y, cache, aux = layer(x, rc=rc, positions=pos, make_cache_len=24)
        want, wcache, _ = transformer.layer_apply(
            CFG, rc, layer, x, kind="attn", ffn="dense", positions=pos,
            make_cache_len=24)
        assert torch.equal(y, want) and aux == {}
        assert torch.equal(cache["attn"]["k"], wcache["attn"]["k"])
        assert torch.equal(layer.ffn(x), ffn.ffn_apply(CFG, layer.ffn, x))
        y, c = layer.attn(x, positions=pos, impl="masked", chunk=1024)
        want, _ = attention.gqa_apply(CFG, layer.attn, x, kind="attn",
                                      positions=pos, impl="masked",
                                      chunk=1024)
        assert torch.equal(y, want) and c is None
    assert not any(LAUNCHES.values())


def test_serve_cli_runs_on_the_cpu(capsys):
    eng, reqs, steps, _ = serve.main(["--reduced", "--device", "cpu",
                                      "--requests", "5"])
    assert eng.closed and steps > 0
    assert len(reqs) == 5 and all(r.done and len(r.out) == 16 for r in reqs)
    assert "5/5 finished" in capsys.readouterr().out
