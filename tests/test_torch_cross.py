"""The port's MusicGen and InternVL2 building blocks and ``blocked_causal``
attention against the JAX package's, on the CPU: ``sinusoidal_pos``,
``model._embed`` with the sinusoidal table and with a prefix of
embeddings, cross attention (``gqa_apply``/``gqa_decode`` with
``kind="cross"``) at ``get_arch("musicgen-medium").reduced()`` widths
(d_model 64, 4 heads of 16, ``cond_len`` 8), and ``attend(impl=
"blocked_causal")`` against the reference's ``_attend_blocked``.

Parameters are the JAX package's f32 init; inputs are numpy draws from a
seed (``cond`` and ``prefix`` bf16, as ``test_smoke_archs.py`` makes them).

Tolerances: ``sinusoidal_pos`` 1e-6 absolute (both take the same f32
frequencies and angles; ``sin``/``cos`` of angles up to 4,096 differ in
the last bit); the embeddings and cross attention 1e-5 relative and
absolute (the same f32 arithmetic in another order of sums; bf16 equal
where the two round alike); ``blocked_causal`` 2e-6 absolute, as
``test_torch_lm.py`` holds the other inner loops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.models import attention, common, convert  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from test_torch_cases import salted_init  # noqa: E402

MUSICGEN, INTERNVL2 = "musicgen-medium", "internvl2-2b"
B, S = 2, 40
TOL = dict(rtol=1e-5, atol=1e-5)


def cfgs(name):
    return get_arch(name).reduced(), jax_get_arch(name).reduced()


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(kw or TOL))


def bf16(a):
    """numpy f32 -> the same values as a torch bf16 tensor and a jax bf16
    array."""
    a = np.asarray(a, np.float32).astype(jnp.bfloat16)
    return (torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16),
            jnp.asarray(a))


# ---------------------------------------------------------------------------
# sinusoidal positions and the embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 1536])
def test_sinusoidal_pos_matches_jax(d):
    """f32 at positions 0..4,096 (MusicGen's published width and the
    reduced one), and the bf16 table within one bf16 ulp."""
    pos = np.arange(4097)
    got = common.sinusoidal_pos(torch.as_tensor(pos), d, torch.float32)
    want = jcommon.sinusoidal_pos(jnp.asarray(pos), d, jnp.float32)
    assert got.shape == (4097, d) and got.dtype == torch.float32
    close(got, want, rtol=0, atol=1e-6)
    got16 = common.sinusoidal_pos(torch.as_tensor(pos), d)
    want16 = jcommon.sinusoidal_pos(jnp.asarray(pos), d)
    assert got16.dtype == torch.bfloat16
    close(got16.float(), want16, rtol=2 ** -8, atol=2 ** -9)


def test_sinusoidal_pos_broadcasts_over_a_batch_of_positions():
    pos = np.arange(12).reshape(3, 4) * 97
    got = common.sinusoidal_pos(torch.as_tensor(pos), 16, torch.float32)
    want = jcommon.sinusoidal_pos(jnp.asarray(pos), 16, jnp.float32)
    assert got.shape == (3, 4, 16)
    close(got, want, rtol=0, atol=1e-6)


def _embed_params(cfg, jcfg, dtype):
    schema, _ = jmdl.model_schema(jcfg)
    tok = np.asarray(salted_init(jsharding, schema, jax.random.PRNGKey(3),
                                 dtype_override="float32")["embed"]["tok"])
    if dtype == "bfloat16":
        t, j = bf16(tok)
        return {"embed": {"tok": t}}, {"embed": {"tok": j}}
    return ({"embed": {"tok": torch.from_numpy(tok.copy())}},
            {"embed": {"tok": jnp.asarray(tok)}})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [MUSICGEN, INTERNVL2])
def test_embed_matches_jax(name, dtype):
    """musicgen: the token embedding plus the sinusoidal table, over a
    prompt and at one decode position; internvl2: the first 4 rows are the
    prefix's, the rest the tokens' (rope is applied inside attention)."""
    cfg, jcfg = cfgs(name)
    p, jp = _embed_params(cfg, jcfg, dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S))
    prefix = jprefix = None
    if cfg.prefix_embeds:
        prefix, jprefix = bf16(rng.normal(size=(B, cfg.prefix_embeds,
                                                cfg.d_model)))
    got = mdl._embed(cfg, p, torch.as_tensor(toks),
                     torch.arange(S), prefix)
    want = jmdl._embed(jcfg, jp, jnp.asarray(toks), jnp.arange(S), jprefix)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    close(got.float(), want)
    if prefix is not None:
        assert torch.equal(got[:, :cfg.prefix_embeds].float(),
                           prefix.float())
    got1 = mdl._embed(cfg, p, torch.as_tensor(toks[:, :1]),
                      torch.tensor([S + 7], dtype=torch.int32))
    want1 = jmdl._embed(jcfg, jp, jnp.asarray(toks[:, :1]),
                        jnp.zeros((1,), jnp.int32) + (S + 7))
    close(got1.float(), want1)


def test_embed_refuses_a_prefix_longer_than_the_prompt():
    """The reference's concatenation would come out longer than the tokens
    (``S < P``): the port refuses instead of computing something else."""
    cfg, jcfg = cfgs(INTERNVL2)
    p, _ = _embed_params(cfg, jcfg, "float32")
    prefix = torch.zeros(B, cfg.prefix_embeds, cfg.d_model)
    toks = torch.zeros(B, cfg.prefix_embeds - 1, dtype=torch.long)
    with pytest.raises(ValueError, match="prefix of 4"):
        mdl._embed(cfg, p, toks, torch.arange(toks.shape[1]), prefix)
    got = mdl._embed(cfg, p, torch.zeros(B, 4, dtype=torch.long),
                     torch.arange(4), prefix)
    assert torch.equal(got, prefix)


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross():
    """(port params, jax params) of one cross-attention block, f32."""
    cfg, jcfg = cfgs(MUSICGEN)
    p = salted_init(jsharding, jattn.attn_schema(jcfg, "cross"),
                    jax.random.PRNGKey(4), dtype_override="float32")
    p = {k: np.array(v) for k, v in p.items()}
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def test_cross_schema_and_cache_read_as_the_reference():
    """GQA weights and a ``cond_len`` cache, under MLA too (deepseek's
    reduced config)."""
    def flat(tree):
        return {k: (v.shape, v.dims, v.init, v.dtype) for k, v in
                tree.items()}
    for name in (MUSICGEN, "deepseek-v3-671b"):
        cfg, jcfg = cfgs(name)
        assert flat(attention.attn_schema(cfg, "cross")) == \
            flat(jattn.attn_schema(jcfg, "cross"))
        assert flat(attention.cache_def(cfg, "cross", 3, 20)) == \
            flat(jattn.cache_def(jcfg, "cross", 3, 20))
        assert attention.cache_def(cfg, "cross", 3, 20)["k"].shape == \
            (3, cfg.cond_len, cfg.n_kv_heads, cfg.dh)


@pytest.mark.parametrize("cond_dtype", ["float32", "bfloat16"])
def test_cross_apply_and_decode_match_jax(cross, cond_dtype):
    """Prefill: the output over S queries and the cache (keys and values
    of ``cond`` at ``cond_len``, in the dtype the projections give: f32
    from f32 weights, whatever ``cond``'s dtype). Decode: 3 steps, each
    output to the reference's, and the cache neither written nor
    replaced."""
    cfg, jcfg = cfgs(MUSICGEN)
    p, jp = cross
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S + 3, cfg.d_model)).astype(np.float32)
    c = rng.normal(size=(B, cfg.cond_len, cfg.d_model)).astype(np.float32)
    cond, jcond = bf16(c) if cond_dtype == "bfloat16" else \
        (torch.as_tensor(c), jnp.asarray(c))
    kw = dict(kind="cross", impl="masked", chunk=16, make_cache=S + 8)
    y, cache = attention.gqa_apply(cfg, p, torch.as_tensor(x[:, :S]),
                                   positions=torch.arange(S), cond=cond, **kw)
    jy, jc = jattn.gqa_apply(jcfg, jp, jnp.asarray(x[:, :S]),
                             positions=jnp.arange(S), cond=jcond, **kw)
    close(y, jy)
    for k in ("k", "v"):
        assert cache[k].shape == (B, cfg.cond_len, cfg.n_kv_heads, cfg.dh)
        assert cache[k].dtype == torch.float32 and str(jc[k].dtype) == \
            "float32"
        close(cache[k], jc[k])
    before = {k: t.clone() for k, t in cache.items()}
    for pos in range(S, S + 3):
        x1 = x[:, pos:pos + 1]
        y1, cache1 = attention.gqa_decode(cfg, p, torch.as_tensor(x1),
                                          cache, pos, kind="cross")
        jy1, jc = jattn.gqa_decode(jcfg, jp, jnp.asarray(x1), jc,
                                   jnp.int32(pos), kind="cross")
        close(y1, jy1)
        assert cache1 is cache
        assert all(torch.equal(cache[k], before[k]) for k in before)


def test_cross_attention_needs_cond(cross):
    cfg, _ = cfgs(MUSICGEN)
    with pytest.raises(ValueError, match="cond"):
        attention.gqa_apply(cfg, cross[0], torch.zeros(B, 4, cfg.d_model),
                            kind="cross", positions=torch.arange(4),
                            impl="masked", chunk=16)


def test_cross_layer_is_the_reference_layer(cross):
    """One musicgen layer, prefill and one decode step: the self-attention
    mixer, then ``x + cross(norm_x(x), cond)``, then the FFN; the layer's
    cache holds ``attn`` and ``cross``."""
    cfg, jcfg = cfgs(MUSICGEN)
    schema = jtfm.layer_schema(jcfg, "attn", "dense")
    jp = salted_init(jsharding, schema, jax.random.PRNGKey(8),
                     dtype_override="float32")
    rng = np.random.default_rng(8)
    jp = jax.tree.map(lambda a: np.asarray(a) + (
        rng.normal(size=a.shape) * 0.1).astype(np.float32), jp)
    p = convert._map(convert._to_torch, jp)
    x = rng.normal(size=(B, S + 1, cfg.d_model)).astype(np.float32)
    cond, jcond = bf16(rng.normal(size=(B, cfg.cond_len, cfg.d_model)))
    y, c, _ = transformer.layer_apply(
        cfg, RunConfig(), p, torch.as_tensor(x[:, :S]), kind="attn",
        ffn="dense", positions=torch.arange(S), cond=cond,
        make_cache_len=S + 4)
    jy, jc, _ = jtfm.layer_apply(
        jcfg, JRunConfig(), jax.tree.map(jnp.asarray, jp), None,
        jnp.asarray(x[:, :S]), kind="attn", ffn="dense",
        positions=jnp.arange(S), cond=jcond, make_cache_len=S + 4)
    close(y, jy)
    assert sorted(c) == sorted(jc) == ["attn", "cross"]
    y1, c1 = transformer.layer_decode(cfg, RunConfig(), p, c,
                                      torch.as_tensor(x[:, S:]), S,
                                      kind="attn", ffn="dense")
    jy1, _ = jtfm.layer_decode(jcfg, JRunConfig(),
                               jax.tree.map(jnp.asarray, jp), None, jc,
                               jnp.asarray(x[:, S:]), jnp.int32(S),
                               kind="attn", ffn="dense")
    close(y1, jy1)
    assert sorted(c1) == ["attn", "cross"]


# ---------------------------------------------------------------------------
# blocked_causal
# ---------------------------------------------------------------------------

BLOCKED_CASES = [
    # (S, H, Kv, dh, dv, window, cap)
    (40, 4, 2, 16, 16, 0, 0.0),
    (48, 4, 2, 16, 16, 0, 0.0),
    (40, 4, 2, 16, 16, 8, 0.0),
    (48, 4, 2, 16, 16, 0, 30.0),
    (40, 4, 4, 24, 16, 0, 0.0),        # MLA's reduced q/k and v head dims
    (48, 4, 4, 24, 16, 8, 30.0),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", BLOCKED_CASES)
def test_attend_blocked_matches_jax(case, causal):
    """Chunk 16: S = 40 pads the last block, 48 does not; the window's
    lower block bound and the softcap go through the same schedule."""
    S_, H, Kv, dh, dv, window, cap = case
    rng = np.random.default_rng(S_ + dh + window)
    q = rng.normal(size=(B, S_, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S_, Kv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S_, Kv, dv)).astype(np.float32)
    kw = dict(causal=causal, window=window, cap=cap, impl="blocked_causal",
              chunk=16)
    got = attention.attend(*map(torch.as_tensor, (q, k, v)), **kw)
    want = jattn.attend(*map(jnp.asarray, (q, k, v)), **kw)
    assert got.shape == (B, S_, H, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)
    if causal and not window:
        # the schedule skips only blocks the mask empties: the same answer
        # as the chunked loop, which computes every block
        chunked = attention.attend(*map(torch.as_tensor, (q, k, v)),
                                   **{**kw, "impl": "chunked"})
        np.testing.assert_allclose(got.numpy(), chunked.numpy(), atol=2e-6,
                                   rtol=0)


def test_attend_blocked_refuses_positions_and_key_masks():
    """The reference's branch drops ``q_pos``, ``k_pos`` and ``k_valid``;
    the port refuses them."""
    x = torch.zeros(1, 40, 4, 16)
    for kw in (dict(q_pos=torch.arange(40)), dict(k_pos=torch.arange(40)),
               dict(k_valid=torch.ones(40, dtype=torch.bool))):
        with pytest.raises(ValueError, match="blocked_causal"):
            attention.attend(x, x, x, causal=True, impl="blocked_causal",
                             chunk=16, **kw)
