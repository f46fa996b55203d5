"""The port's multi-head latent attention (``repro_torch/models/attention.py``,
MLA) against the JAX package's ``models/attention.py``, on the CPU, at
``get_arch("deepseek-v3-671b").reduced()`` widths (d_model 64, 4 heads,
q_lora 32, kv_lora 16, nope 16, rope 8, v 16).

Parameters are the JAX package's f32 init with the zero-initialised
``q_norm`` and ``kv_norm`` moved by seeded draws; inputs are numpy draws
from a seed. Prefill runs the decompressed form (``mla_apply``), decode the
absorbed form against the latent cache (``mla_decode``).

Tolerance (f32): 1e-5 relative and absolute on projections, outputs and
caches (the same f32 arithmetic in another order of sums). bf16: the
families' 0.07 of max |y|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import attention, convert  # noqa: E402
from test_torch_cases import salted_init  # noqa: E402

NAME = "deepseek-v3-671b"
CFG = get_arch(NAME).reduced()
JCFG = jax_get_arch(NAME).reduced()
B, S, MAX_LEN, N_DEC = 2, 40, 48, 6
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    p = salted_init(jsharding, jattn.attn_schema(JCFG, "attn"),
                    jax.random.PRNGKey(2), dtype_override="float32")
    rng = np.random.default_rng(5)
    out = {k: np.asarray(v) for k, v in p.items()}
    for k in ("q_norm", "kv_norm"):
        out[k] = (rng.normal(size=out[k].shape) * 0.3).astype(np.float32)
    return out


def _t(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _x(seed, L):
    return np.random.default_rng(seed).normal(
        size=(B, L, CFG.d_model)).astype(np.float32)


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(kw or TOL))


def test_schema_and_cache_read_as_the_reference():
    def flat(tree):
        return {k: (v.shape, v.dims, v.init, v.scale, v.dtype)
                for k, v in tree.items()}
    assert flat(attention.attn_schema(CFG, "attn")) == \
        flat(jattn.attn_schema(JCFG, "attn"))
    assert flat(attention.cache_def(CFG, "attn", 3, 20)) == \
        flat(jattn.cache_def(JCFG, "attn", 3, 20))
    assert dataclasses.asdict(CFG.mla) == dataclasses.asdict(JCFG.mla)


def test_mla_qkv_matches_jax(params):
    x = _x(1, 12)
    pos = np.arange(3, 15)
    xt, pt = torch.as_tensor(x), torch.as_tensor(pos)
    got = (*attention._mla_q(CFG, _t(params), xt, pt),
           *attention._mla_latent(CFG, _t(params), xt, pt))
    want = jattn._mla_qkv(JCFG, _j(params), jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == w.shape
        close(g, w)


@pytest.mark.parametrize("impl, chunk", [("masked", 1024), ("chunked", 16)])
def test_mla_apply_matches_jax(params, impl, chunk):
    """The output and the cache padded to MAX_LEN, in one pass (masked) and
    in chunks of 16 keys (40 = 16 + 16 + 8: the last chunk padded)."""
    x = _x(2, S)
    pos = np.arange(S)
    y, cache = attention.mla_apply(CFG, _t(params), torch.as_tensor(x),
                                   positions=torch.as_tensor(pos), impl=impl,
                                   chunk=chunk, make_cache=MAX_LEN)
    jy, jc = jattn.mla_apply(JCFG, _j(params), jnp.asarray(x),
                             positions=jnp.asarray(pos), impl=impl,
                             chunk=chunk, make_cache=MAX_LEN)
    close(y, jy)
    assert cache.keys() == jc.keys() == {"ckv", "kr"}
    for k in cache:
        assert tuple(cache[k].shape) == jc[k].shape
        close(cache[k], jc[k])
    y0, c0 = attention.mla_apply(CFG, _t(params), torch.as_tensor(x),
                                 positions=torch.as_tensor(pos), impl=impl,
                                 chunk=chunk)
    assert c0 is None and torch.equal(y0, y)


def test_mla_decode_steps_match_jax(params):
    """N_DEC absorbed decode steps from the reference's own prefill cache,
    carried across: every step's output, and the cache after the last
    (written in place by the port)."""
    x = _x(3, S + N_DEC)
    _, jc = jattn.mla_apply(JCFG, _j(params), jnp.asarray(x[:, :S]),
                            positions=jnp.arange(S), impl="masked",
                            chunk=1024, make_cache=MAX_LEN)
    cache = {k: torch.as_tensor(np.asarray(v)) for k, v in jc.items()}
    for i in range(N_DEC):
        x1 = x[:, S + i:S + i + 1]
        y, out = attention.mla_decode(CFG, _t(params), torch.as_tensor(x1),
                                      cache, S + i)
        assert out is cache
        jy, jc = jattn.mla_decode(JCFG, _j(params), jnp.asarray(x1), jc,
                                  jnp.int32(S + i))
        close(y, jy)
    for k in cache:
        close(cache[k], jc[k])


def test_absorbed_decode_equals_the_decompressed_form(params):
    """The port's own two forms: prefill over S tokens then decode steps
    give what one ``mla_apply`` over S + N_DEC tokens gives at each decoded
    position."""
    x = torch.as_tensor(_x(4, S + N_DEC))
    full, _ = attention.mla_apply(CFG, _t(params), x,
                                  positions=torch.arange(S + N_DEC),
                                  impl="masked", chunk=1024)
    _, cache = attention.mla_apply(CFG, _t(params), x[:, :S],
                                   positions=torch.arange(S), impl="masked",
                                   chunk=1024, make_cache=MAX_LEN)
    for i in range(N_DEC):
        y, cache = attention.mla_decode(CFG, _t(params), x[:, S + i:S + i + 1],
                                        cache, S + i)
        close(y[:, 0], full[:, S + i])


def test_mla_bf16_follows_the_reference(params):
    """bf16 weights and a bf16 cache: the output and cache dtypes equal the
    reference's, the values within 0.07 of max |y|."""
    p16 = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    tp16 = {k: convert._to_torch(v) for k, v in p16.items()}
    x = jnp.asarray(_x(6, S + 1)).astype(jnp.bfloat16)
    tx = convert._to_torch(x)
    jy, jc = jattn.mla_apply(JCFG, p16, x[:, :S], positions=jnp.arange(S),
                             impl="masked", chunk=1024, make_cache=MAX_LEN)
    y, cache = attention.mla_apply(CFG, tp16, tx[:, :S],
                                   positions=torch.arange(S), impl="masked",
                                   chunk=1024, make_cache=MAX_LEN)
    jy1, jc = jattn.mla_decode(JCFG, p16, x[:, S:], jc, jnp.int32(S))
    y1, cache = attention.mla_decode(CFG, tp16, tx[:, S:], cache, S)
    for got, want in ((y, jy), (y1, jy1), (cache["ckv"], jc["ckv"]),
                      (cache["kr"], jc["kr"])):
        assert str(got.dtype).split(".")[-1] == str(want.dtype) == "bfloat16"
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.max(np.abs(got - want)) <= 0.07 * np.max(np.abs(want))


def test_mla_attention_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        attention.Attention(CFG, "attn")
    assert set(attention.Attention(CFG, "attn", device="cpu")._parameters) \
        == set(jattn.attn_schema(JCFG, "attn"))
