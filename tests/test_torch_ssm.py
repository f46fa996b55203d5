"""The port's Mamba-2 SSD block (``repro_torch/models/ssm.py``) against the
JAX package's ``models/ssm.py``, function by function, on the CPU at
``get_arch("mamba2-1.3b").reduced()`` (d_model 64, d_inner 128, 8 SSD heads
of 16, d_state 16, chunk 16, conv width 4, one B/C group: G < H).

Parameters are the JAX package's f32 init with the constant ones
(``A_log``, ``D``, ``dt_bias``, ``gn``) moved by seeded draws; inputs are
numpy draws from a seed. The init folds ``hash(path)`` into each leaf's
key, so the draw takes the hashes of a fixed salt
(``test_torch_cases.salted_init``): 0, or ``salt`` in a case ``L@salt``.

Tolerance (f32): 1e-5 relative and absolute for every output and cache
entry, but ``ssm_apply``'s output. Both sides do the same f32 arithmetic;
the reference's three-operand einsums are an elementwise product and a
two-operand einsum in the port, so sums run in another order. The
block's output is held to ``APPLY_REL`` of its largest magnitude instead:
over eight draws (hash salts 0-7) at L = 32, 37 and 5, each framework's
f32 output was held to the port's run of the same weights in f64 (every
``float()`` cast made f64). The port is at most 9.6e-7 of max |y| from
f64, the reference 1.58e-6 (salt 2, L = 37, the case ``37@2``); the two
errors are independent, so their difference may reach the sum, 2.54e-6.
The frameworks differ by 2.2e-7 to 2.06e-6, and on ``37@2`` one element
of magnitude near 1 by 2e-5 (elementwise 1.02 times the old 1e-5 bound):
no formula differs. The caches stay within 0.33 of the elementwise
bound on every draw.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from test_torch_cases import salted_init  # noqa: E402

NAME = "mamba2-1.3b"
CFG = get_arch(NAME).reduced()
JCFG = jax_get_arch(NAME).reduced()
B = 2
TOL = dict(rtol=1e-5, atol=1e-5)
APPLY_REL = 2.6e-6          # derived in the module docstring


@functools.lru_cache(maxsize=None)
def draw(salt: int = 0) -> dict:
    p = salted_init(jsharding, jssm.ssm_schema(JCFG), jax.random.PRNGKey(2),
                    salt, dtype_override="float32")
    rng = np.random.default_rng(4)
    out = {k: np.asarray(v) for k, v in p.items()}
    for k in ("A_log", "D", "dt_bias", "gn"):
        out[k] = out[k] + (rng.normal(size=out[k].shape) * 0.3).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def params():
    return draw(0)


def _t(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(kw or TOL))


def _ssd_inputs(seed, L, H, G, N=16, P=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, size=(B, L, H)).astype(np.float32)
    A = -rng.uniform(0.2, 2.0, size=(H,)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, L, G, N)).astype(np.float32)
              for _ in range(2))
    return x, dt, A, Bm, Cm


def test_schema_reads_as_the_reference():
    def read(s):
        return {k: (v.shape, v.dims, v.init, v.scale, v.dtype)
                for k, v in s.items()}
    assert read(ssm.ssm_schema(CFG)) == read(jssm.ssm_schema(JCFG))
    assert read(ssm.ssm_cache_def(CFG, 3)) == read(jssm.ssm_cache_def(JCFG, 3))
    assert ssm.ssm_cache_def(CFG, 3)["state"].dtype == "float32"


def test_causal_conv_matches_jax(params):
    x = np.random.default_rng(1).normal(size=(B, 9, 128)).astype(np.float32)
    close(ssm._causal_conv(torch.as_tensor(x),
                           torch.as_tensor(params["conv_x"])),
          jssm._causal_conv(jnp.asarray(x), jnp.asarray(params["conv_x"])))


def test_segsum_matches_jax():
    """-inf above the diagonal, so exp gives exact zeros there."""
    a = -np.random.default_rng(2).uniform(0, 1, (B, 3, 16)).astype(np.float32)
    got = ssm._segsum(torch.as_tensor(a))
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    upper = ~np.tril(np.ones((16, 16), bool))
    assert np.all(np.isneginf(got.numpy()[..., upper]))
    assert np.all(np.isneginf(want[..., upper]))
    assert torch.all(torch.exp(got)[..., torch.as_tensor(upper)] == 0)
    lower = ~upper
    np.testing.assert_allclose(got.numpy()[..., lower], want[..., lower],
                               **TOL)


@pytest.mark.parametrize("L,chunk,H,G", [(32, 16, 4, 1), (48, 16, 4, 2),
                                         (16, 16, 8, 8), (20, 4, 6, 3)])
def test_ssd_chunked_matches_jax(L, chunk, H, G):
    """L a multiple of the chunk (1 to 5 chunks); G < H (1, 2 and 3
    groups) and G = H."""
    args = _ssd_inputs(L + H, L, H, G)
    got = ssm.ssd_chunked(*map(torch.as_tensor, args), chunk)
    want = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    close(got, want)


def test_ssd_chunked_refuses_a_ragged_length():
    args = _ssd_inputs(0, 20, 4, 1)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(*map(torch.as_tensor, args), 16)


def test_final_state_matches_jax():
    x, dt, A, Bm, _ = _ssd_inputs(5, 37, 8, 2)
    close(ssm._final_state(*map(torch.as_tensor, (x, dt, A, Bm))),
          jssm._final_state(*map(jnp.asarray, (x, dt, A, Bm))))


@pytest.mark.parametrize("case", ["32", "37", "5", "37@2"])
def test_ssm_apply_matches_jax(case):
    """L a multiple of the chunk, not one (the trailing pad), and shorter
    than one (the chunk shrinks to L): output (to ``APPLY_REL`` of its
    largest magnitude) and cache; ``37@2`` the draw of hash salt 2."""
    L, _, salt = case.partition("@")
    L, params = int(L), draw(int(salt or 0))
    x = np.random.default_rng(L).normal(size=(B, L, 64)).astype(np.float32)
    y, cache = ssm.ssm_apply(CFG, _t(params), torch.as_tensor(x),
                             make_cache=True)
    jy, jc = jssm.ssm_apply(JCFG, _j(params), jnp.asarray(x),
                            make_cache=True)
    jy = np.asarray(jy)
    assert np.abs(y.numpy() - jy).max() <= APPLY_REL * np.abs(jy).max()
    assert set(cache) == set(jc)
    for k in jc:
        assert tuple(cache[k].shape) == jc[k].shape
        close(cache[k], jc[k])
    y0, c0 = ssm.ssm_apply(CFG, _t(params), torch.as_tensor(x))
    assert c0 is None and torch.equal(y0, y)


def test_ssm_decode_after_prefill_matches_jax(params):
    """Prefill 21 steps, then 6 decode steps from the reference's cache
    carried across: each output and the final cache."""
    x = np.random.default_rng(7).normal(size=(B, 27, 64)).astype(np.float32)
    _, jc = jssm.ssm_apply(JCFG, _j(params), jnp.asarray(x[:, :21]),
                           make_cache=True)
    cache = {k: torch.as_tensor(np.asarray(v)) for k, v in jc.items()}
    for pos in range(21, 27):
        x1 = x[:, pos:pos + 1]
        y, cache = ssm.ssm_decode(CFG, _t(params), torch.as_tensor(x1),
                                  cache, pos)
        jy, jc = jssm.ssm_decode(JCFG, _j(params), jnp.asarray(x1), jc, pos)
        close(y, jy)
    for k in jc:
        close(cache[k], jc[k])


def test_decode_continues_the_prefill(params):
    """The port alone: prefill over L then one step equals prefill over
    L + 1 (output of the last step, and the cache)."""
    x = np.random.default_rng(8).normal(size=(B, 34, 64)).astype(np.float32)
    tp = _t(params)
    _, cache = ssm.ssm_apply(CFG, tp, torch.as_tensor(x[:, :33]),
                             make_cache=True)
    y1, c1 = ssm.ssm_decode(CFG, tp, torch.as_tensor(x[:, 33:]), cache, 33)
    y, c = ssm.ssm_apply(CFG, tp, torch.as_tensor(x), make_cache=True)
    np.testing.assert_allclose(y1[:, 0].numpy(), y[:, -1].numpy(), **TOL)
    for k in c:
        np.testing.assert_allclose(c1[k].numpy(), c[k].numpy(), **TOL)
