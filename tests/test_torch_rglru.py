"""The port's RG-LRU block (``repro_torch/models/rglru.py``) against the JAX
package's ``models/rglru.py``, function by function, on the CPU at
``get_arch("recurrentgemma-2b").reduced()`` (d_model 64, lru_width 64, 4
gate blocks of 16, conv width 4).

Parameters are the JAX package's f32 init with ``b_r``, ``b_i`` and ``lam``
moved by seeded draws; inputs are numpy draws from a seed.

Tolerance (f32): 1e-5 relative and absolute for the gates, the block
output and the caches. The prefill recurrence is the widest gap: the
reference runs ``jax.lax.associative_scan``, the port a chunked scan
(``_scan``), and the two multiply the decays in another order. Against the
associative scan ``_scan`` is held to 2e-6 absolute on states of order 1
(decays in (0, 1); measured about 2e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.common import softplus  # noqa: E402
from test_torch_cases import salted_init  # noqa: E402

NAME = "recurrentgemma-2b"
CFG = get_arch(NAME).reduced()
JCFG = jax_get_arch(NAME).reduced()
B = 2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    p = salted_init(jsharding, jrglru.rglru_schema(JCFG),
                    jax.random.PRNGKey(1), dtype_override="float32")
    rng = np.random.default_rng(3)
    out = {k: np.asarray(v) for k, v in p.items()}
    for k in ("b_r", "b_i", "lam"):
        out[k] = out[k] + (rng.normal(size=out[k].shape) * 0.5).astype(
            np.float32)
    return out


def _t(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _x(seed, L, width=None):
    return np.random.default_rng(seed).normal(
        size=(B, L, width or CFG.d_model)).astype(np.float32)


def close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(kw or TOL))


def test_schema_reads_as_the_reference():
    jschema = jrglru.rglru_schema(JCFG)
    schema = rglru.rglru_schema(CFG)
    assert {k: (v.shape, v.dims, v.init, v.scale, v.dtype)
            for k, v in schema.items()} == \
        {k: (v.shape, v.dims, v.init, v.scale, v.dtype)
         for k, v in jschema.items()}
    assert schema["lam"].dtype == "float32"
    assert {k: (v.shape, v.dtype) for k, v in
            rglru.rglru_cache_def(CFG, 3).items()} == \
        {k: (v.shape, v.dtype) for k, v in
         jrglru.rglru_cache_def(JCFG, 3).items()}


def test_block_linear_matches_jax(params):
    u = _x(1, 12)
    got = rglru._block_linear(torch.as_tensor(u), torch.as_tensor(
        params["w_r"]), torch.as_tensor(params["b_r"]))
    want = jrglru._block_linear(jnp.asarray(u), jnp.asarray(params["w_r"]),
                                jnp.asarray(params["b_r"]))
    close(got, want)


def test_gates_match_jax(params):
    """``a`` and ``g = sqrt(max(1 - exp(2 log_a), 1e-12)) * i * u`` with
    ``c = 8``. Every odd channel's ``lam`` is near -60, so its ``a`` rounds
    to 1 and the 1e-12 floor is taken on both sides exactly.

    Near ``a = 1`` the subtraction ``1 - exp(2 log_a)`` cancels: the two
    frameworks' ``exp`` differ by up to one ulp, and one ulp there moves
    ``g`` by about ``ulp / (2 (1 - a^2))`` of itself (``1 - a^2`` of 14 ulps
    moved ``g`` from 1.3706e-4 to 1.4224e-4). So ``e = exp(2 log_a)`` is
    computed on both sides as ``_gates`` computes it and held to one ulp
    where ``e > 0.5`` (elsewhere to 1e-5 of itself: there ``log_a``'s last
    bit, times ``2 |log_a|``, moves ``e`` by a few tens of ulps, and ``1 -
    e`` does not cancel), and each element of ``g`` to 1e-5 (relative and
    absolute) beyond the change that the two ``e`` make in ``sqrt(max(1 -
    e, 1e-12))``, times ``|i u|``. ``e`` is not ``a^2``: where ``a`` rounds
    to 1, ``exp(2 log_a)`` can still be one ulp under 1 on one side and
    take the floor on the other."""
    u = _x(2, 12) * 3
    p = dict(params, lam=(params["lam"] - 60.0 * (np.arange(64) % 2)
                          ).astype(np.float32))
    tp, jp = _t(p), _j(p)
    a, g = rglru._gates(CFG, tp, torch.as_tensor(u))
    ja, jg = jrglru._gates(JCFG, jp, jnp.asarray(u))
    assert a.dtype == g.dtype == torch.float32
    assert (a == 1).any()
    close(a, ja)
    c = CFG.rglru.c
    r = torch.sigmoid(rglru._block_linear(torch.as_tensor(u), tp["w_r"],
                                          tp["b_r"]))
    e = torch.exp(2.0 * (-c * softplus(tp["lam"]) * r)).double().numpy()
    jr = jax.nn.sigmoid(jrglru._block_linear(jnp.asarray(u), jp["w_r"],
                                             jp["b_r"]))
    je = np.asarray(jnp.exp(2.0 * (-c * jax.nn.softplus(jp["lam"]) * jr)),
                    np.float64)
    ulp = np.spacing(np.maximum(e, je).astype(np.float32)).astype(np.float64)
    assert (np.abs(e - je) <= np.where(e > 0.5, ulp, 1e-5 * je)).all()
    i = torch.sigmoid(rglru._block_linear(
        torch.as_tensor(u), tp["w_i"], tp["b_i"])).double().numpy()

    def root(x):
        return np.sqrt(np.maximum(1.0 - x, 1e-12))
    allowed = TOL["atol"] + TOL["rtol"] * np.abs(np.asarray(jg)) + \
        np.abs(i * u) * np.abs(root(e) - root(je))
    diff = np.abs(g.double().numpy() - np.asarray(jg, np.float64))
    assert (diff <= allowed).all(), (diff - allowed).max()


@pytest.mark.parametrize("L", [1, 5, 64, 100, 200])
def test_scan_matches_the_associative_scan(L):
    """Chunks of 64: one short chunk, exactly one, a padded second, four."""
    rng = np.random.default_rng(L)
    a = rng.uniform(0.0, 1.0, size=(B, L, 24)).astype(np.float32)
    b = rng.normal(size=(B, L, 24)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]
    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = rglru._scan(torch.as_tensor(a), torch.as_tensor(b))
    close(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("L", [3, 37])
def test_rglru_apply_matches_jax(params, L):
    """Output and cache (the last conv_width - 1 pre-conv inputs, the f32
    state after the last step)."""
    x = _x(4, L)
    y, cache = rglru.rglru_apply(CFG, _t(params), torch.as_tensor(x),
                                 make_cache=True)
    jy, jc = jrglru.rglru_apply(JCFG, _j(params), jnp.asarray(x),
                                make_cache=True)
    close(y, jy)
    assert cache["state"].dtype == torch.float32
    for k in ("conv", "state"):
        assert tuple(cache[k].shape) == jc[k].shape
        close(cache[k], jc[k])
    y0, c0 = rglru.rglru_apply(CFG, _t(params), torch.as_tensor(x))
    assert c0 is None and torch.equal(y0, y)


def test_rglru_decode_after_prefill_matches_jax(params):
    """Prefill 20 steps, then 6 decode steps from the reference's cache
    carried across: each output and the final cache."""
    x = _x(5, 26)
    _, jc = jrglru.rglru_apply(JCFG, _j(params), jnp.asarray(x[:, :20]),
                               make_cache=True)
    cache = {k: torch.as_tensor(np.asarray(v)) for k, v in jc.items()}
    for pos in range(20, 26):
        x1 = x[:, pos:pos + 1]
        y, cache = rglru.rglru_decode(CFG, _t(params), torch.as_tensor(x1),
                                      cache, pos)
        jy, jc = jrglru.rglru_decode(JCFG, _j(params), jnp.asarray(x1), jc,
                                     pos)
        close(y, jy)
    for k in ("conv", "state"):
        close(cache[k], jc[k])


def test_decode_continues_the_prefill(params):
    """The port alone: prefill over L then one step equals prefill over
    L + 1 (output of the last step, and the cache)."""
    x = _x(6, 30)
    tp = _t(params)
    _, cache = rglru.rglru_apply(CFG, tp, torch.as_tensor(x[:, :29]),
                                 make_cache=True)
    y1, c1 = rglru.rglru_decode(CFG, tp, torch.as_tensor(x[:, 29:]), cache,
                                29)
    y, c = rglru.rglru_apply(CFG, tp, torch.as_tensor(x), make_cache=True)
    np.testing.assert_allclose(y1[:, 0].numpy(), y[:, -1].numpy(), **TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(c1[k].numpy(), c[k].numpy(), **TOL)
