"""The port's mixture of experts (``repro_torch/models/moe.py``) against the
JAX package's ``models/moe.py``, on the CPU, at ``get_arch(name).reduced()``
widths (d_model 64, 8 experts top-2, expert d_ff 32; deepseek-v3 with its
shared expert and sigmoid+bias router, granite-moe with softmax top-k),
with two padded experts added (``n_expert_pad = 2``) so the padding mask
is exercised.

Parameters are the JAX package's f32 init (``init_params(...,
dtype_override="float32")``), the router bias a seeded numpy draw; inputs
are numpy draws from a seed. The JAX side runs under the conftest's 1 x 1
mesh (``use_mesh(cpu_mesh)``), which ``moe_apply`` needs.

Tolerance (f32): 1e-5 relative and absolute on gates, probabilities, the
output and ``aux_loss``; expert ids and ``load`` exactly. Both sides do the
same f32 arithmetic in another order of sums. bf16: the families' 0.07 of
max |y| (``test_torch_families.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.parallel.sharding import use_mesh  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import convert, moe  # noqa: E402
from test_torch_cases import salted_init  # noqa: E402
from test_moe import dense_oracle  # noqa: E402

NAMES = ["granite-moe-3b-a800m", "deepseek-v3-671b"]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 0.07


def configs(name, **moe_kw):
    """(port config, JAX config) at reduced widths, two padded experts,
    ``moe_kw`` replacing MoE fields on both."""
    out = []
    for get in (get_arch, jax_get_arch):
        cfg = get(name).reduced()
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_expert_pad=2, **moe_kw)))
    return out


def params(jcfg, seed=0):
    """The JAX package's f32 MoE parameters and a drawn router bias, as
    numpy."""
    p = salted_init(jsharding, jmoe.moe_schema(jcfg),
                    jax.random.PRNGKey(seed), dtype_override="float32")
    bias = np.random.default_rng(seed).normal(
        size=jcfg.moe.n_experts_padded).astype(np.float32) * 0.1
    return jax.tree.map(np.asarray, p), bias


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _x(shape, seed=1, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(kw or TOL))


def plain_keep(ids, C_send, C_exp):
    """The reference's capacity rule, one assignment at a time in
    token-major order: the first C_send are sent, and an expert takes its
    first C_exp of those."""
    taken, keep = {}, []
    for a, e in enumerate(np.asarray(ids).reshape(-1)):
        ok = a < C_send and taken.get(e, 0) < C_exp
        taken[e] = taken.get(e, 0) + (a < C_send)
        keep.append(ok)
    return np.array(keep).reshape(np.asarray(ids).shape)


# ---------------------------------------------------------------------------
# schema, capacity, routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_schema_reads_as_the_reference(name):
    cfg, jcfg = configs(name)
    fields = ("shape", "dims", "init", "scale", "dtype")

    def flat(schema):
        return {jax.tree_util.keystr(k): tuple(getattr(v, f) for f in fields)
                for k, v in jax.tree_util.tree_flatten_with_path(
                    schema, is_leaf=lambda x: hasattr(x, "dims"))[0]}
    assert flat(moe.moe_schema(cfg)) == flat(jmoe.moe_schema(jcfg))
    assert flat(moe.moe_bias_def(cfg)) == flat(jmoe.moe_bias_def(jcfg))
    assert moe.moe_schema(cfg)["router"].dtype == "float32"
    assert ("shared" in moe.moe_schema(cfg)) == (name == "deepseek-v3-671b")


@pytest.mark.parametrize("name, T, want", [
    ("granite-moe-3b-a800m", 8192, (4096, 40960, 1072)),   # prefill 4 x 2048
    ("granite-moe-3b-a800m", 4, (4, 40, 8)),               # decode, 4 slots
    ("deepseek-v3-671b", 4096, (2048, 20480, 104)),        # prefill 2 x 2048
    ("deepseek-v3-671b", 2, (2, 24, 8)),                   # decode, 2 slots
])
def test_capacity_at_published_widths(name, T, want):
    """(tokens a chunk, C_send, C_exp) at the full configs' chunk sizes."""
    assert moe._capacity(get_arch(name).moe, T) == want


@pytest.mark.parametrize("router", ["softmax_topk", "sigmoid_bias"])
def test_route_matches_jax(router):
    cfg, jcfg = configs("deepseek-v3-671b", router=router, top_k=3)
    m = cfg.moe
    logits = _x((40, m.n_experts_padded), seed=2, scale=2.0)
    bias = np.random.default_rng(3).normal(size=m.n_experts_padded).astype(
        np.float32)
    g, ids, probs = moe.route(m, torch.as_tensor(logits),
                              torch.as_tensor(bias))
    jg, jids, jprobs = jmoe.route(jcfg.moe, jnp.asarray(logits),
                                  jnp.asarray(bias))
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert int(ids.max()) < m.n_experts          # padding never selected
    close(g, jg)
    close(probs, jprobs)
    if router == "sigmoid_bias":                 # the bias moved a choice
        _, unbiased, _ = moe.route(m, torch.as_tensor(logits),
                                   torch.zeros(m.n_experts_padded))
        assert not torch.equal(unbiased, ids)
        close(g.sum(-1), np.full(40, m.routed_scaling))


def test_top_k_breaks_ties_to_the_lower_index():
    """Zero-padded tokens route on all-equal logits: both frameworks pick
    the lowest expert indices."""
    cfg, jcfg = configs("granite-moe-3b-a800m")
    zeros = np.zeros((3, cfg.moe.n_experts_padded), np.float32)
    _, ids, _ = moe.route(cfg.moe, torch.as_tensor(zeros), None)
    _, jids, _ = jmoe.route(jcfg.moe, jnp.asarray(zeros), None)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert ids.tolist() == [[0, 1]] * 3


@pytest.mark.parametrize("cf", [0.05, 0.5, 1.25, 8.0])
def test_dispatch_equals_the_plain_capacity_rule(cf):
    """Keep and slots against the rule applied one assignment at a time:
    every kept assignment has its own row, in its expert's block, in
    token-major order."""
    cfg, _ = configs("granite-moe-3b-a800m", capacity_factor=cf)
    m = cfg.moe
    ids = torch.as_tensor(np.random.default_rng(4).integers(
        0, m.n_experts, (64, m.top_k)))
    _, C_send, C_exp = moe._capacity(m, 64)
    keep, slot = moe._dispatch(ids, C_send, C_exp, m.n_experts_padded)
    assert np.array_equal(keep.numpy(), plain_keep(ids, C_send, C_exp)
                          .reshape(-1))
    kept = slot[keep]
    assert len(set(kept.tolist())) == int(keep.sum())
    assert torch.equal(kept // C_exp, ids.reshape(-1)[keep])
    assert (slot[~keep] == m.n_experts_padded * C_exp).all()
    if cf < 1:
        assert not keep.all()


# ---------------------------------------------------------------------------
# moe_apply against the reference
# ---------------------------------------------------------------------------

# (case, capacity factor, x shape): generous capacity (nothing drops), the
# reference's 1.25, 0.05 (drops: they must be the same), a token count not
# a multiple of the chunk (64 at reduced widths: 150 = 64 + 64 + 22, the
# last chunk zero-padded), a decode step
CASES = [("generous", 8.0, (2, 16)), ("reference", 1.25, (2, 40)),
         ("drops", 0.05, (2, 16)), ("ragged", 1.25, (3, 50)),
         ("decode", 1.25, (4, 1))]


@pytest.mark.parametrize("case, cf, shape", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_matches_jax(cpu_mesh, name, case, cf, shape):
    """y, ``load`` and ``aux_loss``; deepseek adds its shared expert."""
    cfg, jcfg = configs(name, capacity_factor=cf)
    p, bias = params(jcfg)
    x = _x(shape + (cfg.d_model,))
    y, aux = moe.moe_apply(cfg, _t(p), torch.as_tensor(x),
                           torch.as_tensor(bias))
    with use_mesh(cpu_mesh):
        jy, jaux = jmoe.moe_apply(jcfg, _j(p), jnp.asarray(x),
                                  jnp.asarray(bias))
    assert y.shape == x.shape and y.dtype == torch.float32
    close(y, jy)
    assert np.array_equal(aux["load"].numpy(), np.asarray(jaux["load"]))
    close(aux["aux_loss"], jaux["aux_loss"])
    T = shape[0] * shape[1]
    n = min(cfg.moe.chunk_tokens, T)
    assert int(aux["load"].sum()) == -(-T // n) * n * cfg.moe.top_k
    _, _, _, keep = moe._moe_body(cfg, _t(p), torch.as_tensor(x).reshape(
        T, -1), torch.as_tensor(bias))
    if case in ("generous", "drops"):
        assert bool(keep[:T].all()) == (case == "generous")
    if case == "generous":
        with use_mesh(cpu_mesh):
            close(y, dense_oracle(jcfg, _j(p), jnp.asarray(x),
                                  jnp.asarray(bias)))


@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_bf16_matches_jax(cpu_mesh, name):
    """bf16 experts (the router and bias f32, as the schema has them) to
    the families' 0.07 of max |y|: the same dtypes on both sides."""
    cfg, jcfg = configs(name)
    p, bias = params(jcfg)
    dts = jax.tree.map(lambda pd: pd.dtype, jmoe.moe_schema(jcfg),
                       is_leaf=lambda x: hasattr(x, "dims"))
    p16 = jax.tree.map(lambda a, dt: jnp.asarray(a).astype(dt), p, dts)
    x = jnp.asarray(_x((2, 40, cfg.d_model))).astype(jnp.bfloat16)
    y, aux = moe.moe_apply(cfg, jax.tree.map(convert._to_torch, p16),
                           convert._to_torch(x), torch.as_tensor(bias))
    with use_mesh(cpu_mesh):
        jy, jaux = jmoe.moe_apply(jcfg, p16, x, jnp.asarray(bias))
    assert str(y.dtype).split(".")[-1] == str(jy.dtype) == "bfloat16"
    got, want = y.float().numpy(), np.asarray(jy, np.float32)
    assert np.max(np.abs(got - want)) <= BF16_REL * np.max(np.abs(want))
    assert np.array_equal(aux["load"].numpy(), np.asarray(jaux["load"]))


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def test_moe_module_holds_its_bias_as_a_buffer():
    cfg, jcfg = configs("deepseek-v3-671b")
    p, bias = params(jcfg)
    mod = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    assert "bias" not in dict(mod.named_parameters())
    assert mod["router"].dtype == torch.float32
    assert mod.bias.dtype == torch.float32 and not mod.bias.any()
    sd = {".".join(str(q.key) for q in path): torch.as_tensor(leaf)
          for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]}
    mod.load_state_dict({**sd, "bias": torch.as_tensor(bias)}, strict=True)
    assert torch.equal(mod["bias"], torch.as_tensor(bias))
    x = torch.as_tensor(_x((2, 16, cfg.d_model)))
    y, _ = mod(x)
    assert torch.equal(y, moe.moe_apply(cfg, _t(p), x,
                                        torch.as_tensor(bias))[0])


def test_moe_module_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = configs("granite-moe-3b-a800m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        moe.MoE(cfg)
