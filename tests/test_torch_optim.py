"""The port's loss, schedule, optimizers and buckets against the JAX
package's, on the CPU, on numpy draws from a seed.

Tolerances: ``cross_entropy`` and ``warmup_cosine`` within rtol 1e-6 (f32,
the same operations); one optimizer step per tensor, bucketed and
Adafactor within 1e-6 of each leaf's max (``REL``: f32 elementwise math,
``pow`` and ``sqrt`` may round an ulp apart); bucket contents and their
round trip exact; the router-bias update exact; the three remat policies
exactly the plain gradients (recomputation repeats the same arithmetic).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import buckets as jbk  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup  # noqa: E402
from repro.parallel.sharding import tree_map_schema  # noqa: E402
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.core import buckets as bk  # noqa: E402
from repro_torch.models import common, convert, moe  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.training import state as tstate  # noqa: E402

REL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    top = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - want).max(initial=0.0)) <= rel * top, what


# ---------------------------------------------------------------------------
# loss and schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,vpad,z_loss,dtype", [
    (200, 256, 1e-4, np.float32), (256, 256, 1e-4, np.float32),
    (200, 256, 0.0, np.float32), (1000, 1024, 1e-4, ml_dtypes.bfloat16)])
def test_cross_entropy_matches_jax(vocab, vpad, z_loss, dtype):
    """Padded vocab (-1e9 on the padding), ignored labels (-1, and a row
    with none valid), z-loss, bf16 logits."""
    rng = np.random.default_rng(vpad + vocab)
    logits = (rng.normal(size=(3, 7, vpad)) * 4).astype(dtype)
    labels = rng.integers(0, vocab, (3, 7))
    labels[0, 2:5] = -1
    labels[2, :] = -1 if dtype is np.float32 else labels[2, :]
    got = common.cross_entropy(
        torch.from_numpy(logits.astype(np.float32)).to(
            torch.bfloat16 if dtype is not np.float32 else torch.float32),
        torch.from_numpy(labels), vocab_real=vocab, z_loss=z_loss)
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 vocab_real=vocab, z_loss=z_loss)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_cross_entropy_with_no_valid_label_is_zero():
    got = common.cross_entropy(torch.zeros(2, 3, 8),
                               torch.full((2, 3), -1), vocab_real=8)
    assert got.item() == 0.0


def test_warmup_cosine_matches_jax():
    for step in [0, 1, 5, 99, 100, 101, 150, 199, 200, 250]:
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32),
                            base_lr=3e-4, warmup=100, total=200)
        want = jwarmup(jnp.int32(step), base_lr=3e-4, warmup=100, total=200)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

# stacked [n, ...] leaves as the reference's scan groups give them, a 1-D
# norm scale stacked to [n, d] (factored by Adafactor), a 1-D bias and a
# 4-D stacked attention weight
SHAPES = {"a/w": (3, 16, 8), "a/scale": (3, 16), "b": (16,),
          "c/w_q": (2, 16, 4, 8), "d": (40, 24)}


def _draws(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}


def _jtree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("kind", ["adamw", "sgdm", "adafactor"])
@pytest.mark.parametrize("step", [0, 7])
def test_per_tensor_step_matches_jax(kind, step):
    """One ``opt_update`` + ``apply_updates`` from non-zero moments on the
    same gradients: updates, new states and new parameters."""
    p, g = _draws(1), _draws(2)
    p = {k: v * 0.1 for k, v in p.items()}
    name = kind
    jst = jopt.opt_init(name, _jtree(p))
    # non-zero moments from a first update
    _, jst = jopt.opt_update(kind, jst, _jtree(_draws(3)), _jtree(p),
                             lr=1e-3, wd=0.1, step=jnp.int32(step))
    st = jax.tree.map(lambda a: _t(a), jst)
    lr = warmup_cosine(torch.tensor(step + 1, dtype=torch.int32),
                       base_lr=1e-3, warmup=2, total=10)
    jlr = jwarmup(jnp.int32(step + 1), base_lr=1e-3, warmup=2, total=10)
    upd, new = opt.opt_update(kind, st, {k: _t(v) for k, v in g.items()},
                              {k: _t(v) for k, v in p.items()}, lr=lr,
                              wd=0.1, step=torch.tensor(step + 1,
                                                        dtype=torch.int32))
    jupd, jnew = jopt.opt_update(kind, jst, _jtree(g), _jtree(p), lr=jlr,
                                 wd=0.1, step=jnp.int32(step + 1))
    for k in p:
        close(upd[k].numpy(), np.asarray(jupd[k]), what=k)
    flat = jax.tree_util.tree_flatten_with_path(jnew)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(new)[0])
    for path, leaf in flat:
        close(got[path].numpy(), np.asarray(leaf), what=str(path))
    if kind == "adafactor":           # stacked 1-D leaves are factored
        assert set(new["per"]["a/scale"]) == {"vr", "vc"}
        assert set(new["per"]["b"]) == {"v"}
    newp = opt.apply_updates({k: _t(v) for k, v in p.items()}, upd)
    jnewp = jopt.apply_updates(_jtree(p), jupd)
    for k in p:
        close(newp[k].numpy(), np.asarray(jnewp[k]), what=k)


@pytest.mark.parametrize("kind", ["adamw_b", "sgdm_b"])
@pytest.mark.parametrize("bucket_bytes,pad", [(1 << 28, 1), (3000, 8)])
def test_bucketed_step_matches_jax(kind, bucket_bytes, pad):
    """The bucketed optimizers over a plan of several buckets, with and
    without padding, inplace and not: update buckets, moments, new
    parameters (bf16 parameters: the update is cast to their dtype first,
    as the reference's ``unflatten`` does)."""
    p = {k: (v * 0.1).astype(ml_dtypes.bfloat16) for k, v in
         _draws(4).items()}
    g = _draws(5)
    jp = _jtree(p)
    base = kind[:-2]
    jst = jopt.opt_init(base, jp, bucketed=True, bucket_bytes=bucket_bytes,
                        pad_multiple=pad)
    jplan = jbk.make_plan(jp, bucket_bytes, pad)
    _, jst = jopt.opt_update(kind, jst, _jtree(_draws(6)), jp, lr=1e-3,
                             wd=0.1, step=jnp.int32(2), plan=jplan)
    keys = sorted(p)                        # the reference's leaf order
    tp = [convert._to_torch(p[k]) for k in keys]
    tg = [_t(g[k]) for k in keys]
    plan = bk.make_plan(tp, bucket_bytes, pad)
    assert plan.bucket_sizes == jplan.bucket_sizes and \
        plan.assign == jplan.assign
    for inplace in (False, True):
        st = jax.tree.map(lambda a: _t(a), jst)
        upd, new = opt.opt_update(kind, st, tg, tp, lr=5e-4, wd=0.1,
                                  step=torch.tensor(3, dtype=torch.int32),
                                  plan=plan, inplace=inplace)
        jupd, jnew = jopt.opt_update(kind, jst, _jtree(g), jp, lr=5e-4,
                                     wd=0.1, step=jnp.int32(3), plan=jplan)
        for a, b in zip(upd, jupd, strict=True):
            close(a.numpy(), np.asarray(b))
        for mk in jnew:
            for a, b in zip(new[mk], jnew[mk], strict=True):
                close(a.numpy(), np.asarray(b))
        newp = opt.apply_updates(tp, upd, plan=plan)
        jnewp = jopt.apply_updates(jp, jupd, plan=jplan)
        for k, t in zip(keys, newp):
            assert t.dtype == torch.bfloat16
            close(t.float().numpy(), np.asarray(jnewp[k], np.float32),
                  rel=1e-2, what=k)          # one bf16 ulp where f32 ties


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket_bytes,pad", [(1 << 28, 1), (1 << 14, 4),
                                              (5000, 16)])
def test_bucket_plan_round_trip(bucket_bytes, pad):
    rng = np.random.default_rng(bucket_bytes)
    ts = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dt)
          for s, dt in [((7, 5), torch.float32), ((300,), torch.bfloat16),
                        ((3, 4, 5), torch.float32), ((1,), torch.float32),
                        ((2000,), torch.bfloat16)]]
    plan = bk.make_plan([ts[0], (ts[1], ts[2]), ts[3], ts[4]], bucket_bytes,
                        pad)
    buckets = bk.flatten(plan, ts)
    assert [b.numel() for b in buckets] == list(plan.bucket_sizes)
    assert all(b.numel() % pad == 0 and b.dtype == torch.float32
               for b in buckets)
    back = bk.unflatten(plan, buckets)
    for a, b in zip(ts, back, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a run of tensors counts as one leaf: (ts[1], ts[2]) share a bucket
    assert plan.assign[1][0] == plan.assign[2][0]


def _tree(jcfg, seed, dtype):
    """The reference's parameter tree shapes, numpy normal draws."""
    rng = np.random.default_rng(seed)
    return tree_map_schema(lambda path, pd: rng.normal(
        size=pd.shape).astype(dtype), jmdl.model_schema(jcfg)[0])


@pytest.mark.parametrize("name,bucket_bytes", [
    ("tinyllama-1.1b", 1 << 28), ("tinyllama-1.1b", 20_000),
    ("deepseek-v3-671b", 20_000), ("recurrentgemma-2b", 20_000)])
def test_bucket_contents_equal_jax_flatten(name, bucket_bytes):
    """The port's plan over its per-layer parameters, grouped as the
    reference's leaves (``reference_groups``), gives the reference's bucket
    sizes and assignments, and every bucket equal, element for element,
    to ``repro.core.buckets.flatten`` of the reference's stacked tree (bf16
    parameters, several buckets at 20 kB)."""
    cfg, jcfg = get_arch(name).reduced(), jax_get_arch(name).reduced()
    tree = _tree(jcfg, 3, ml_dtypes.bfloat16)
    lm = convert.params_from_numpy(tree, cfg, device="cpu")
    groups = [ts for _, ts in tstate.reference_groups(cfg, lm)]
    plan = bk.make_plan(groups, bucket_bytes, 4)
    jplan = jbk.make_plan(tree, bucket_bytes, 4)
    assert plan.bucket_sizes == jplan.bucket_sizes
    assert len(plan.bucket_sizes) > (1 if bucket_bytes < 1 << 20 else 0)
    got = bk.flatten(plan, [t for ts in groups for t in ts])
    want = jbk.flatten(jplan, jax.tree.map(jnp.asarray, tree))
    for a, b in zip(got, want, strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    tplan = tstate.make_bucket_plan(cfg, RunConfig(bucket_bytes=bucket_bytes),
                                    lm=lm)
    if cfg.optimizer == "adafactor":     # deepseek-v3: per-tensor states
        assert tplan is None
    else:
        assert tplan == bk.make_plan(groups, bucket_bytes, 1)


def test_stacked_params_are_the_reference_leaves():
    cfg, jcfg = get_arch("deepseek-v3-671b").reduced(), \
        jax_get_arch("deepseek-v3-671b").reduced()
    tree = _tree(jcfg, 4, np.float32)
    lm = convert.params_from_numpy(tree, cfg, device="cpu")
    got = tstate.stacked_params(cfg, lm)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(p.key for p in path)
        assert np.array_equal(got[key].numpy(), leaf), key


# ---------------------------------------------------------------------------
# the router-bias update and remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [0, 4])
def test_update_router_bias_matches_jax(pad):
    import dataclasses
    m = dataclasses.replace(get_arch("deepseek-v3-671b").reduced().moe,
                            n_expert_pad=pad)
    rng = np.random.default_rng(pad)
    bias = rng.normal(size=m.n_experts_padded).astype(np.float32) * 1e-3
    load = rng.integers(0, 20, m.n_experts_padded).astype(np.float32)
    load[-pad or None:] = 0 if pad else load[-pad or None:]
    load[0] = load.sum() / m.n_experts             # sign 0: no move
    got = moe.update_router_bias(m, _t(bias), _t(load))
    want = jmoe.update_router_bias(m, jnp.asarray(bias), jnp.asarray(load))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    if pad:
        assert np.array_equal(got.numpy()[-pad:], bias[-pad:])


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "granite-moe-3b-a800m",
                                  "recurrentgemma-2b"])
def test_remat_policies_give_the_plain_gradients(name):
    """``remat`` "full" and "dots" recompute what "none" keeps: the same
    loss and bitwise the same gradients."""
    cfg = get_arch(name).reduced()
    lm = mdl.init(cfg, 0, device="cpu", dtype=torch.float32).trainable(True)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)))}
    out = {}
    for policy in ("none", "full", "dots"):
        loss, _ = mdl.loss_fn(cfg, RunConfig(remat=policy), lm, batch)
        out[policy] = (loss.item(), torch.autograd.grad(
            loss, list(lm.parameters())))
    for policy in ("full", "dots"):
        assert out[policy][0] == out["none"][0]
        for a, b in zip(out[policy][1], out["none"][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("start,r,m,k", [(0, 4, 3, 12), (5, 4, 3, 6),
                                         (9, 4, 3, 7), (13, 4, 3, 3),
                                         (2, 1, 8, 5), (0, 7, 1, 9)])
def test_row_groups_is_index_add(start, r, m, k):
    """``_row_groups`` (the FSDP Adafactor's per-group sums of its row
    shard, in a fixed order) equals ``index_add_`` into the groups
    ``clamp((start + j) // r, max=m - 1)``, for a shard that starts inside
    a group, ends past the last one, or lies wholly past it."""
    x = torch.randn(2, k, 3, generator=torch.Generator().manual_seed(k))
    a = torch.clamp((start + torch.arange(k)) // r, max=m - 1)
    for t in (x, x[..., 0]):
        want = t.new_zeros(2, m, *t.shape[2:]).index_add_(1, a, t)
        torch.testing.assert_close(opt._row_groups(t, start, r, m), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device: the order of the card's atomic adds")
def test_row_groups_repeats_bit_for_bit_on_the_card():
    """On the card ``_row_groups`` gives the same bits every call (many
    rows to a group, where ``index_add_``'s atomics may not)."""
    x = torch.randn(4, 4096, 64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    first = opt._row_groups(x, 100, 512, 8)
    for _ in range(4):
        assert torch.equal(opt._row_groups(x, 100, 512, 8), first)
