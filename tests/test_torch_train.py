"""The port's training path against the JAX package's, on the CPU: the
loss and its gradients, the train step (bucketed AdamW, per-tensor AdamW,
Adafactor on deepseek-v3, micro-batches, the error-feedback compressed
sync), the data-parallel sync over 4 gloo ranks, and ``train()`` with
checkpoints, resume and failure injection.

Both sides compute from one f32 parameter tree (``test_torch_families.
make_fam``: the reference's init with every constant-initialised leaf moved
by a seeded draw) and one numpy token draw; the reference runs under the
conftest's 1 x 1 mesh. A train state crosses whole
(``convert.state_from_numpy``).

Tolerances (f32, both sides the same arithmetic in another order of sums):
the loss and metrics within rtol 1e-5 (``LOSS_TOL``), every gradient
within 2e-5 of its leaf's max |g| (``GRAD_REL``; deepseek-v3 5e-4, derived
below); after two steps every parameter within 2e-5 of
its leaf's max |p| (but a thousandth of its elements, by at most twice
the learning rate: an Adam-class update divides by sqrt(v), which turns
the rounding of a gradient element that is the small difference of large
terms into a move of up to the learning rate) and every moment within
1e-4 of its max (``STEP_REL``; deepseek-v3 2e-4). Adafactor's and
the router biases' states as the parameters. With int8-compressed
gradients a rounding difference can move one code of a block by a step
(the block's max/127), so there at most a thousandth of the elements may
pass those bounds, and none 2e-2 of its leaf's max (``FLIP_REL``).

deepseek-v3's gradient bound. Its reduced MoE outputs run near 2,200
against an embedding near 0.5, so the gradients that cross the residual
stream lose f32 digits. Each framework was held to its own run on the
same weights in f64 (the port with every ``float()`` cast made f64) over
eight draws of the weights (``make_fam``'s hash salts 0-7): the worst
leaf of the port's f32 gradients is 3.2e-5 to 2.77e-4 of its max |g| from
f64 (draw 7, ``w_uq``), the reference's 1.7e-5 to 2.17e-4 (draw 3,
``embed.tok``, where both frameworks pass 2e-4 of f64). The two errors are
independent, so their difference can reach the sum of the worst,
4.9e-4: ``GRAD_REL`` is 5e-4. The draws differ by 2.0e-5 to 2.83e-4
between the frameworks; draw 4 (2.03e-4, ``kv_norm``), which failed the
former 2e-4 under ``PYTHONHASHSEED=4``, is a case of its own
(``deepseek-v3-671b@4``). The weights no longer depend on the process's
hash salt (``make_fam``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.parallel.sharding import make_rules as jmake_rules  # noqa: E402
from repro.parallel.sharding import use_mesh  # noqa: E402
from repro.training import state as jstate  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training import state as tstate  # noqa: E402
from test_torch_families import NAMES, batches, make_fam  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = {"deepseek-v3-671b": 5e-4}
STEP_REL = {"deepseek-v3-671b": 2e-4}
FLIP_REL = 2e-2
B, S = 4, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def close_rel(got, want, rel, what="", flips=False, loose=FLIP_REL):
    """max |got - want| <= rel * max(max |want|, 1e-30). With ``flips``
    (int8-compressed gradients, where a rounding difference can move a
    code by one step of its block's max/127), at most a thousandth of the
    elements may exceed that bound, and none ``loose`` of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
    diff = np.abs(got - want)
    if flips:
        assert np.mean(diff > rel * top) <= 1e-3, (what, np.mean(
            diff > rel * top))
        rel = loose
    err = float(np.max(diff, initial=0.0))
    assert err <= rel * top, (what, err, top)


def by_name(tree, cfg) -> dict:
    """A tree shaped as the reference's parameters -> {name: numpy}."""
    return {k: v.numpy() for k, v in
            convert.tensors_by_name(_np(tree), cfg, "cpu").items()}


def tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


# ---------------------------------------------------------------------------
# the leaf order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES + ["tinyllama-1.1b"])
def test_reference_leaves_follow_the_jax_flatten_order(name):
    """``reference_leaves`` lists the reference's parameter leaves in
    ``jax.tree.flatten``'s order, each naming the port's parameters whose
    shapes stack to the leaf's (full widths, schema only)."""
    cfg = get_arch(name)
    schema, _ = jmdl.model_schema(cfg)
    flat = jax.tree_util.tree_flatten_with_path(
        schema, is_leaf=lambda x: hasattr(x, "dims"))[0]
    leaves = mdl.reference_leaves(cfg)
    assert [lf.key for lf in leaves] == \
        ["/".join(p.key for p in path) for path, _ in flat]
    shapes = {k: tuple(v.shape) for k, v in
              mdl.LM(cfg, device="meta").named_parameters()}
    for lf, (_, pd) in zip(leaves, flat):
        got = tuple(shapes[n] for n in lf.names)
        if lf.stacked:
            assert got == (tuple(pd.shape[1:]),) * pd.shape[0], lf.key
        else:
            assert got == (tuple(pd.shape),), lf.key
    assert sorted(n for lf in leaves for n in lf.names) == sorted(shapes)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

LOSS_ARCHS = ["tinyllama-1.1b", "internvl2-2b", "musicgen-medium",
              "granite-moe-3b-a800m", "deepseek-v3-671b",
              "recurrentgemma-2b", "mamba2-1.3b", "deepseek-v3-671b@4"]


@pytest.mark.parametrize("name", LOSS_ARCHS)
def test_loss_and_grads_match_jax(name, cpu_mesh):
    """``loss_fn`` (next-token CE with the prefix-label mask, the MoE aux
    losses, the MTP loss), its metrics, every layer's expert load, and the
    gradient of every parameter against ``jax.value_and_grad`` of the
    reference's ``loss_fn``. ``name@salt``: the weights of
    ``test_torch_families.make_fam``'s hash salt ``salt``."""
    fam = make_fam(name)
    name = fam.name
    cfg, jcfg, lm = fam.cfg, fam.jcfg, fam.lm.trainable(True)
    batch, jbatch = batches(cfg, tokens(cfg, 3), 3)
    rc, jrc = RunConfig(), JRunConfig()
    loss, (mets, aux) = mdl.loss_fn(cfg, rc, lm, batch)
    named = dict(lm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    with use_mesh(cpu_mesh, jmake_rules(cpu_mesh)):
        (jloss, (jmets, jaux)), jg = jax.jit(jax.value_and_grad(
            lambda p: jmdl.loss_fn(jcfg, jrc, p, fam.jb, jbatch),
            has_aux=True))(_jax(fam.tree))
    assert set(mets) == set(jmets)
    want_keys = {"ce_loss", "loss"} | ({"moe_aux_loss"} if cfg.moe else
                                       set()) | ({"mtp_loss"} if cfg.mtp
                                                 else set())
    assert set(mets) == want_keys
    for k in mets:
        np.testing.assert_allclose(mets[k].item(), float(jmets[k]),
                                   err_msg=k, **LOSS_TOL)
    loads = [a["load"].numpy() for a in aux if a]
    want_loads = [a["load"] for a in convert._unstack(_np(jaux), cfg) if a]
    assert len(loads) == len(want_loads)
    for got, want in zip(loads, want_loads):
        assert np.array_equal(got, want)
    want = by_name(jg, cfg)
    assert set(want) == set(grads)
    rel = GRAD_REL.get(name, 2e-5)
    for k, g in grads.items():
        close_rel(g.numpy(), want[k], rel, k)


def test_prefix_positions_carry_no_label():
    """internvl2: moving a token inside the prefix leaves the loss as it
    was (its label is masked, and the prefix embeddings replace its
    embedding)."""
    fam = make_fam("internvl2-2b")
    cfg = fam.cfg
    toks = tokens(cfg, 4)
    batch, _ = batches(cfg, toks, 4)
    moved = toks.copy()
    moved[:, 1] = (moved[:, 1] + 1) % cfg.vocab
    batch2, _ = batches(cfg, moved, 4)
    with torch.no_grad():
        a = mdl.loss_fn(cfg, RunConfig(), fam.lm, batch)[0]
        b = mdl.loss_fn(cfg, RunConfig(), fam.lm, batch2)[0]
    assert a.item() == b.item()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def jax_state(jcfg, jrc, fam, mesh):
    """The reference's train state for ``fam``'s tree (f32 params)."""
    with use_mesh(mesh, jmake_rules(mesh, pod_param_mode=jrc.pod_param_mode)):
        st = jstate.init_state(jcfg, jrc, jax.random.PRNGKey(0), mesh)
    st["params"] = _jax(fam.tree)
    if st["biases"]:
        st["biases"] = fam.jb
    return st


def assert_states_close(got: dict, want: dict, cfg, rel: float, lr: float,
                        flips: bool = False):
    """The port's state against the reference's (numpy), leaf by leaf
    (``close_rel``; moments and residuals at 5 ``rel``). An Adam-class
    update divides by sqrt(v): where a gradient element is the small
    difference of large terms, its rounding moves that parameter by up to
    the learning rate ``lr``, so a thousandth of a leaf's elements may
    pass ``rel``, by at most 2 ``lr``."""
    lm = got["params"]
    wp = by_name(want["params"], cfg)
    for n, p in lm.named_parameters():
        top = max(float(np.abs(wp[n]).max()), 1e-30)
        close_rel(p.detach().numpy(), wp[n], rel, n, True,
                  loose=max(FLIP_REL if flips else 0.0, 2 * lr / top))
    wb = convert._unstack(want["biases"], cfg)
    for n, b in got["biases"].items():
        close_rel(b.numpy(), wb[int(n.split(".")[1])], rel, n)
    assert int(got["step"]) == int(want["step"])
    o, wo = got["opt"], want["opt"]
    if "per" in wo:
        per = convert._by_key(wo["per"], is_leaf=lambda d: "vr" in d or
                              "v" in d)
        assert set(per) == set(o["per"])
        for k, s in per.items():
            for n, a in s.items():
                close_rel(o["per"][k][n].numpy(), a, rel, f"{k}/{n}")
    else:
        for mk in wo:
            if isinstance(wo[mk], list):
                for i, (g, w) in enumerate(zip(o[mk], wo[mk], strict=True)):
                    close_rel(g.numpy(), w, 5 * rel, f"{mk}/{i}", flips)
            else:
                wn = by_name(wo[mk], cfg)
                for n, t in o[mk].items():
                    close_rel(t.numpy(), wn[n], 5 * rel, f"{mk}/{n}",
                              flips)
    if "ef" in want:
        for i, (g, w) in enumerate(zip(got["ef"], want["ef"], strict=True)):
            # a residual is the small difference of two gradient-sized
            # numbers: it carries their roundings (rel of max |g|, about
            # 100 rel of max |ef|); a flipped code moves it by one step,
            # from about +step/2 to -step/2
            close_rel(g.numpy(), w, 100 * rel, f"ef/{i}", flips,
                      loose=2.05 * max(1.0, float(g.abs().max())
                                       / max(float(np.abs(w).max()),
                                             1e-30)))


STEP_CASES = {
    "adamw_b": ("tinyllama-1.1b", {}),
    "adamw_b_microbatch": ("tinyllama-1.1b", {"microbatch": 2}),
    "adamw_per_tensor": ("granite-moe-3b-a800m",
                         {"bucketed_updates": False, "remat": "dots"}),
    "adafactor": ("deepseek-v3-671b", {}),
    "compressed_sync": ("tinyllama-1.1b", {"pod_param_mode": "replicated",
                                           "compress_grads": True}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case, cpu_mesh):
    """Two ``make_train_step`` steps from one state against the
    reference's jitted step on the conftest's mesh: the metrics of each
    step, then every parameter, router bias, moment (bucketed: bucket by
    bucket, element for element in the reference's order) and residual.
    ``adamw_per_tensor`` also runs ``remat="dots"`` on granite's MoE,
    ``adafactor`` deepseek-v3's stacked factored states and router-bias
    update, ``compressed_sync`` the explicit replicated path's
    ``ef_compress`` of every bucket (one rank: no collective)."""
    name, kw = STEP_CASES[case]
    fam = make_fam(name)
    cfg, jcfg = fam.cfg, fam.jcfg
    common = dict(steps=10, warmup_steps=2, learning_rate=1e-3, **kw)
    rc, jrc = RunConfig(**common), JRunConfig(**common)
    jfn, _, _, rules = jstep.make_train_step(jcfg, jrc, cpu_mesh)
    jst = jax_state(jcfg, jrc, fam, cpu_mesh)
    state = convert.state_from_numpy(_np(jst), cfg, device="cpu")
    fn = make_train_step(cfg, rc)
    for i in range(2):
        batch, jbatch = batches(cfg, tokens(cfg, 10 + i), 10 + i)
        state, mets = fn(state, batch)
        with use_mesh(cpu_mesh, rules):
            jst, jmets = jfn(jst, jbatch)
        assert set(mets) == set(jmets)
        for k in mets:
            np.testing.assert_allclose(mets[k].item(), float(jmets[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert_states_close(state, _np(jst), cfg, STEP_REL.get(name, 2e-5),
                        rc.learning_rate, flips=rc.compress_grads)


@pytest.mark.parametrize("name,kw", [
    ("tinyllama-1.1b", {}), ("deepseek-v3-671b", {}),
    ("granite-moe-3b-a800m", {"bucketed_updates": False,
                              "compress_grads": True,
                              "pod_param_mode": "replicated"})])
def test_abstract_state_matches_jax(name, kw, cpu_mesh):
    """Full widths on the ``meta`` device: the optimizer's buckets (or
    per-tensor moments, or Adafactor's stacked factored states), the
    residuals and the step have the reference's ``abstract_state``
    shapes and dtypes."""
    cfg = get_arch(name)
    jabs = jstate.abstract_state(cfg, JRunConfig(**kw), cpu_mesh,
                                 jmake_rules(cpu_mesh))
    st = tstate.abstract_state(cfg, RunConfig(**kw))
    assert all(p.is_meta for p in st["params"].parameters())

    def shapes(tree, port):
        if port:
            return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in convert._by_key(tree).items()} \
                if isinstance(tree, dict) else \
                [(tuple(v.shape), str(v.dtype).split(".")[-1]) for v in tree]
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): (tuple(a.shape), str(a.dtype))
                for path, a in flat}
    jo = jabs["opt"]
    if "per" in jo:
        assert shapes(st["opt"]["per"], True) == shapes(jo["per"], False)
    elif isinstance(jo["m"], list):
        for k in jo:
            assert shapes(st["opt"][k], True) == \
                [(a.shape, str(a.dtype)) for a in jo[k]]
    else:
        for k in jo:
            want = {n: (tuple(a.shape), "float32") for n, a in
                    st["params"].named_parameters()}
            assert shapes(st["opt"][k], True) == want
            assert sum(math.prod(v[0]) for v in want.values()) == \
                sum(a.size for a in jax.tree.leaves(jo[k]))
    if "ef" in jabs:
        assert set(shapes(st["ef"], True)) == set(
            n for n, _ in st["params"].named_parameters())
    assert tuple(st["step"].shape) == () and st["step"].dtype == torch.int32


def test_donate_state_false_leaves_the_old_state():
    """Without ``donate_state`` the step returns new tensors (a new LM)
    and its argument keeps its values; with it the state is updated in
    place. Both give the same numbers."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    batch = {"tokens": tokens(cfg, 1)}
    out = {}
    for donate in (False, True):
        rc = RunConfig(donate_state=donate, warmup_steps=0, steps=4)
        st = tstate.init_state(cfg, rc, 0, device="cpu", dtype=torch.float32)
        before = {n: p.detach().clone()
                  for n, p in st["params"].named_parameters()}
        new, _ = make_train_step(cfg, rc)(st, batch)
        same = all(torch.equal(p, before[n])
                   for n, p in st["params"].named_parameters())
        assert same != donate
        assert (new is st) == donate and (new["params"] is st["params"]) \
            == donate
        out[donate] = {n: p.detach() for n, p in
                       new["params"].named_parameters()}
        assert int(new["step"]) == 1
        assert all(p.requires_grad for p in new["params"].parameters())
    for n, p in out[True].items():
        assert torch.equal(p, out[False][n]), n


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           tmp_path):
    """``init_state``, ``train()`` and the CLI run on the card by default:
    without one they raise, naming ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate.init_state(cfg, RunConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(cfg, RunConfig(), batch=2, seq=8, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--reduced", "--steps", "1", "--ckpt",
                     str(tmp_path)])


def test_sharded_params_on_a_mesh_are_not_ported():
    """What a ``model`` axis larger than 1 runs: on such a mesh
    ``make_train_step`` and ``init_state`` take every config, mamba2's SSM
    and recurrentgemma's RG-LRU too (item 5's rest, their numbers in
    ``test_torch_tp_mixers.py``): each rank's state holds its SSD heads'
    or state channels' part, half the elements of those tensors on 2 model
    ranks. Tensor parallelism of the GQA transformer (item 5) and the
    explicit replicated sync (item 3) are taken (``test_torch_tp.py``), as
    is a MoE config in every mode (``test_torch_ep.py``) and FSDP over the
    data axis (``test_torch_fsdp.py``). A stand-in mesh: only its axis
    names and sizes are read. The explicit sync still needs bucketed
    updates."""
    class Mesh:
        mesh_dim_names = ("data", "model")
        device_type = "cpu"

        def size(self, i):
            return (1, 2)[i]

        def get_local_rank(self, axis):
            return 0
    for arch, mixer in (("mamba2-1.3b", "ssm"), ("recurrentgemma-2b",
                                                   "rec")):
        cfg = get_arch(arch).reduced()
        for rc in (RunConfig(), RunConfig(pod_param_mode="replicated")):
            assert callable(make_train_step(cfg, rc, Mesh()))
            st = tstate.init_state(cfg, rc, 0, Mesh(), device="cpu")
            mods = [getattr(layer, mixer) for layer in st["params"].stack
                    if mixer in layer]
            assert mods
            for mod in mods:
                for n, p in mod.named_parameters():
                    full = math.prod(mod.shapes[n])
                    cut = "state" in mod.dims[n] or "heads" in mod.dims[n]
                    assert p.numel() == (full // 2 if cut else full), n
    for arch in ("granite-moe-3b-a800m", "tinyllama-1.1b"):
        for rc in (RunConfig(), RunConfig(pod_param_mode="replicated")):
            assert callable(make_train_step(get_arch(arch).reduced(), rc,
                                            Mesh()))
    with pytest.raises(ValueError, match="bucketed_updates"):
        make_train_step(cfg, RunConfig(pod_param_mode="replicated",
                                       bucketed_updates=False))


# ---------------------------------------------------------------------------
# the data-parallel sync over 4 gloo ranks
# ---------------------------------------------------------------------------

SYNC_BATCH = 8
SYNC_CASES = {      # name: (mesh shape, axes, RunConfig knobs)
    "hierarchical": ((4,), ("data",), {"hierarchical_sync": True}),
    "flat": ((4,), ("data",), {"hierarchical_sync": False,
                               "compress_grads": False}),
    "per_tensor": ((4,), ("data",), {"hierarchical_sync": False,
                                     "bucketed_updates": False}),
    "int8_hierarchical": ((2, 2), ("pod", "data"),
                          {"hierarchical_sync": True,
                           "compress_grads": True}),
    "int8_flat": ((4,), ("data",), {"hierarchical_sync": False,
                                    "compress_grads": True}),
}


def _sync_rc(knobs):
    return RunConfig(pod_param_mode="replicated", warmup_steps=1, steps=4,
                     learning_rate=1e-3, **knobs)


def _three_steps(cfg, rc, mesh):
    st = tstate.init_state(cfg, rc, 0, mesh, device="cpu",
                           dtype=torch.float32)
    fn = make_train_step(cfg, rc, mesh)
    losses = []
    for i in range(3):
        st, mets = fn(st, {"tokens": tokens(cfg, 20 + i, (SYNC_BATCH, S))})
        losses.append({k: v.item() for k, v in mets.items()})
    return ({n: p.detach().numpy().copy()
             for n, p in st["params"].named_parameters()}, losses)


def _sync_rank(rank, world):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)     # the ranks share the machine's cores
    cfg = get_arch("tinyllama-1.1b").reduced()
    return {name: _three_steps(cfg, _sync_rc(knobs),
                             make_mesh(shape, axes, device_type="cpu"))
            for name, (shape, axes, knobs) in SYNC_CASES.items()}


@pytest.fixture(scope="module")
def sync_world(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_world
    store = tmp_path_factory.mktemp("train-sync") / "store"
    return spawn_world(_sync_rank, 4, init_file=str(store), timeout_s=600)


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_data_parallel_sync_matches_one_rank(sync_world, case):
    """Each of 4 ranks takes its quarter of an 8-row batch, three steps
    (the first at learning rate 0, so the third's loss is the first after
    an update); every rank holds the same parameters, and without
    compression they and every step's metrics equal one rank's steps on
    the whole batch (the mean of the quarters' mean losses is the whole
    batch's mean: f32 sums in another order, rtol 1e-5, each leaf within
    2e-5 of its max but the Adam moves of ``assert_states_close``). With
    int8 compression the third loss is within the reference's 0.15 of the
    uncompressed one (``tests/md_check.py``'s train check)."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    ranks = [r[case] for r in sync_world]
    for params, _ in ranks[1:]:
        for n, p in params.items():
            assert np.array_equal(p, ranks[0][0][n]), n
    knobs = SYNC_CASES[case][2]
    plain = {k: v for k, v in knobs.items() if k != "compress_grads"}
    want_params, want_losses = _three_steps(cfg, _sync_rc(plain), None)
    got_params, got_losses = ranks[0]
    if knobs.get("compress_grads"):
        assert abs(got_losses[-1]["loss"] - want_losses[-1]["loss"]) < 0.15
        return
    for g, w in zip(got_losses, want_losses):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    lr = _sync_rc(plain).learning_rate
    for n, w in want_params.items():
        close_rel(got_params[n], w, 2e-5, n, True,
                  loose=2 * lr / max(float(np.abs(w).max()), 1e-30))


# ---------------------------------------------------------------------------
# train(): checkpoints, resume, failure injection, the command line
# ---------------------------------------------------------------------------

def _rc(steps):
    return RunConfig(remat="none", steps=steps, warmup_steps=2,
                     learning_rate=1e-3)


def test_loss_decreases_on_learnable_data():
    """``tests/test_train_loop.py``'s check: 20 steps on one fixed batch
    drive the loss down by more than 0.5."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    rc = _rc(20)
    st = tstate.init_state(cfg, rc, device="cpu")
    fn = make_train_step(cfg, rc)
    batch = {"tokens": tokens(cfg, 1, (4, 32))}
    losses = []
    for _ in range(20):
        st, mets = fn(st, batch)
        losses.append(float(mets["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """8 steps against 4, a checkpoint, and 4 more from it: the last 4
    losses agree to rtol 1e-4 (the JAX test's bound)."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    kw = dict(batch=4, seq=32, log_every=1000, device="cpu")
    _, full = ttrain.train(cfg, _rc(8), steps=8, ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=100, **kw)
    d = str(tmp_path / "b")
    ttrain.train(cfg, _rc(8), steps=4, ckpt_dir=d, ckpt_every=4, **kw)
    _, resumed = ttrain.train(cfg, _rc(8), steps=4, ckpt_dir=d,
                              ckpt_every=100, **kw)
    np.testing.assert_allclose(full[4:], resumed, rtol=1e-4)


def test_failure_injection_and_restart(tmp_path):
    cfg = get_arch("tinyllama-1.1b").reduced()
    d = str(tmp_path / "ckpt")
    kw = dict(batch=4, seq=32, log_every=1000, device="cpu", ckpt_dir=d)
    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.train(cfg, _rc(10), steps=10, ckpt_every=3,
                     inject_failure_at=7, **kw)
    # restart resumes from the last checkpoint (step 6) and completes
    st, losses = ttrain.train(cfg, _rc(10), steps=4, ckpt_every=100, **kw)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert int(st["step"]) == 10


@pytest.mark.parametrize("name", NAMES + ["tinyllama-1.1b"])
def test_cli_trains_checkpoints_and_resumes(name, tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu`` for
    every architecture: checkpoints every 2 steps, an injected failure at
    step 3, a restart from step 2, finite losses."""
    st, losses = ttrain.main(["--arch", name, "--reduced", "--device", "cpu",
                              "--steps", "4", "--batch", "2", "--seq", "16",
                              "--ckpt", str(tmp_path), "--ckpt-every", "2",
                              "--inject-failure-at", "3"])
    out = capsys.readouterr().out
    assert "injected failure at step 3" in out
    assert "resumed from step 2" in out
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert int(st["step"]) == 6
