"""The port's dry run (``launch/dryrun.py``) against the JAX package's.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when it is
imported, which would follow every later test of the worker, so it runs
only in one subprocess (``_REFERENCE``, 8 host devices, as its
``--devices`` flag was made for). That subprocess gives, for the tests
here:

- ``rc_for_mode`` for every (arch, shape, mode), as published and under a
  ``--set``/``--set-moe`` override;
- the per-device shard bytes of each leaf of its ``make_train_step``
  state, reduced configs of the ten architectures, ``rc_for_mode(...,
  "train_4k", "baseline")``, on (2, 4) and (2, 2, 2) (no lowering);
- ``analyze_hlo(...).flops`` of the reduced TinyLlama's compiled prefill
  and train steps on one device;
- its skip record for ``tinyllama-1.1b``, ``long_500k``.

The port's side runs in this process on ``meta`` tensors over a ``fake``
world of 8 ranks (``launch/mesh.py::fake_world``), ended when the module
is done.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cell_is_applicable as j_applicable  # noqa: E402
from repro.configs import get_shape as j_get_shape  # noqa: E402
from repro.configs import live_cells as j_live_cells  # noqa: E402
from repro.models.model import count_params_analytic as j_count  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, RunConfig,  # noqa: E402
                                 cell_is_applicable, get_arch, get_shape,
                                 live_cells)
from repro_torch.core.amdahl import sheet_spec  # noqa: E402
from repro_torch.core.op_census import (attended_pairs, census,  # noqa: E402
                                        flash_flops)
from repro_torch.kernels import card_routing  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_fwd)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import end_fake_world, fake_world  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.training.state import (_bias_groups,  # noqa: E402
                                        abstract_state)
from repro_torch.training.step import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPEC = "NVIDIA H100 80GB HBM3"
# (--set, --set-moe) variants rc_for_mode is held to
VARIANTS = [({}, {}),
            ({"microbatch": 2, "donate_state": False,
              "attention_impl": "masked", "compress_grads": True},
             {"capacity_factor": 2.0, "top_k": 4})]
FLOPS_B, FLOPS_S = 2, 64
TINY = {0: ((2, 4), ("data", "model")),
        1: ((2, 2, 2), ("pod", "data", "model"))}

_REFERENCE = r'''
import dataclasses, json, sys, tempfile
sys.argv[1:1] = ["--devices", "8"]   # read by the reference's dry run at import
from repro.launch import dryrun as jdr
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS, SHAPES, RunConfig, get_arch, get_shape
from repro.core.hlo_analysis import analyze_hlo
from repro.configs import cell_is_applicable
from repro.launch.mesh import make_tiny_mesh
from repro.models import model as jmdl
from repro.parallel.sharding import make_rules
from repro.serving.engine import make_prefill_step
from repro.training.step import make_train_step

spec = json.loads(sys.argv[-2])
out = {"rc": {}, "state": {}, "flops": {}, "batch": {}, "serve": {}}


def leaf_bytes(tree):
    got = {}
    for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        k = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in p)
        got[k] = int(np.prod(x.sharding.shard_shape(x.shape))) * \
            x.dtype.itemsize
    return got


for arch in ARCHS:
    for shape in SHAPES:
        for mode in ("baseline", "optimized"):
            for vi, (ov, mov) in enumerate(spec["variants"]):
                cfg = get_arch(arch)
                if mov and cfg.moe is not None:
                    cfg = dataclasses.replace(
                        cfg, moe=dataclasses.replace(cfg.moe, **mov))
                rc = jdr.rc_for_mode(cfg, get_shape(shape), mode, ov or None)
                out["rc"][f"{arch}|{shape}|{mode}|{vi}"] = \
                    dataclasses.asdict(rc)
for arch in ARCHS:
    cfg = get_arch(arch).reduced()
    rc = jdr.rc_for_mode(cfg, get_shape("train_4k"), "baseline")
    for multi in (0, 1):
        _, st_abs, st_sh, _ = make_train_step(
            cfg, rc, make_tiny_mesh(multi_pod=bool(multi)))
        got = {}
        for (p, x), s in zip(jax.tree_util.tree_flatten_with_path(st_abs)[0],
                             jax.tree.leaves(st_sh)):
            k = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                         for q in p)
            got[k] = int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
        out["state"][f"{arch}|{multi}"] = got
        mesh = make_tiny_mesh(multi_pod=bool(multi))
        rules = make_rules(mesh, pod_param_mode=rc.pod_param_mode)
        out["batch"][f"{arch}|{multi}"] = leaf_bytes(
            jmdl.input_specs(cfg, get_shape("train_4k"), mesh, rules))
        for shape in SHAPES:
            sh = get_shape(shape)
            if sh.kind == "train" or not cell_is_applicable(cfg, sh)[0]:
                continue
            rs = jdr.rc_for_mode(cfg, sh, "baseline")
            rules = make_rules(mesh, pod_param_mode=rs.pod_param_mode)
            params, biases = jdr._abstract_params_sharded(cfg, mesh, rules)
            tree = {"params": params, "biases": biases,
                    "batch": jmdl.input_specs(cfg, sh, mesh, rules)}
            if sh.kind == "decode":
                tree["cache"] = jdr._abstract_cache_sharded(
                    cfg, mesh, rules, sh.global_batch, sh.seq_len)
            out["serve"][f"{arch}|{shape}|{multi}"] = leaf_bytes(tree)
one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
cfg = get_arch("tinyllama-1.1b").reduced()
batch = {"tokens": jax.ShapeDtypeStruct((spec["B"], spec["S"]), np.int32)}
fn, rules = make_prefill_step(cfg, RunConfig(), one, max_len=spec["S"])
p_abs, b_abs = jdr._abstract_params_sharded(cfg, one, rules)
out["flops"]["prefill"] = analyze_hlo(
    fn.lower(p_abs, b_abs, batch).compile().as_text()).flops
fn, st_abs, _, _ = make_train_step(cfg, RunConfig(), one)
out["flops"]["train"] = analyze_hlo(
    fn.lower(st_abs, batch).compile().as_text()).flops
with tempfile.TemporaryDirectory() as d:
    out["skip"] = jdr.run_cell("tinyllama-1.1b", "long_500k", "tiny",
                               "baseline", d)
with open(sys.argv[-1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE,
         json.dumps({"variants": VARIANTS, "B": FLOPS_B, "S": FLOPS_S}),
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def world():
    """A fake world of 8 ranks (rank 0), ended with the module."""
    if dist.is_initialized():
        pytest.skip("another process group is running in this process")
    fake_world(*TINY[0])
    yield
    end_fake_world()


# ---------------------------------------------------------------------------
# the shape cells and the parameter counts
# ---------------------------------------------------------------------------

def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for name in SHAPES:
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(j_get_shape(name))
    with pytest.raises(KeyError) as got:
        get_shape("train_8k")
    with pytest.raises(KeyError) as want:
        j_get_shape("train_8k")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cells_and_parameter_counts_equal_the_reference(arch):
    """``cell_is_applicable`` (flag and reason) for each shape, and
    ``n_params``/``n_params_active`` against the reference's
    ``count_params_analytic``."""
    cfg, jcfg = get_arch(arch), JARCHS[arch]
    for name in SHAPES:
        assert cell_is_applicable(cfg, SHAPES[name]) == \
            j_applicable(jcfg, JSHAPES[name])
    assert cfg.n_params() == j_count(jcfg)
    assert cfg.n_params_active() == j_count(jcfg, active_only=True)
    assert cfg.n_params_active() <= cfg.n_params()


def test_live_cells_equal_the_reference():
    got = [(c.name, s.name) for c, s in live_cells()]
    want = [(c.name, s.name) for c, s in j_live_cells()]
    assert sorted(got) == sorted(want) and len(got) == len(set(got))


# ---------------------------------------------------------------------------
# rc_for_mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["baseline", "optimized"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rc_for_mode_equals_the_reference(ref, arch, mode):
    for shape in SHAPES:
        for vi, (ov, mov) in enumerate(VARIANTS):
            cfg = get_arch(arch)
            if mov and cfg.moe is not None:
                cfg = dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe, **mov))
            rc = dryrun.rc_for_mode(cfg, get_shape(shape), mode, ov or None)
            assert dataclasses.asdict(rc) == \
                ref["rc"][f"{arch}|{shape}|{mode}|{vi}"], (shape, vi)


def test_set_values_parse_as_the_reference_does():
    assert [dryrun._value(v) for v in ("true", "False", "4", "0.5", "x")] \
        == [True, False, 4, 0.5, "x"]


# ---------------------------------------------------------------------------
# argument bytes: the train state a rank holds
# ---------------------------------------------------------------------------

# Leaves whose layout is known to differ. The reference's FSDP rules shard a
# tensor over the data axes only along a dimension its logical names map
# there ("embed", "ffn", ...); a tensor with none stays whole on every data
# rank. The port's FSDP (``parallel/fsdp.py``) cuts every parameter's rows,
# so it holds exactly 1/F of these (F the data ranks), and their moments
# follow. By leaf name:
ROWS_CUT = {
    # norms and their biases: one [D] vector
    "scale": "a norm's scale", "bias": "a norm's bias",
    "q_norm": "MLA's query norm", "kv_norm": "MLA's latent norm",
    "gn": "the SSM's gated norm",
    # the RG-LRU: gate blocks [blocks, w, w] and per-channel vectors
    "w_i": "RG-LRU input gate blocks", "w_r": "RG-LRU recurrence gate blocks",
    "b_i": "RG-LRU input gate bias", "b_r": "RG-LRU recurrence gate bias",
    "lam": "RG-LRU decay", "conv": "RG-LRU convolution",
    # the SSM: per-head vectors and the short convolutions
    "A_log": "SSM decay", "D": "SSM skip", "dt_bias": "SSM step bias",
    "conv_x": "SSM x convolution", "conv_B": "SSM B convolution",
    "conv_C": "SSM C convolution",
    # the MoE router [D, E] and MLA's up projections [rank, H, d] (their
    # heads cut over the model axis only)
    "router": "the MoE router", "w_uq": "MLA query up projection",
    "w_uk": "MLA key up projection", "w_uv": "MLA value up projection",
}
# Adafactor's factored statistics (``opt/per/<leaf>/vr|vc|v``) follow the
# port's row cut of their leaf (``optim/optimizers.py::FactoredLeaf``),
# where the reference's follow its sharding of the leaf's dimensions.


def _port_leaf_bytes(cfg, state) -> dict:
    """Bytes this rank holds by the reference's state key."""
    def nb(t):
        return t.numel() * t.element_size()
    named = dict(state["params"].named_parameters())
    out = {"step": nb(state["step"])}
    for leaf in mdl.reference_leaves(cfg):
        out[f"params/{leaf.key}"] = sum(nb(named[n]) for n in leaf.names)
        for mk, tree in state["opt"].items():
            if mk == "per":
                for n, t in tree[leaf.key].items():
                    out[f"opt/per/{leaf.key}/{n}"] = nb(t)
            else:
                out[f"opt/{mk}/{leaf.key}"] = sum(nb(tree[n])
                                                  for n in leaf.names)
    for key, names, _ in _bias_groups(cfg):
        out[f"biases/{key}"] = sum(nb(state["biases"][n]) for n in names)
    return out


@pytest.mark.parametrize("multi", [0, 1])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_equal_the_reference_leaf_by_leaf(ref, world, arch,
                                                         multi):
    """The dry run's per-device argument bytes for a ``train_4k`` cell of
    the reduced config, on a fake (2, 4) or (2, 2, 2) world: the state's
    leaves, each equal to the reference's shard bytes (the exceptions
    above: exactly 1/F of them), plus this rank's rows of the batch, each
    input equal to the reference's shard bytes of it."""
    cfg = get_arch(arch).reduced()
    mesh = fake_world(*TINY[multi])
    rc = dryrun.rc_for_mode(cfg, get_shape("train_4k"), "baseline")
    step, args, _ = dryrun.build_step(cfg, get_shape("train_4k"), mesh, rc)
    with census(args=args) as c:
        pass
    got = _port_leaf_bytes(cfg, args[0])
    batch = _batch_bytes(args[1])
    assert c.arg_bytes == sum(got.values()) + sum(batch.values())
    assert batch == ref["batch"][f"{arch}|{multi}"]
    _assert_leaves(got, ref["state"][f"{arch}|{multi}"], mesh)


def _batch_bytes(batch: dict) -> dict:
    return {k: t.numel() * t.element_size() for k, t in batch.items()}


def _assert_leaves(got: dict, want: dict, mesh) -> None:
    """Every leaf's bytes equal the reference's shard bytes, but the
    leaves whose rows FSDP cuts where the reference keeps them whole
    (``ROWS_CUT``; Adafactor's statistics): exactly 1/F of them."""
    assert set(got) == set(want)
    F = mesh.size() // mesh["model"].size()
    for k in sorted(got):
        if got[k] == want[k]:
            continue
        name = k.split("/")[-2 if k.startswith("opt/per/") else -1]
        assert got[k] * F == want[k], (k, got[k], want[k])
        assert k.startswith("opt/per/") or name in ROWS_CUT, k


def _cache_keys(cfg) -> list:
    """The reference's cache key of each layer (``g<i>/l<j>`` of a scan
    group, ``tail/l<j>``), in layer order."""
    from repro_torch.models.transformer import plan_layers
    groups, tail = plan_layers(cfg)
    keys = []
    for gi, (sig, cnt) in enumerate(groups):
        keys += [f"g{gi}/l{li}" for _ in range(cnt) for li in range(len(sig))]
    return keys + [f"tail/l{li}" for li in range(len(tail or ()))]


def _serve_leaf_bytes(cfg, params, batch, cache=None) -> dict:
    """A serving cell's arguments as the reference's leaves: the
    parameters and router biases by their key, the batch's inputs, each
    cache leaf summed over a scan group's layers."""
    def nb(t):
        return t.numel() * t.element_size()
    named = dict(params.named_parameters())
    bufs = dict(params.named_buffers())
    out = {f"params/{leaf.key}": sum(nb(named[n]) for n in leaf.names)
           for leaf in mdl.reference_leaves(cfg)}
    for key, names, _ in _bias_groups(cfg):
        out[f"biases/{key}"] = sum(nb(bufs[n]) for n in names)
    out.update({f"batch/{k}": v for k, v in _batch_bytes(batch).items()})
    for key, layer in zip(_cache_keys(cfg), cache or ()):
        for mixer, d in layer.items():
            for n, t in d.items():
                k = f"cache/{key}/{mixer}/{n}"
                out[k] = out.get(k, 0) + nb(t)
    return out


SERVE_CELLS = [(a, s, m) for a in sorted(ARCHS) for s in SHAPES
               for m in (0, 1) if SHAPES[s].kind != "train"
               and cell_is_applicable(get_arch(a).reduced(), SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape,multi", SERVE_CELLS)
def test_serving_argument_bytes_equal_the_reference_leaf_by_leaf(
        ref, world, arch, shape, multi):
    """The dry run's per-device argument bytes for every prefill and decode
    cell of the reduced configs on a fake (2, 4) or (2, 2, 2) world: the
    weights FSDP-sharded over the data axes ("sharded", as
    ``rc_for_mode`` sets it), the cache cut over the batch and ``model``
    (the KV heads, the head dim, the sequence, MLA's latent), this rank's
    rows of the batch: each leaf equal to the reference's shard bytes,
    but ``ROWS_CUT``'s at exactly 1/F."""
    cfg = get_arch(arch).reduced()
    mesh = fake_world(*TINY[multi])
    sh = get_shape(shape)
    rc = dryrun.rc_for_mode(cfg, sh, "baseline")
    step, args, _ = dryrun.build_step(cfg, sh, mesh, rc)
    with census(args=args) as c:
        pass
    if sh.kind == "prefill":
        got = _serve_leaf_bytes(cfg, args[0], args[1])
    else:
        got = _serve_leaf_bytes(cfg, args[0], {"tokens": args[2]}, args[1])
    assert c.arg_bytes == sum(got.values())
    _assert_leaves(got, ref["serve"][f"{arch}|{shape}|{multi}"], mesh)


# ---------------------------------------------------------------------------
# the census against the reference's HLO analysis
# ---------------------------------------------------------------------------

def test_prefill_matmul_flops_equal_the_reference_hlo(ref):
    """One device, the card routing off (``attend`` runs the masked formula,
    as the reference's lowering on host devices does): the reduced
    TinyLlama's prefill census FLOPs within 1% of ``analyze_hlo``'s."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    lm = mdl.LM(cfg, device="meta").trainable(False)
    batch = {"tokens": torch.empty((FLOPS_B, FLOPS_S), dtype=torch.int32,
                                   device="meta")}
    with torch.inference_mode(), census() as c:
        mdl.prefill(cfg, RunConfig(), lm, batch, FLOPS_S)
    assert c.flops == pytest.approx(ref["flops"]["prefill"], rel=0.01)


def test_train_matmul_flops_within_the_band_of_the_reference_hlo(ref):
    """The same for a train step (``RunConfig()``: remat "full"). Band:
    [0.99, 1.01]. Both count every matrix product the step runs: the
    forward, its recompute inside each remat unit in the backward
    (``jax.checkpoint`` keeps XLA from folding it into the forward; the
    port's ``torch.utils.checkpoint`` reruns it), and the two products of
    the backward of each, the head's outside the stack; the optimizer adds
    none. So the counts agree as for prefill."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    st = abstract_state(cfg, RunConfig())
    batch = {"tokens": torch.empty((FLOPS_B, FLOPS_S), dtype=torch.int32,
                                   device="meta")}
    with census() as c:
        make_train_step(cfg, RunConfig())(st, batch)
    assert 0.99 <= c.flops / ref["flops"]["train"] <= 1.01


def test_fsdp_wire_bytes_are_the_formulas(world):
    """On a fake (2, 4) world ("sharded": FSDP over the 2 data ranks, TP
    over 4): every all-gather's wire bytes are (F-1)/F of its output, every
    reduce-scatter's of its input; a step gathers each unit's parameters
    twice (forward and remat recompute) and the outer ones once, and
    reduce-scatters each once, so the sums are (F-1)/F times those
    parameter bytes, at this model rank's shapes."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    mesh = fake_world(*TINY[0])
    rc = RunConfig()
    step, (state, batch), _ = dryrun.build_step(
        cfg, dataclasses.replace(get_shape("train_4k"), global_batch=4,
                                 seq_len=32), mesh, rc)
    with census() as c:
        step(state, batch)
    F = 2
    gathers = [x for x in c.collectives if x.op == "all-gather"
               and x.group_size == F]
    scatters = [x for x in c.collectives if x.op == "reduce-scatter"]
    assert gathers and scatters
    for x in gathers + scatters:
        assert x.wire_bytes == pytest.approx(x.payload_bytes * (F - 1) / F)
    lm = state["params"]
    local = sum(p.numel() * p.element_size() for p in lm.parameters()) * F
    stack = sum(p.numel() * p.element_size()
                for p in lm.stack.parameters()) * F
    outer = local - stack
    assert sum(x.payload_bytes for x in gathers) == 2 * stack + outer
    assert sum(x.payload_bytes for x in scatters) == stack + outer


# ---------------------------------------------------------------------------
# the flash custom op, the live bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_fake_gives_the_kernel_output_and_its_flops(dtype, window):
    B, S, H, Kv, dh = 2, 64, 8, 2, 32
    q = torch.empty(B, S, H, dh, dtype=dtype, device="meta")
    k = torch.empty(B, S, Kv, dh, dtype=dtype, device="meta")
    o = flash_attention_fwd(q, k, k, True, window, 0.0, 0.125)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, dtype, "meta")
    with card_routing(), census() as c:
        o = flash_attention(q, k, k, True, window, 0.0, None)
    assert c.ops["repro_torch::flash_attention_fwd"] == 1
    assert c.flops == flash_flops(q, window) == \
        4.0 * B * H * dh * attended_pairs(S, window)
    assert c.hbm_bytes == (2 * q.numel() + 2 * k.numel()) * q.element_size()
    with census() as c:                   # the routing off: the formula
        flash_attention(q, k, k, True, window, 0.0, None)
    assert "repro_torch::flash_attention_fwd" not in c.ops


def test_the_fake_refuses_what_the_kernel_refuses():
    q = torch.empty(1, 8, 3, 24, device="meta")
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q, True, 0, 0.0, 1.0)


def test_live_bytes_peak_is_the_hand_count():
    """arg 4,000 B; b 4,000 and c 4,000 live together (12,000), b freed,
    a view adds nothing, the cat 8,000 beside c (16,000 at the peak with
    the argument), an in-place update of the argument adds nothing."""
    a = torch.ones(1000)

    def f(a):
        b = a * 2
        c = b + 1
        del b
        d = c.view(10, 100)
        e = torch.cat([c, d.reshape(-1)])
        a.add_(1)
        return e

    with census(args=[a]) as c:
        f(a)
    assert (c.arg_bytes, c.peak_bytes) == (4000, 16000)


# ---------------------------------------------------------------------------
# records and the entry point
# ---------------------------------------------------------------------------

def test_records_carry_the_reference_keys(ref, world, tmp_path):
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "tiny", "baseline",
                          str(tmp_path), device="cpu", spec=sheet_spec(SPEC))
    assert rec["status"] == "ok", rec.get("error")
    assert {"cell", "status", "devices", "rc", "memory", "cost_analysis",
            "analyzer", "terms", "n_params", "n_params_active",
            "suggestion", "trace_s"} <= rec.keys()
    assert rec["cell"] == "tinyllama-1.1b__decode_32k__tiny__baseline"
    assert rec["devices"] == 8
    assert set(rec["memory"]) == {
        "argument_bytes_per_device", "output_bytes_per_device",
        "temp_bytes_per_device", "alias_bytes_per_device"}
    assert rec["memory"]["alias_bytes_per_device"] > 0      # the cache
    assert rec["analyzer"]["flops_per_device"] > 0
    assert json.loads((tmp_path / (rec["cell"] + ".json")).read_text()) \
        ["status"] == "ok"
    skip = dryrun.run_cell("tinyllama-1.1b", "long_500k", "tiny",
                           "baseline", str(tmp_path))
    assert skip == ref["skip"]


def test_without_a_card_or_a_spec_the_entry_point_raises(world, tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        dryrun.run_cell("tinyllama-1.1b", "decode_32k", "tiny", "baseline",
                        str(tmp_path))
    with pytest.raises(ValueError):
        dryrun.run_cell("tinyllama-1.1b", "decode_32k", "tiny", "baseline",
                        str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError):
        dryrun.main(["--arch", "tinyllama-1.1b", "--mesh", "tiny",
                     "--out", str(tmp_path)])
