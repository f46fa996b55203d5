"""The port's checkpointing against the JAX package's, on the CPU:
round trip, async writes, replica fallback on a corrupt file, simulated
dead hosts, garbage collection, the reference's on-disk layout and
manifest, and bf16 files written by one package and read by the other,
both ways. Every comparison is exact (bits)."""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import chunk_checksums as jchunk_checksums  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, chunk_checksums,  # noqa: E402
                                    verify)
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training import state as tstate  # noqa: E402


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(16, 8, generator=g),
                       "b": torch.randn(8, generator=g),
                       "h": torch.randn(5, 3, generator=g).to(torch.bfloat16)},
            "opt": {"m": [torch.zeros(4), torch.ones(4)]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(st):
    if isinstance(st, dict):
        return {k: _zeros_like(v) for k, v in st.items()}
    if isinstance(st, list):
        return [_zeros_like(v) for v in st]
    return torch.zeros_like(st)


def _flat(st, prefix=""):
    if isinstance(st, dict):
        return {k: v for kk, vv in st.items()
                for k, v in _flat(vv, f"{prefix}{kk}/").items()}
    if isinstance(st, list):
        return {k: v for i, vv in enumerate(st)
                for k, v in _flat(vv, f"{prefix}{i}/").items()}
    return {prefix[:-1]: st}


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_roundtrip(tmp_path):
    st = _state()
    ck = Checkpointer(str(tmp_path), replication=2, async_io=False)
    ck.save(10, st, mesh_shape=(1, 1))
    back, manifest = ck.restore(_zeros_like(st))
    assert manifest["step"] == 10 and manifest["mesh_shape"] == [1, 1]
    _equal(back, st)


def test_async_save_then_restore(tmp_path):
    st = _state()
    ck = Checkpointer(str(tmp_path), replication=2, async_io=True)
    ck.save(3, st)
    ck.wait()
    _equal(ck.restore(_zeros_like(st))[0], st)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_replica_fallback_on_corruption(tmp_path):
    st = _state()
    ck = Checkpointer(str(tmp_path), replication=2, async_io=False)
    ck.save(1, st)
    d = ck.step_dir(1)
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    meta = manifest["leaves"]["params/w"]
    victim = os.path.join(d, f"host_{meta['hosts'][0]}", meta["file"])
    arr = np.load(victim)
    arr.reshape(-1)[0] += 1.0
    np.save(victim, arr)
    assert verify(arr, meta["crc32"]) == 0
    _equal(ck.restore(_zeros_like(st))[0], st)   # from the other replica


def test_failed_hosts_simulation(tmp_path):
    st = _state()
    ck = Checkpointer(str(tmp_path), replication=2, n_hosts=4,
                      async_io=False)
    ck.save(1, st)
    _equal(ck.restore(_zeros_like(st), failed_hosts={0})[0], st)
    with pytest.raises(IOError):
        ck.restore(_zeros_like(st), failed_hosts={0, 1, 2, 3})


def test_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), replication=1, async_io=False, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s))
    assert ck.list_steps() == [3, 4] and ck.latest_step() == 4


def test_checksums_match_the_reference():
    buf = np.random.default_rng(0).integers(0, 255, 3000, np.uint8)
    for chunk in (512, 1000, 1 << 20):
        assert chunk_checksums(buf, chunk) == jchunk_checksums(buf, chunk)


def _jax_state():
    rng = np.random.default_rng(1)
    return {"params": {"w": jnp.asarray(rng.normal(size=(16, 8)),
                                        jnp.float32),
                       "b": jnp.asarray(rng.normal(size=(8,)), jnp.float32),
                       "h": jnp.asarray(rng.normal(size=(5, 3)),
                                        jnp.bfloat16)},
            "opt": {"m": [jnp.zeros((4,)), jnp.ones((4,))]},
            "step": jnp.int32(7)}


def _to_port(jst):
    out = {}
    for k, v in _flat(jst).items():
        a = np.asarray(v)
        out[k] = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                  if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(
                      np.array(a)))
    return out


def test_same_layout_and_files_as_the_reference(tmp_path):
    """The same tree saved by both packages gives the same directories,
    file names, manifest entries (shape, dtype, file, hosts, crc32) and
    byte-identical files, bf16 included."""
    jst = _jax_state()
    JCheckpointer(str(tmp_path / "jax"), async_io=False).save(5, jst)
    port = {}
    for k, v in _to_port(jst).items():
        node = port
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    port["opt"]["m"] = [port["opt"]["m"]["0"], port["opt"]["m"]["1"]]
    Checkpointer(str(tmp_path / "port"), async_io=False).save(5, port)
    dj, dp = tmp_path / "jax" / "step_00000005", tmp_path / "port" / \
        "step_00000005"
    mj = json.load(open(dj / "manifest.json"))
    mp = json.load(open(dp / "manifest.json"))
    assert mj.keys() == mp.keys()
    assert mj["leaves"] == mp["leaves"]
    assert mp["leaves"]["params/h"]["dtype"] == "bfloat16"
    files = sorted(str(p.relative_to(dj)) for p in dj.rglob("*.npy"))
    assert files == sorted(str(p.relative_to(dp)) for p in dp.rglob("*.npy"))
    for f in files:
        assert (dj / f).read_bytes() == (dp / f).read_bytes(), f


def test_bf16_crosses_both_ways(tmp_path):
    """A bf16 leaf written by the port reads back in the reference (through
    its ``_restore_dtype`` view) and one written by the reference reads
    back in the port, bit for bit."""
    jst = _jax_state()
    port = _to_port(jst)
    h = port["params/h"]
    Checkpointer(str(tmp_path / "a"), async_io=False).save(
        1, {"params": {"h": h}})
    back, _ = JCheckpointer(str(tmp_path / "a")).restore(
        {"params": {"h": jst["params"]["h"]}})
    assert back["params"]["h"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["params"]["h"]).view(np.int16),
                          h.view(torch.int16).numpy())
    JCheckpointer(str(tmp_path / "b"), async_io=False).save(
        1, {"params": {"h": jst["params"]["h"]}})
    like = {"params": {"h": torch.zeros(5, 3, dtype=torch.bfloat16)}}
    got, _ = Checkpointer(str(tmp_path / "b")).restore(like)
    assert torch.equal(got["params"]["h"].view(torch.int16), h.view(
        torch.int16))


def test_train_state_round_trip_fills_the_model_in_place(tmp_path):
    """A train state (the LM, its router biases, bucketed moments, the
    step) after one step, restored into a fresh state: every tensor equal,
    the fresh LM's parameters filled where they are (same objects)."""
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    rc = RunConfig(warmup_steps=0, steps=4)
    st = tstate.init_state(cfg, rc, 0, device="cpu")
    st, _ = make_train_step(cfg, rc)(st, {"tokens": np.random.default_rng(
        0).integers(0, cfg.vocab, (2, 16))})
    ck = Checkpointer(str(tmp_path), async_io=True)
    ck.save(1, st)
    ck.wait()
    fresh = tstate.init_state(cfg, rc, 1, device="cpu")
    ids = [id(p) for p in fresh["params"].parameters()]
    back, manifest = ck.restore(fresh)
    assert back is fresh and ids == [id(p) for p in
                                     back["params"].parameters()]
    assert any(k.startswith("biases/") for k in manifest["leaves"])
    for (n, a), b in zip(st["params"].named_parameters(),
                         back["params"].parameters()):
        assert torch.equal(a, b), n
    for n, b in st["biases"].items():
        assert torch.equal(b, back["biases"][n])
    for a, b in zip(st["opt"]["m"] + st["opt"]["v"],
                    back["opt"]["m"] + back["opt"]["v"]):
        assert torch.equal(a, b)
    assert int(back["step"]) == 1
