"""The port's external shuffle (disk spill) against the JAX package's, on the
CPU.

The unit half holds ``repro_torch.mapreduce.spill.SpillStore`` to the
reference's contract (range-bucketed staging, finalize-rename, truncation
refusal, reclamation) and to its segment format: segments either package
writes load in the other, bit for bit. The end-to-end half runs pair jobs
through ``run_jobs_streaming(..., spill=...)`` in both packages: the port's
spilled outputs equal the JAX package's spilled outputs and the port's
monolithic ones, for every codec and budget, sequential and with lanes.
The JAX runs reduce through the plain references of its Pallas kernels,
called eagerly (``test_torch_mapreduce``'s ``_jobs``).
"""
import os
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.mapreduce as R  # noqa: E402
from repro.data import pipeline as jp  # noqa: E402
from repro.mapreduce import executor as jexec  # noqa: E402
from repro.mapreduce import spill as jspill  # noqa: E402
from repro.mapreduce.instrumentation import StageStats as JStageStats  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import pipeline as tp  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.ft import (FaultySplitSource, SpeculativeConfig,  # noqa: E402
                            SpeculativePolicy)
from repro_torch.mapreduce import spill as tspill  # noqa: E402
from test_torch_chaos import _CloneLoses  # noqa: E402
from test_torch_mapreduce import (_catalog, _jobs, _outputs,  # noqa: E402
                                  _scaled)

STALL_S = 60.0          # far longer than any run: only a cancel ends it


def _mapped(seed=0, n_rows=40, P=12, d=2, skey=False):
    """A hand-built host MappedSplit (numpy): random keys, every row also
    emitted as a bucket entry to a (possibly different) partition, so
    ranges see both owned rows and payload-only border rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, P, n_rows).astype(np.int32)
    dest = rng.integers(0, P, n_rows).astype(np.int32)
    src = rng.permutation(n_rows).astype(np.int32)
    pay = rng.integers(-99, 99, (n_rows, d)).astype(np.int16)
    sk = rng.standard_normal(n_rows).astype(np.float32) if skey else None
    return T.MappedSplit(payloads=(pay,), keys=keys, dest_eff=dest, src=src,
                         skey=sk, n_rows=n_rows, d=d, nbytes_in=0)


def _as_jax(m, cls=R.MappedSplit, conv=np.asarray):
    return cls(payloads=tuple(conv(p) for p in m.payloads),
               keys=conv(m.keys), dest_eff=conv(m.dest_eff), src=conv(m.src),
               skey=None if m.skey is None else conv(m.skey),
               n_rows=m.n_rows, d=m.d, nbytes_in=m.nbytes_in)


def _entry_sums(P, recs):
    """Oracle: per-partition sum over bucket entries of the referenced
    payload rows: the quantity any dest/src remap must preserve."""
    out = np.zeros((P, recs[0].payloads[0].shape[1]), np.int64)
    for m in recs:
        np.add.at(out, np.asarray(m.dest_eff),
                  np.asarray(m.payloads[0])[np.asarray(m.src)].astype(np.int64))
    return out


def _records_equal(a: dict, b: dict) -> None:
    assert (a["lo"], a["hi"], a["d"], a["n_rows"]) == \
        (b["lo"], b["hi"], b["d"], b["n_rows"])
    assert len(a["payloads"]) == len(b["payloads"])
    for x, y in zip(a["payloads"], b["payloads"]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for f in ("keys", "dest_eff", "src", "skey"):
        if a[f] is None:
            assert b[f] is None
        else:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f


# ---------------------------------------------------------------------------
# SpillStore units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_ranges", [1, 3, 7, 99])
def test_plan_bounds_matches_reference(seed, n_ranges):
    rng = np.random.default_rng(seed)
    w = rng.exponential(size=int(rng.integers(1, 40)))
    w[rng.random(len(w)) < 0.3] = 0.0
    got = tspill.plan_bounds(w, n_ranges)
    assert got.tolist() == jspill.plan_bounds(w, n_ranges).tolist()
    assert got[0] == 0 and got[-1] == len(w) and (np.diff(got) > 0).all()


def test_plan_bounds_properties():
    assert tspill.plan_bounds(np.ones(16), 4).tolist() == [0, 4, 8, 12, 16]
    w = np.zeros(10)
    w[0] = 100.0
    b = tspill.plan_bounds(w, 4)
    assert b[0] == 0 and b[-1] == 10 and (np.diff(b) > 0).all()
    assert tspill.plan_bounds(np.ones(3), 99).tolist() == [0, 1, 2, 3]


@pytest.mark.timeout_s(120)
def test_spill_store_roundtrip_multi_chunk(tmp_path):
    """Stage+commit two chunks, read every range back: merged entry
    streams preserve the per-partition sums, owned-row keys are
    range-local, border rows carry the span sentinel."""
    P = 12
    recs = [_mapped(seed=1), _mapped(seed=2, n_rows=23)]
    store = T.SpillStore(str(tmp_path / "sp"), P)
    store.set_bounds(T.plan_bounds(np.ones(P), 3))
    try:
        for m in recs:
            store.commit_chunk(store.stage_chunk([m], store.next_tag()))
        assert store.n_chunks == 2
        want = _entry_sums(P, recs)
        got = np.zeros_like(want)
        owned_seen = 0
        for z in range(store.n_ranges):
            r = store.read_range(z)
            lo, span = r["lo"], r["hi"] - r["lo"]
            assert r["keys"].min() >= 0 and r["keys"].max() <= span
            assert (0 <= r["dest_eff"]).all() and (r["dest_eff"] < span).all()
            assert (0 <= r["src"]).all() and (r["src"] < r["n_rows"]).all()
            np.add.at(got, r["dest_eff"] + lo,
                      r["payloads"][0][r["src"]].astype(np.int64))
            owned_seen += int((r["keys"] < span).sum())
        assert np.array_equal(got, want)
        assert owned_seen == sum(len(m.keys) for m in recs)
    finally:
        store.close()
    assert not (tmp_path / "sp").exists()


@pytest.mark.timeout_s(120)
def test_staged_chunks_invisible_until_commit_and_swept(tmp_path):
    P = 8
    m = _mapped(seed=3, P=P)
    store = T.SpillStore(str(tmp_path / "sp"), P)
    store.set_bounds([0, P])
    try:
        store.commit_chunk(store.stage_chunk([m], store.next_tag()))
        before = store.read_range(0)
        loser = store.stage_chunk([m], store.next_tag())   # never committed
        assert any(".staged-" in p for _, p in loser.paths)
        after = store.read_range(0)
        _records_equal(before, after)
        assert after["n_rows"] == m.n_rows                 # not doubled
        assert store.sweep_staged() == 1
        assert all(".staged-" not in f for f in os.listdir(store.root))
    finally:
        store.close()


@pytest.mark.timeout_s(120)
def test_truncated_segment_refused_with_path_and_remainder(tmp_path):
    P = 6
    store = T.SpillStore(str(tmp_path / "sp"), P)
    store.set_bounds([0, P])
    try:
        store.commit_chunk(store.stage_chunk([_mapped(seed=4, P=P)],
                                             store.next_tag()))
        path = store.range_segment_paths(0)[0]
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:-3])                 # torn write: 3 bytes short
        with pytest.raises(ValueError, match=r"-3 byte remainder") as ei:
            store.read_range(0)
        assert path in str(ei.value)
        with open(path, "wb") as f:
            f.write(b"JUNKJUNK")
        with pytest.raises(ValueError, match="magic"):
            store.read_range(0)
    finally:
        store.close()


@pytest.mark.timeout_s(120)
def test_injected_write_fault_leaves_invalid_staged_file(tmp_path):
    P = 6
    seen = {}

    def die(path):
        seen["path"] = path
        raise OSError("lane died mid-spill-write")

    store = T.SpillStore(str(tmp_path / "sp"), P, write_fault=die)
    store.set_bounds([0, P])
    try:
        with pytest.raises(OSError, match="mid-spill-write"):
            store.stage_chunk([_mapped(seed=5, P=P)], store.next_tag())
        assert ".staged-" in seen["path"] and os.path.exists(seen["path"])
        with pytest.raises(ValueError, match="remainder"):
            tspill._read_segment(seen["path"])
        assert store.n_chunks == 0
        assert store.sweep_staged() >= 1
    finally:
        store.close()


def test_spilled_stream_splits_wraps_store(tmp_path):
    P = 6
    store = T.SpillStore(str(tmp_path / "sp"), P)
    store.set_bounds([0, 3, P])
    try:
        store.commit_chunk(store.stage_chunk([_mapped(seed=6, P=P)],
                                             store.next_tag()))
        src = tp.SpilledStreamSplits(store)
        assert src.n_splits() == store.n_ranges == 2
        rec = src.split(1)
        assert (rec["lo"], rec["hi"]) == (3, 6)
        _records_equal(rec, store.read_range(1))
        with pytest.raises(TypeError):
            src.materialize()
    finally:
        store.close()


@pytest.mark.timeout_s(120)
def test_async_writer_takes_many_chunks(tmp_path):
    """More async chunks than the writer's queue holds (12 > 8), each
    waited for: every one commits, and close reclaims the directory."""
    P = 10
    store = T.SpillStore(str(tmp_path / "sp"), P)
    store.set_bounds(T.plan_bounds(np.ones(P), 4))
    recs = [_mapped(seed=20 + i, P=P) for i in range(12)]
    done = threading.Event()

    def run():
        for m in recs:
            store.submit_chunk([m])
            store.wait_writes()
        done.set()

    t = threading.Thread(target=run, daemon=True)
    try:
        t.start()
        t.join(timeout=60)
        assert done.is_set(), "the async writer stopped taking chunks"
        assert store.n_chunks == 12
        got = np.zeros((P, 2), np.int64)
        for z in range(store.n_ranges):
            r = store.read_range(z)
            np.add.at(got, r["dest_eff"] + r["lo"],
                      r["payloads"][0][r["src"]].astype(np.int64))
        assert np.array_equal(got, _entry_sums(P, recs))
    finally:
        store.close()
    assert not (tmp_path / "sp").exists()


# ---------------------------------------------------------------------------
# The segment format: either package's segments load in the other
# ---------------------------------------------------------------------------

@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("skey", [False, True])
def test_segments_are_byte_identical_to_the_reference(tmp_path, skey):
    """The same chunks staged by both stores: every segment file has the
    same bytes (magic, header, field order, dtypes)."""
    P = 12
    recs = [_mapped(seed=7, P=P, skey=skey), _mapped(seed=8, n_rows=17, P=P,
                                                     skey=skey)]
    bounds = T.plan_bounds(np.ones(P), 3)
    ts = T.SpillStore(str(tmp_path / "t"), P)
    js = jspill.SpillStore(str(tmp_path / "j"), P)
    ts.set_bounds(bounds)
    js.set_bounds(bounds)
    try:
        tc = ts.stage_chunk(recs, "x")
        jc = js.stage_chunk([_as_jax(m) for m in recs], "x")
        assert tc.nbytes == jc.nbytes and len(tc.paths) == len(jc.paths)
        for (z, tpath), (jz, jpath) in zip(tc.paths, jc.paths):
            assert z == jz and os.path.basename(tpath) == \
                os.path.basename(jpath)
            assert open(tpath, "rb").read() == open(jpath, "rb").read(), z
    finally:
        ts.close()
        js.close()


@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segments_cross_read_bitwise(tmp_path, writer):
    """One package stages each chunk, the other commits it and reads every
    range back with ``read_range``: the arrays equal the writer's own
    read-back, bit for bit, with their dtypes."""
    P = 12
    recs = [_mapped(seed=9, P=P, skey=True), _mapped(seed=10, n_rows=31, P=P,
                                                     skey=True)]
    root = str(tmp_path / "sp")
    bounds = T.plan_bounds(np.ones(P), 4)
    ts, js = T.SpillStore(root, P), jspill.SpillStore(root, P)
    ts.set_bounds(bounds)
    js.set_bounds(bounds)
    own_root = str(tmp_path / "own")
    own = (T.SpillStore(own_root, P) if writer == "port"
           else jspill.SpillStore(own_root, P))
    own.set_bounds(bounds)
    try:
        for m in recs:
            if writer == "port":
                js.commit_chunk(ts.stage_chunk([m], ts.next_tag()))
                own.commit_chunk(own.stage_chunk([m], own.next_tag()))
            else:
                jm = _as_jax(m)
                ts.commit_chunk(js.stage_chunk([jm], js.next_tag()))
                own.commit_chunk(own.stage_chunk([jm], own.next_tag()))
        reader = js if writer == "port" else ts
        for z in range(len(bounds) - 1):
            _records_equal(reader.read_range(z), own.read_range(z))
    finally:
        for s in (ts, js, own):
            s.close()
    assert not os.path.exists(root)


# ---------------------------------------------------------------------------
# payload-only rows (keys == P) through the device shuffle
# ---------------------------------------------------------------------------

@pytest.mark.timeout_s(120)
@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_payload_only_rows_match_reference_shuffle(codec):
    """A mapped split with a few ``keys == P`` rows (payload-only border
    rows, as a spilled range's read-back carries) through both packages'
    ``shuffle_reduce_device``: equal totals and per-partition counts. The
    rows stay in the bucket entries that reference them and own nothing."""
    xyz = _catalog(4000, 4, False)
    radii, edges = _scaled(0.05)
    tjobs = _jobs(radii, edges, codec, 64, False)
    jjobs = _jobs(radii, edges, codec, 64, True)
    part = tjobs[0].partitioner
    P = int(part.n_partitions(xyz))
    m = tspill.mapped_to_host(T.map_split_device(
        part, T.get_codec(codec), xyz, P, torch.device("cpu")))
    m.keys[[0, 17, 1234, 3999]] = P
    got, tsd = T.shuffle_reduce_device(tjobs, _as_jax(
        m, T.MappedSplit, torch.as_tensor), P, T.StageStats(),
        torch.device("cpu"))
    want, jsd, _, _ = R.shuffle_reduce_device(jjobs, _as_jax(
        m, conv=jnp.asarray), P, JStageStats())
    for g, w in zip(got, want):
        assert np.asarray(g).tolist() == np.asarray(w).tolist()
    assert tsd.n_owned.tolist() == np.asarray(jsd.n_owned).tolist()
    assert tsd.n_bucket.tolist() == np.asarray(jsd.n_bucket).tolist()
    assert int(tsd.n_owned.sum()) == len(xyz) - 4


# ---------------------------------------------------------------------------
# e2e: spilled pair jobs against the JAX package
# ---------------------------------------------------------------------------

def _spill_pair(budget, codec, root_t, root_j, n_splits=6, clump=True,
                **kw):
    """The same spilled run in both packages, on a clumped catalog or on
    the uniform one of the JAX package's own spill tests. -> (port stats,
    JAX stats)."""
    xyz = _catalog(2500, 1, True) if clump else sky.make_catalog(2500, 0)
    radii, edges = _scaled(0.02)
    got = T.run_jobs_streaming(
        _jobs(radii, edges, codec, 64, False), tp.ArraySplits(xyz, n_splits),
        spill=T.SpillConfig(budget_bytes=budget, dir=str(root_t)),
        device="cpu", **kw)
    want = jexec.run_jobs_streaming(
        _jobs(radii, edges, codec, 64, True), jp.ArraySplits(xyz, n_splits),
        engine="device",
        spill=R.SpillConfig(budget_bytes=budget, dir=str(root_j)), **kw)
    mono = T.run_jobs(_jobs(radii, edges, codec, 64, False), xyz,
                      device="cpu")
    assert _outputs(got) == _outputs(want) == _outputs(mono)
    assert not os.path.exists(root_t) and not os.path.exists(root_j)
    return got[0].stats, want[0].stats


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("case", ["clumped", "uniform"])
@pytest.mark.parametrize("budget", [0, 20_000, 10**12, None])
@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_spill_parity_over_budgets(tmp_path, codec, budget, case):
    """spill(budget) == the JAX package's spill(budget) == monolithic, for
    budget = 0 (spill everything), small (real out-of-core), roomy (never
    trips), None (disabled); the same spill accounting; spill dirs always
    reclaimed. Peak resident wire bytes stay <= budget + one chunk on the
    uniform catalog. On the clumped one a few partitions hold most rows,
    so a read-back range (one range in flight, one queued, one being
    read) can outweigh a chunk: both packages then exceed that bound by
    the same bytes (ROADMAP queue 3)."""
    st, jst = _spill_pair(budget, codec, tmp_path / "t", tmp_path / "j",
                          clump=case == "clumped")
    for f in ("spilled_splits", "spill_bytes", "spill_ranges",
              "spill_chunk_bytes"):
        assert getattr(st, f) == getattr(jst, f), f
    if budget in (None, 10**12):
        assert st.spilled_splits == 0 and st.spill_bytes == 0
    else:
        assert st.spilled_splits == 6
        assert st.spill_bytes > 0 and st.spill_ranges >= 1
        if case == "uniform":
            assert st.spill_peak_bytes <= budget + st.spill_chunk_bytes
        assert st.spill_wall_s > 0 and st.wall_s >= st.spill_wall_s
        assert len(st.tiers) >= st.spill_ranges


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_spill_lane_mode_parity(tmp_path, codec):
    """Lane mode spills at map time (each split stages its own chunk,
    commit under the pool lock): the JAX package's lanes and the port's
    agree, and equal monolithic."""
    st, jst = _spill_pair(10_000, codec, tmp_path / "t", tmp_path / "j",
                          n_lanes=3)
    assert st.spilled_splits == jst.spilled_splits == 6
    assert st.spill_ranges >= 1 and st.n_lanes == 3


@pytest.mark.timeout_s(300)
def test_more_sync_chunks_than_the_writer_queue(tmp_path):
    """Budget 0 over 12 splits: 12 chunks written one after another, more
    than the async writer's queue holds (the JAX package's writer stops
    taking chunks after its ninth here). Equal to monolithic."""
    xyz = _catalog(1200, 0, False)
    job = T.neighbor_search_job(0.02, tile=128)
    root = tmp_path / "sp"
    res = T.run_job_streaming(job, tp.ArraySplits(xyz, 12),
                              spill=T.SpillConfig(budget_bytes=0,
                                                  dir=str(root)),
                              device="cpu")
    assert res.output == T.run_job(job, xyz, device="cpu").output
    assert res.stats.spilled_splits == 12 and not root.exists()


@pytest.mark.timeout_s(300)
def test_spill_write_failure_reclaims_segments(tmp_path):
    xyz = _catalog(1200, 0, False)
    job = T.neighbor_search_job(0.02, tile=128)

    def die(path):
        raise OSError("spill disk died")

    root = tmp_path / "sp"
    cfg = T.SpillConfig(budget_bytes=0, dir=str(root), write_fault=die)
    with pytest.raises(OSError, match="spill disk died"):
        T.run_job_streaming(job, tp.ArraySplits(xyz, 4), spill=cfg,
                            device="cpu")
    assert not root.exists()


@pytest.mark.timeout_s(300)
def test_spill_dirs_reclaimed_on_every_exit_path(tmp_path, monkeypatch):
    """The default spill root is a fresh temp dir. After a run that
    succeeds, one whose write faults, one whose speculative clone is
    cancelled and one that misses its deadline, the temp dir holds
    nothing."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    xyz = _catalog(1200, 0, False)
    job = T.neighbor_search_job(0.02, tile=128)
    want = T.run_job(job, xyz, device="cpu").output

    def run(src, **kw):
        return T.run_job_streaming(job, src, device="cpu", **kw)

    res = run(tp.ArraySplits(xyz, 4), spill=0)
    assert res.output == want and res.stats.spilled_splits == 4
    assert os.listdir(tmp) == []

    def die(path):
        raise OSError("spill disk died")

    with pytest.raises(OSError, match="spill disk died"):
        run(tp.ArraySplits(xyz, 4),
            spill=T.SpillConfig(budget_bytes=0, write_fault=die))
    assert os.listdir(tmp) == []
    with pytest.raises(OSError, match="spill disk died"):
        run(tp.ArraySplits(xyz, 4), n_lanes=2,
            spill=T.SpillConfig(budget_bytes=0, write_fault=die))
    assert os.listdir(tmp) == []

    src = _CloneLoses(tp.ArraySplits(xyz, 6))
    pol = SpeculativePolicy(SpeculativeConfig(slowdown=2.0, min_finished=2,
                                              max_clones=1))
    res = run(src, n_lanes=2, speculate=pol, spill=0)
    assert res.output == want and res.stats.speculated >= 1
    assert res.stats.clone_wins == 0 and src.calls == 2
    assert os.listdir(tmp) == []

    slow = FaultySplitSource(tp.ArraySplits(xyz, 4), delays={0: STALL_S})
    with pytest.raises(T.JobDeadlineExceeded, match=r"splits \[0\]"):
        run(slow, n_lanes=2, deadline_s=10.0, spill=0)
    assert os.listdir(tmp) == []


@pytest.mark.timeout_s(120)
def test_spill_requires_device_engine_and_ignores_combine():
    xyz = _catalog(400, 0, False)
    job = T.neighbor_search_job(0.02, tile=128)
    with pytest.raises(ValueError, match="device engine"):
        T.run_job_streaming(job, tp.ArraySplits(xyz, 2), engine="host",
                            spill=0, device="cpu")
    toks = (np.arange(1500) % 53).astype(np.float32).reshape(-1, 1)
    wjob = T.token_histogram_job(53)
    want = T.run_job(wjob, toks, device="cpu").output
    res = T.run_job_streaming(wjob, tp.ArraySplits(toks, 3), spill=0,
                              device="cpu")
    assert np.array_equal(res.output, want)
    assert res.stats.spilled_splits == 0 and res.stats.combiner


def test_mapped_wire_nbytes_counts_all_fields():
    m = _mapped(seed=7, skey=True)
    n = T.mapped_wire_nbytes(m)
    assert n == (m.payloads[0].nbytes + m.keys.nbytes + m.dest_eff.nbytes
                 + m.src.nbytes + m.skey.nbytes)
    assert n == R.mapped_wire_nbytes(_as_jax(m))
    assert T.mapped_wire_nbytes(_as_jax(m, T.MappedSplit,
                                        torch.as_tensor)) == n


# hypothesis property: random budgets AND random split boundaries; the
# spill cut points and the split cut points are both adversarial inputs.
try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @pytest.mark.timeout_s(600)
    @settings(max_examples=5, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 2**16), n_cuts=st.integers(0, 5),
           budget_kb=st.integers(0, 64))
    def test_property_spill_parity(seed, n_cuts, budget_kb):
        rng = np.random.default_rng(seed)
        xyz = _catalog(800, seed % 7, False)
        job = T.neighbor_search_job(0.02, tile=128)
        want = T.run_job(job, xyz, device="cpu").output
        bounds = sorted(int(b) for b in rng.integers(0, len(xyz), n_cuts))
        res = T.run_job_streaming(
            job, tp.ArraySplits(xyz, boundaries=bounds),
            spill=float(budget_kb) * 1024, device="cpu")
        assert res.output == want, (seed, bounds, budget_kb)
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_property_spill_parity():
        pass
