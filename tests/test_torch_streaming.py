"""The port's split-streaming executor against the JAX package's, on the CPU.

The same catalogs (numpy seeds), cut into the same ``ArraySplits``, go
through ``repro_torch.mapreduce.run_jobs_streaming(..., device="cpu")`` and
through ``repro.mapreduce.executor.run_jobs_streaming``; every count and
histogram must be equal, and equal to the port's monolithic ``run_jobs``.
The JAX run reduces through the plain references of its Pallas kernels,
called eagerly (``_EagerCount``/``_EagerHist`` of ``test_torch_mapreduce``):
the rounded score formulation both packages document.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.mapreduce as R  # noqa: E402
from repro.data import pipeline as jp  # noqa: E402
from repro.mapreduce import executor as jexec  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import pipeline as tp  # noqa: E402
from repro_torch.ft import SpeculativePolicy, StragglerMonitor  # noqa: E402
from test_torch_mapreduce import (CASES, _catalog, _jobs,  # noqa: E402
                                  _outputs, _scaled)

STREAM_CASES = ("random", "clumped", "empty")


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
@pytest.mark.parametrize("n_splits", [1, 3, 7])
@pytest.mark.parametrize("case", STREAM_CASES)
def test_streamed_matches_jax_and_monolithic(case, n_splits, codec):
    """Search at two radii plus statistics, streamed: the JAX package's
    streamed outputs, the port's streamed outputs and the port's monolithic
    ones are all equal, at any split boundary and for every codec (the
    device int8 codec scales per row, so it is split-independent)."""
    n, seed, clump, radius = CASES[case]
    xyz = _catalog(n, seed, clump)
    radii, edges = _scaled(radius)
    want = jexec.run_jobs_streaming(_jobs(radii, edges, codec, 64, True),
                                    jp.ArraySplits(xyz, n_splits),
                                    engine="device")
    got = T.run_jobs_streaming(_jobs(radii, edges, codec, 64, False),
                               tp.ArraySplits(xyz, n_splits), device="cpu")
    mono = T.run_jobs(_jobs(radii, edges, codec, 64, False), xyz,
                      device="cpu")
    assert _outputs(got) == _outputs(want) == _outputs(mono)
    st = got[0].stats
    assert st.n_splits == want[0].stats.n_splits == min(n_splits, max(n, 1))
    assert len(st.splits) == st.n_splits and st.combiner == ""
    assert st.n_items == n and st.map_bytes == xyz.nbytes
    assert st.shuffle_wire_bytes == want[0].stats.shuffle_wire_bytes
    assert st.shuffle_wire_bytes == mono[0].stats.shuffle_wire_bytes
    assert st.device == "cpu" and st.codec == codec


@pytest.mark.timeout_s(300)
def test_run_jobs_is_the_one_split_case():
    """``run_jobs`` runs the executor over one ``ArraySplits`` split with no
    prefetch and no combiner: the same outputs and the same accounting."""
    xyz = _catalog(2500, 1, True)
    radii, edges = _scaled(0.02)
    mono = T.run_jobs(_jobs(radii, edges, "int16", 64, False), xyz,
                      device="cpu")
    one = T.run_jobs_streaming(_jobs(radii, edges, "int16", 64, False),
                               tp.ArraySplits(xyz, 1), prefetch=0,
                               combiner=None, device="cpu")
    assert _outputs(mono) == _outputs(one)
    a, b = mono[0].stats, one[0].stats
    for f in ("n_items", "n_partitions", "map_bytes", "shuffle_wire_bytes",
              "shuffle_raw_bytes", "reduce_bytes", "reduce_flops",
              "reduce_padded_ratio", "tiers", "n_splits", "combiner",
              "engine", "codec", "device", "shuffle_index_impl"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.n_splits == 1 and len(a.splits) == 1 and a.overlap_hidden_s == 0


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("engine", ["device", "host"])
def test_prefetch_on_equals_off(engine):
    xyz = _catalog(3000, 0, False)
    radii, edges = _scaled(0.05)
    runs = {p: T.run_jobs_streaming(_jobs(radii, edges, "identity", 64,
                                          False),
                                    tp.ArraySplits(xyz, 5), engine=engine,
                                    prefetch=p, device="cpu")
            for p in (0, 1, 3)}
    assert _outputs(runs[0]) == _outputs(runs[1]) == _outputs(runs[3])
    for st in (r[0].stats for r in runs.values()):
        assert st.n_splits == 5 and st.engine == engine
        assert [r["split"] for r in st.splits] == list(range(5))
        assert st.fetch_wall_s >= 0 and st.overlap_hidden_s >= 0
        assert 0.0 <= st.overlap_fraction <= 1.0
    assert runs[0][0].stats.overlap_hidden_s == 0.0


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("codec", ["identity", "int16"])
def test_host_engine_equals_device_engine_on_one_zone_map(codec):
    """Streamed host engine == streamed device engine when the device map
    takes its zone keys from the host's ``assign`` (numpy's arcsin; torch's
    asin may move a point at a zone edge), and == the host engine's own
    monolithic run."""

    class HostKeyedZones(T.ZonePartitioner):
        assign_device = T.Partitioner.assign_device

    xyz = _catalog(3000, 0, False)
    radii, edges = _scaled(0.05)
    part = HostKeyedZones(radii[-1])

    def jobs():
        return ([T.neighbor_search_job(r, partitioner=part, codec=codec,
                                       tile=64) for r in radii]
                + [T.neighbor_statistics_job(edges, partitioner=part,
                                             codec=codec, tile=64)])

    host = T.run_jobs_streaming(jobs(), tp.ArraySplits(xyz, 4),
                                engine="host", device="cpu")
    dev = T.run_jobs_streaming(jobs(), tp.ArraySplits(xyz, 4),
                               engine="device", device="cpu")
    mono = T.run_jobs(jobs(), xyz, engine="host", device="cpu")
    assert _outputs(host) == _outputs(dev) == _outputs(mono)
    assert host[0].stats.engine == "host" and host[0].stats.n_splits == 4


def _token_sources(n_rows=40, seq_len=50, vocab=89, n_splits=5):
    """The same token splits from both packages' sources."""
    return (tp.TokenBlockSplits(tp.SyntheticTokens(vocab, seed=4), seq_len,
                                n_rows // n_splits, n_splits),
            jp.TokenBlockSplits(jp.SyntheticTokens(vocab, seed=4), seq_len,
                                n_rows // n_splits, n_splits))


@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("engine", ["device", "host"])
def test_wordcount_combiner_matches_jax_and_bincount(engine):
    vocab = 89
    src_t, src_j = _token_sources(vocab=vocab)
    want = np.bincount(src_t.materialize().reshape(-1).astype(np.int64),
                       minlength=vocab)
    stats = {}
    for comb in ("auto", None):
        got = T.run_job_streaming(T.token_histogram_job(vocab), src_t,
                                  engine=engine, combiner=comb, device="cpu")
        ref = jexec.run_job_streaming(R.token_histogram_job(vocab), src_j,
                                      engine=engine, combiner=comb)
        np.testing.assert_array_equal(got.output, want)
        np.testing.assert_array_equal(ref.output, want)
        assert got.stats.combiner == ref.stats.combiner
        assert got.stats.n_items == src_t.materialize().shape[0]
        stats[comb] = (got.stats, ref.stats)
    assert stats["auto"][0].combiner == "token_count"
    assert stats["auto"][0].combine_wall_s > 0
    (on_t, on_j), (off_t, off_j) = stats["auto"], stats[None]
    ratio_t = off_t.shuffle_wire_bytes / on_t.shuffle_wire_bytes
    ratio_j = off_j.shuffle_wire_bytes / on_j.shuffle_wire_bytes
    assert ratio_t == ratio_j and ratio_t >= 2


@pytest.mark.timeout_s(300)
def test_wordcount_auto_needs_an_exact_codec():
    """"auto" derives no combiner for the lossy int16 codec (a count can
    leave the codec's domain); the run is still exact."""
    vocab = 89
    src_t, _ = _token_sources(vocab=vocab)
    res = T.run_job_streaming(T.token_histogram_job(vocab, codec="int16"),
                              src_t, combiner="auto", device="cpu")
    assert res.stats.combiner == ""
    np.testing.assert_array_equal(res.output, np.bincount(
        src_t.materialize().reshape(-1).astype(np.int64), minlength=vocab))


@pytest.mark.timeout_s(300)
def test_split_records_feed_the_straggler_monitor():
    xyz = _catalog(2500, 1, True)
    radii, edges = _scaled(0.02)
    mon = StragglerMonitor(list(range(6)))
    pol = SpeculativePolicy()
    for monitor in (mon, pol):
        res = T.run_jobs_streaming(_jobs(radii, edges, "identity", 64,
                                         False),
                                   tp.ArraySplits(xyz, 6),
                                   straggler_monitor=monitor, device="cpu")
    st = res[0].stats
    assert [r["split"] for r in st.splits] == list(range(6))
    for r in st.splits:
        assert set(r) >= {"n_items", "fetch_wait_s", "fetch_prep_s", "map_s",
                          "shuffle_s", "reduce_s", "wall_s"}
        assert r["wall_s"] >= r["map_s"] >= 0
    assert sum(r["n_items"] for r in st.splits) == len(xyz)
    assert sorted(mon.track.by_key) == list(range(6))
    assert pol.walls == [r["wall_s"] for r in st.splits]


@pytest.mark.timeout_s(120)
def test_bad_combiner_and_spill_are_refused():
    xyz = _catalog(300, 0, False)
    job = T.neighbor_search_job(0.05, tile=64)
    with pytest.raises(ValueError, match="combiner must be"):
        T.run_job_streaming(job, tp.ArraySplits(xyz, 2), combiner="sum",
                            device="cpu")
    with pytest.raises(ValueError, match="device engine"):
        T.run_job_streaming(job, tp.ArraySplits(xyz, 2), engine="host",
                            spill=1 << 20, device="cpu")
    # n_ranges="auto" asks the cost model (equal outputs: the cost-model
    # tests); a typo in it is refused where the count is used
    with pytest.raises(ValueError):
        T.run_job_streaming(job, tp.ArraySplits(xyz, 2),
                            spill=T.SpillConfig(budget_bytes=0,
                                                n_ranges="auot"),
                            device="cpu")
    with pytest.raises(ValueError, match="engine"):
        T.run_job_streaming(job, tp.ArraySplits(xyz, 2), engine="mesh",
                            device="cpu")
    # a pair job has no combiner: "auto" accumulates the shuffle instead
    res = T.run_job_streaming(job, tp.ArraySplits(xyz, 2), device="cpu")
    assert res.stats.combiner == ""
    assert res.output == T.run_job(job, xyz, device="cpu").output


@pytest.mark.timeout_s(120)
def test_streaming_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xyz = _catalog(300, 0, False)
    job = T.neighbor_search_job(0.05, tile=64)
    for kw in ({}, {"n_lanes": 2}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.run_job_streaming(job, tp.ArraySplits(xyz, 2), **kw)
