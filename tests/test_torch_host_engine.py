"""The port's host engine, wordcount and legacy surface held against the
JAX package's.

- ``shuffle_stage`` must return the JAX package's ``ShuffledData`` arrays
  exactly, rows in the same order, for every codec.
- The port's host engine on the CPU must equal a JAX reduce of the JAX
  package's own ``ShuffledData`` through its plain refs called eagerly
  (``_jax_eager_totals``). The JAX host engine itself reduces under
  ``lax.map``, which the CPU compiler contracts to FMAs (ROADMAP queue 3),
  so it is used only where outputs are integers that sit on no float
  threshold (wordcount) or for shape-only accounting.
- The port's two engines must agree exactly for the exact codecs.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.mapreduce as R  # noqa: E402
from repro.kernels.zones_pairs import ref as jref  # noqa: E402
from repro.mapreduce import job as jjob  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from test_torch_cases import clumped_catalog  # noqa: E402

ARCSEC = sky.ARCSEC

# name: (n, seed, clump, radius, tile, pad_partitions_to)
CASES = {
    "random": (3000, 0, False, 0.05, 64, 1),
    "clumped": (2500, 1, True, 0.02, 64, 8),
    "empty": (0, 2, False, 0.05, 64, 1),
    "single": (1, 3, False, 0.02, 32, 4),
    "arcsec": (20_000, 4, False, 60 * ARCSEC, 64, 1),
}
SD_FIELDS = ("owned", "bucket", "n_owned", "n_bucket")


def _assert_same_sd(got, want):
    for f in SD_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=f)


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_shuffle_stage_matches_jax(case, codec):
    n, seed, clump, radius, tile, pad = CASES[case]
    xyz = clumped_catalog(n, seed, clump)
    jst, tst = R.StageStats(), T.StageStats()
    want = jjob.shuffle_stage(xyz, R.ZonePartitioner(radius), codec,
                              tile=tile, pad_partitions_to=pad, stats=jst)
    got = T.shuffle_stage(xyz, T.ZonePartitioner(radius), codec, tile=tile,
                          pad_partitions_to=pad, stats=tst, device="cpu")
    _assert_same_sd(got, want)
    for f in ("shuffle_wire_bytes", "shuffle_raw_bytes", "n_items",
              "n_partitions", "map_bytes", "codec", "engine",
              "shuffle_index_impl"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert got.pair_cells == want.pair_cells
    assert got.owned_cells == want.owned_cells
    assert got.padded_ratio == want.padded_ratio


@pytest.mark.parametrize("codec", ["identity", "int16"])
def test_wordcount_shuffle_stage_matches_jax(codec):
    toks = np.random.default_rng(4).integers(0, 900, 5000).astype(np.float32)
    tjob_, jjob_ = (T.token_histogram_job(900, codec=codec, tile=64),
                    R.token_histogram_job(900, codec=codec, tile=64))
    want = jjob.shuffle_stage(toks, jjob_.partitioner, jjob_.codec, tile=64,
                              pad_value=-1.0)
    got = T.shuffle_stage(toks, tjob_.partitioner, tjob_.codec, tile=64,
                          pad_value=-1.0, device="cpu")
    _assert_same_sd(got, want)


@pytest.mark.parametrize("seed,radius,clump", [
    (0, 0.05, False), (1, 0.02, True), (2, 0.3, False), (3, 60 * ARCSEC,
                                                          False)])
def test_zone_replicas_match_jax(seed, radius, clump):
    """Same arrays in the same order, from one sort in place of a
    ``keys == k`` scan per zone."""
    xyz = clumped_catalog(3000, seed, clump)
    tp, jp = T.ZonePartitioner(radius), R.ZonePartitioner(radius)
    keys = jp.assign(xyz)
    np.testing.assert_array_equal(tp.assign(xyz), keys)
    P = jp.n_partitions(xyz)
    got = list(tp.replicas(xyz, keys, P))
    want = list(jp.replicas(xyz, keys, P))
    assert [d for d, _ in got] == [d for d, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_hash_partitioner_matches_jax():
    items = np.random.default_rng(0).integers(-50, 5000, (999, 2)
                                              ).astype(np.float32)
    tp, jp = T.HashPartitioner(7), R.HashPartitioner(7)
    np.testing.assert_array_equal(tp.assign(items), jp.assign(items))
    np.testing.assert_array_equal(
        tp.assign_device(torch.as_tensor(items)).numpy(),
        np.asarray(jp.assign_device(jnp.asarray(items))))
    assert list(tp.replicas(items, tp.assign(items), 7)) == []


# ---------------------------------------------------------------------------
# host engine == the reference's eager reduce of its own ShuffledData
# ---------------------------------------------------------------------------

def _jax_eager_totals(sd, reducers, chunk: int = 512):
    """The JAX package's reduce of its own ``ShuffledData``, partition by
    partition in chunks, through its plain refs called eagerly: every cell
    of every partition, padding included, as its host engine's
    ``lax.map(per_partition)`` + sum reads them."""
    P, C1, C2 = sd.owned.shape[0], sd.owned.shape[1], sd.bucket.shape[1]
    totals = []
    for r in reducers:
        total = 0
        for lo in range(0, P, chunk):
            hi = min(lo + chunk, P)
            a, b = jnp.asarray(sd.owned[lo:hi]), jnp.asarray(sd.bucket[lo:hi])
            na = jnp.full(hi - lo, C1, jnp.int32)
            nb = jnp.full(hi - lo, C2, jnp.int32)
            if isinstance(r, R.PairCountReducer):
                total += int(jref.pair_count_masked_ref(
                    a, b, na, nb, float(np.cos(r.radius))))
            else:
                total += np.asarray(jref.pair_hist_masked_ref(
                    a, b, na, nb, r._cos_edges()), np.int64)
        totals.append(total)
    return totals


def _zone_jobs(lib, radii, edges_arcsec, codec, tile):
    part = lib.ZonePartitioner(radii[-1])
    return ([lib.neighbor_search_job(r, partitioner=part, codec=codec,
                                     tile=tile) for r in radii]
            + [lib.neighbor_statistics_job(edges_arcsec, partitioner=part,
                                           codec=codec, tile=tile)])


def _outputs(results):
    return [np.asarray(r.output).tolist() for r in results]


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
@pytest.mark.parametrize("scale", ["arcsec", "0.05rad"])
def test_host_engine_matches_eager_jax_reduce(scale, codec):
    if scale == "arcsec":     # the paper's 15/30/60" over 60" zones
        xyz = sky.make_catalog(20_000, 6)
        radii = tuple(a * ARCSEC for a in (15, 30, 60))
        edges = T.DEFAULT_EDGES_ARCSEC
    else:
        xyz = clumped_catalog(2500, 7, True)
        radii = (0.025, 0.05)
        edges = np.linspace(0.0125, 0.05, 6) / ARCSEC
    jobs = _zone_jobs(R, radii, edges, codec, 64)
    sd = jjob.shuffle_stage(xyz, jobs[0].partitioner, codec, tile=64)
    want = [j.reducer.finalize(t, sd) for j, t in
            zip(jobs, _jax_eager_totals(sd, [j.reducer for j in jobs]))]
    got = T.run_jobs(_zone_jobs(T, radii, edges, codec, 64), xyz,
                     engine="host", device="cpu")
    assert _outputs(got) == [np.asarray(w).tolist() for w in want]
    st = got[0].stats
    assert (st.engine, st.device, st.codec) == ("host", "cpu", codec)
    assert st.reduce_padded_ratio == sd.padded_ratio
    assert st.reduce_bytes == sd.owned.nbytes + sd.bucket.nbytes
    assert st.n_items == len(xyz)
    assert st.tiers == ((sd.owned.shape[0], sd.owned.shape[1],
                         sd.bucket.shape[1]),)


@pytest.mark.parametrize("codec", ["identity", "int16"])
@pytest.mark.parametrize("case", ["random", "clumped", "empty", "single"])
def test_host_engine_equals_device_engine(case, codec):
    """The JAX package's own engine parity (tests/test_mapreduce_job.py:147),
    for the port's two engines."""
    n, seed, clump, radius, tile, _ = CASES[case]
    xyz = clumped_catalog(n, seed, clump)
    jobs = _zone_jobs(T, (radius / 2, radius),
                      np.linspace(radius / 4, radius, 5) / ARCSEC, codec,
                      tile)
    host = T.run_jobs(jobs, xyz, engine="host", device="cpu")
    dev = T.run_jobs(jobs, xyz, engine="device", device="cpu")
    assert _outputs(host) == _outputs(dev)
    assert host[0].stats.engine == "host" and dev[0].stats.engine == "device"
    assert host[0].stats.shuffle_wire_bytes == dev[0].stats.shuffle_wire_bytes
    if n > 100 and codec == "identity":
        assert host[1].output == sky.brute_force_pairs(xyz, radius)


def test_host_engine_stats_match_jax_host_engine():
    """Shape-only accounting against the JAX host engine itself."""
    xyz = sky.make_catalog(1500, 9)
    jobs_j = [R.neighbor_search_job(0.07, codec="int16", tile=64)]
    jobs_t = [T.neighbor_search_job(0.07, codec="int16", tile=64)]
    want = R.run_jobs(jobs_j, xyz, engine="host")[0].stats
    got = T.run_jobs(jobs_t, xyz, engine="host", device="cpu")[0].stats
    for f in ("n_items", "n_partitions", "map_bytes", "shuffle_wire_bytes",
              "shuffle_raw_bytes", "reduce_bytes", "reduce_flops",
              "reduce_padded_ratio", "engine", "codec", "shuffle_index_impl"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.compression_ratio == want.compression_ratio


# ---------------------------------------------------------------------------
# zone maps: the host engine's numpy arcsin against the device engines' asin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arcsec", [15, 30, 60])
def test_zone_maps_differ_only_at_zone_edges(arcsec):
    """The host engine's zone keys (numpy's ``arcsin``), the JAX device
    engine's (XLA's ``asin``, called eagerly as its map stage does) and the
    port's device keys (torch's ``asin``) disagree on a few of 2^20 points,
    each by one zone and each at a zone edge."""
    xyz = sky.make_catalog(1 << 20, 0)
    jp, tp = R.ZonePartitioner(arcsec * ARCSEC), T.ZonePartitioner(
        arcsec * ARCSEC)
    host = jp.assign(xyz)
    np.testing.assert_array_equal(tp.assign(xyz), host)
    jax_dev = np.asarray(jp.assign_device(jnp.asarray(xyz)))
    port_dev = tp.assign_device(torch.as_tensor(xyz)).numpy()
    zone = (np.arcsin(np.clip(xyz[:, 2].astype(np.float64), -1, 1))
            + np.pi / 2) / jp.height
    edge_dist = np.abs(zone - np.round(zone))
    for got, want in ((jax_dev, host), (port_dev, jax_dev), (port_dev, host)):
        moved = got != want
        assert np.abs(got.astype(np.int64) - want).max() <= 1
        assert moved.sum() < len(xyz) // 1000
        assert edge_dist[moved].max(initial=0.0) < 0.01
    assert (jax_dev != host).any()      # the reference's own engines split


def test_jax_engines_agree_only_on_one_zone_map():
    """At 2^18 objects and 60" zones the JAX package's host and device
    engines give different searches, because their zone maps differ; with
    the host's keys fed to the device map the two agree exactly."""
    xyz = sky.make_catalog(1 << 18, 0)
    radii = [a * ARCSEC for a in (15, 30, 60)]

    class HostKeyedZones(R.ZonePartitioner):
        assign_device = jjob.Partitioner.assign_device

    def search(part, engine):
        jobs = [R.neighbor_search_job(r, partitioner=part) for r in radii]
        return [r.output for r in R.run_jobs(jobs, xyz, engine=engine)]

    host = search(R.ZonePartitioner(radii[-1]), "host")
    assert search(HostKeyedZones(radii[-1]), "device") == host
    assert search(R.ZonePartitioner(radii[-1]), "device") != host


# ---------------------------------------------------------------------------
# wordcount and custom reducers on both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["identity", "int16"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_token_histogram_matches_jax(codec, engine):
    toks = np.random.default_rng(5).integers(0, 900, 6000)
    toks[:5] = [-3, 900, 950, 0, 899]              # out of vocab, both edges
    got = T.token_histogram(toks, 900, codec=codec, tile=64, engine=engine,
                            device="cpu")
    want = R.token_histogram(toks, 900, codec=codec, tile=64, engine=engine)
    ok = toks[(toks >= 0) & (toks < 900)]
    np.testing.assert_array_equal(got.output, np.bincount(ok, minlength=900))
    np.testing.assert_array_equal(got.output, want.output)
    assert got.output.dtype == np.int64
    st = got.stats
    assert st.engine == engine and st.n_partitions == 8
    assert st.shuffle_wire_bytes == want.stats.shuffle_wire_bytes
    assert st.reduce_flops == want.stats.reduce_flops


@pytest.mark.parametrize("engine", ["host", "device"])
def test_weighted_token_rows_match_jax(engine):
    """A second column is an integer weight: (token, count) rows."""
    rng = np.random.default_rng(6)
    items = np.stack([rng.integers(0, 300, 800), rng.integers(1, 40, 800)],
                     axis=1).astype(np.float32)
    tj = T.MapReduceJob("wc", T.HashPartitioner(4),
                        T.TokenHistogramReducer(300), tile=64)
    jj = R.MapReduceJob("wc", R.HashPartitioner(4),
                        R.TokenHistogramReducer(300), tile=64)
    got = T.run_job(tj, items, engine=engine, device="cpu").output
    want = R.run_job(jj, items, engine=engine).output
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.bincount(
        items[:, 0].astype(int), weights=items[:, 1],
        minlength=300).astype(np.int64))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_custom_reducer_runs_default_reduce_paths(engine):
    """A reducer that only defines ``per_partition`` runs through the
    default ``per_partition_sum`` (host) and the default masked
    ``reduce_partitions`` (device), as in tests/test_mapreduce_job.py."""

    class SumSquares(T.Reducer):
        def per_partition(self, owned_p, bucket_p):
            return torch.sum(owned_p[:, 0].double() ** 2)

    vals = np.arange(1, 501, dtype=np.float32)
    job = T.MapReduceJob("sumsq", T.HashPartitioner(4), SumSquares(),
                         tile=32)
    got = float(T.run_job(job, vals, engine=engine, device="cpu").output)
    assert got == float(np.sum(vals.astype(np.float64) ** 2))


# ---------------------------------------------------------------------------
# legacy surface
# ---------------------------------------------------------------------------

def test_deprecated_wrappers_match_jax_and_dense_oracle():
    for seed, n, radius in [(0, 300, 0.05), (1, 500, 0.1), (2, 200, 0.2)]:
        xyz = sky.make_catalog(n, seed)
        with pytest.warns(DeprecationWarning):
            got = T.neighbor_search_count(xyz, radius, tile=64, device="cpu")
        pairs = T.neighbor_pairs_dense(xyz, radius)
        np.testing.assert_array_equal(pairs, R.neighbor_pairs_dense(xyz,
                                                                    radius))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert got == len(pairs) == R.neighbor_search_count(xyz, radius,
                                                                tile=64)
            assert T.neighbor_search_count(
                xyz, radius, tile=64, compress_coords=True, device="cpu") == \
                T.run_job(T.neighbor_search_job(radius, codec="int16",
                                                tile=64), xyz,
                          device="cpu").output
    xyz = sky.make_catalog(400, 5)
    edges_rad = np.linspace(0.02, 0.12, 6)
    with pytest.warns(DeprecationWarning):
        h = T.neighbor_statistics(xyz, edges_arcsec=edges_rad / ARCSEC,
                                  tile=64, device="cpu")
    np.testing.assert_array_equal(
        h, sky.brute_force_hist(xyz, np.concatenate([[0], edges_rad])))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        np.testing.assert_array_equal(h, R.neighbor_statistics(
            xyz, edges_arcsec=edges_rad / ARCSEC, tile=64))


@pytest.mark.parametrize("compress", [False, True])
def test_bucket_by_zone_and_sharded_zone_reduce_match_jax(compress):
    xyz = sky.make_catalog(2000, 5)
    got = T.bucket_by_zone(xyz, 0.05, tile=64, compress_coords=compress,
                           pad_zones_to=4, device="cpu")
    want = R.bucket_by_zone(xyz, 0.05, tile=64, compress_coords=compress,
                            pad_zones_to=4)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    # an integer per-zone function that sits on no float threshold
    n_north = T.sharded_zone_reduce(lambda o, b: (b[:, 2] > 0).sum(), got,
                                    device="cpu")
    want_n = R.sharded_zone_reduce(lambda o, b: jnp.sum(b[:, 2] > 0), want)
    assert int(n_north) == int(want_n) > 0


def test_host_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xyz = sky.make_catalog(200, 0)
    part = T.ZonePartitioner(0.05)
    job = T.neighbor_search_job(0.05)
    sd = T.shuffle_stage(xyz, part, device="cpu")
    toks = np.arange(100)
    zd = T.bucket_by_zone(xyz, 0.05, device="cpu")
    calls = [
        lambda: T.run_jobs([job], xyz, engine="host"),
        lambda: T.run_job(job, xyz, engine="host"),
        lambda: T.shuffle_stage(xyz, part),
        lambda: T.reduce_stage([job.reducer], sd),
        lambda: T.host_shuffle_reduce([job], xyz, T.StageStats()),
        lambda: T.token_histogram(toks, 100),
        lambda: T.token_histogram(toks, 100, engine="host"),
        lambda: T.neighbor_search_count(xyz, 0.05),
        lambda: T.neighbor_statistics(xyz, edges_arcsec=[10.0, 20.0]),
        lambda: T.bucket_by_zone(xyz, 0.05),
        lambda: T.sharded_zone_reduce(lambda o, b: o.sum(), zd),
    ]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    totals = T.reduce_stage([job.reducer], sd, device="cpu")
    assert totals[0].device.type == "cpu"
