"""The port's device engine held against the JAX package's, end to end.

Same catalogs (numpy seeds) through ``repro_torch.mapreduce.run_jobs(...,
device="cpu")`` and through ``repro.mapreduce.run_jobs(...,
engine="device")``; every count and histogram must be equal. The JAX run
reduces through the plain references of its Pallas kernels, called eagerly
(``_EagerCount``/``_EagerHist``): that is the rounded score formulation the
JAX package documents and the port implements. Its stock CPU reduce (the
jitted z-banded blocked engine) is contracted to FMAs by the compiler and
moves pairs that sit on a threshold, which at the paper's arcsecond radii is
nearly every pair.

Zone assignment goes through ``arcsin``, which differs in the last bit
between frameworks, so per-partition counts may differ; pair outputs may
not. Assignment is checked with the coverage property instead.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.mapreduce as R  # noqa: E402
from repro.kernels.zones_pairs import ref as jref  # noqa: E402
from repro.mapreduce import job as jjob  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.mapreduce import job as tjob  # noqa: E402
from test_torch_cases import clumped_catalog as _catalog  # noqa: E402

ARCSEC = sky.ARCSEC


@dataclasses.dataclass(frozen=True)
class _EagerCount(R.PairCountReducer):
    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        return jref.pair_count_masked_ref(owned, bucket, n_owned, n_bucket,
                                          float(np.cos(self.radius)))


@dataclasses.dataclass(frozen=True)
class _EagerHist(R.PairHistReducer):
    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        return jref.pair_hist_masked_ref(owned, bucket, n_owned, n_bucket,
                                         self._cos_edges())


def _jobs(radii, edges_arcsec, codec, tile, jax_side: bool):
    """Search at each radius plus statistics over one ZonePartitioner."""
    if jax_side:
        part = R.ZonePartitioner(radii[-1])
        jobs = [R.MapReduceJob("neighbor_search", part, _EagerCount(r),
                               codec=codec, tile=tile) for r in radii]
        edges = tuple(float(e) * ARCSEC for e in edges_arcsec)
        return jobs + [R.MapReduceJob("neighbor_statistics", part,
                                      _EagerHist(edges), codec=codec,
                                      tile=tile)]
    part = T.ZonePartitioner(radii[-1])
    return ([T.neighbor_search_job(r, partitioner=part, codec=codec,
                                   tile=tile) for r in radii]
            + [T.neighbor_statistics_job(edges_arcsec, partitioner=part,
                                         codec=codec, tile=tile)])


def _outputs(results):
    return [np.asarray(r.output).tolist() for r in results]


def _scaled(radius):
    return (radius / 2, radius), np.linspace(radius / 4, radius, 6) / ARCSEC


CASES = {
    "random": (3000, 0, False, 0.05),
    "clumped": (2500, 1, True, 0.02),
    "empty": (0, 2, False, 0.05),
    "single": (1, 3, False, 0.02),
}


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_run_jobs_matches_jax_device_engine(case, codec):
    n, seed, clump, radius = CASES[case]
    xyz = _catalog(n, seed, clump)
    radii, edges = _scaled(radius)
    want = R.run_jobs(_jobs(radii, edges, codec, 64, True), xyz,
                      engine="device")
    got = T.run_jobs(_jobs(radii, edges, codec, 64, False), xyz,
                     device="cpu")
    assert _outputs(got) == _outputs(want)
    st = got[0].stats
    assert st.device == "cpu" and st.engine == "device" and st.codec == codec
    assert st.n_items == n and st.compression_ratio == \
        want[0].stats.compression_ratio
    assert 1 <= len(st.tiers) <= 3


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_run_jobs_matches_jax_at_60_arcsec(codec):
    """The paper's real partitioner: 10,800 zones of 60", n = 50k, searches
    at 15/30/60" and the default 60-edge statistics."""
    xyz = sky.make_catalog(50_000, 4)
    radii = tuple(a * ARCSEC for a in (15, 30, 60))
    edges = T.DEFAULT_EDGES_ARCSEC
    want = R.run_jobs(_jobs(radii, edges, codec, 64, True), xyz,
                      engine="device")
    got = T.run_jobs(_jobs(radii, edges, codec, 64, False), xyz,
                     device="cpu")
    assert _outputs(got) == _outputs(want)
    cum = np.cumsum(got[-1].output)
    assert [r.output for r in got[:3]] == [int(cum[a - 1]) for a in (15, 30, 60)]


def test_small_search_equals_brute_force():
    xyz = sky.make_catalog(4000, 3)
    job = T.neighbor_search_job(0.05)
    assert T.run_job(job, xyz, device="cpu").output == \
        sky.brute_force_pairs(xyz, 0.05)


# ---------------------------------------------------------------------------
# state carried across: the reference's resident tiers reduced by the port
# ---------------------------------------------------------------------------

def _jax_catalog_to_numpy(cat, radius) -> dict:
    return {
        "P": cat.P, "codec": cat.codec.name, "tile": cat.tile,
        "pad_value": cat.pad_value, "zone_radius": radius,
        "zone_height": 0.0, "n_rows": cat.n_rows, "d": cat.d,
        "n_owned": np.asarray(cat.sd.n_owned),
        "n_bucket": np.asarray(cat.sd.n_bucket),
        "tiers": [{"part_ids": np.asarray(t.part_ids),
                   "owned_wire": tuple(np.asarray(w) for w in t.owned_wire),
                   "bucket_wire": tuple(np.asarray(w) for w in t.bucket_wire),
                   "n_owned": np.asarray(t.n_owned),
                   "n_bucket": np.asarray(t.n_bucket),
                   "C1": t.C1, "C2": t.C2, "Pt": t.Pt}
                  for t in cat.sd.tiers],
    }


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_catalog_from_numpy_runs_reference_tiers(codec):
    xyz = _catalog(2500, 5, True)
    radii, edges = _scaled(0.03)
    jax_jobs = _jobs(radii, edges, codec, 64, True)
    jcat = R.shuffle_once(jax_jobs[0].partitioner, xyz, codec=codec, tile=64)
    want = jcat.run(jax_jobs)
    cat = T.catalog_from_numpy(_jax_catalog_to_numpy(jcat, radii[-1]),
                               device="cpu")
    got = cat.run(_jobs(radii, edges, codec, 64, False))
    assert _outputs(got) == _outputs(want)
    assert cat.nbytes == jcat.nbytes
    # and back: the port's own catalog survives a numpy round trip
    own = T.shuffle_once(T.ZonePartitioner(radii[-1]), xyz, codec=codec,
                         tile=64, device="cpu")
    again = T.catalog_from_numpy(T.catalog_to_numpy(own), device="cpu")
    jobs = _jobs(radii, edges, codec, 64, False)
    assert _outputs(again.run(jobs)) == _outputs(own.run(jobs)) == \
        _outputs(want)


def test_catalog_from_numpy_rejects_bad_tiers():
    own = T.shuffle_once(T.ZonePartitioner(0.05), sky.make_catalog(500, 0),
                         tile=64, device="cpu")
    d = T.catalog_to_numpy(own)
    d["tiers"][0]["n_owned"] = d["tiers"][0]["n_owned"] + 10_000
    with pytest.raises(ValueError, match="n_owned"):
        T.catalog_from_numpy(d, device="cpu")
    d = T.catalog_to_numpy(own)
    d["tiers"][0]["owned_wire"] = ()
    with pytest.raises(ValueError, match="wire arrays"):
        T.catalog_from_numpy(d, device="cpu")


def test_resident_catalog_validates_signature():
    cat = T.shuffle_once(T.ZonePartitioner(0.05), sky.make_catalog(300, 0),
                         codec="int16", tile=64, device="cpu")
    with pytest.raises(ValueError, match="codec"):
        cat.run(T.neighbor_search_job(0.05, tile=64))
    with pytest.raises(ValueError, match="tile"):
        cat.run(T.neighbor_search_job(0.05, codec="int16"))
    with pytest.raises(ValueError, match="partitioner"):
        cat.run(T.neighbor_search_job(0.04, codec="int16", tile=64))


# ---------------------------------------------------------------------------
# codecs and tier planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["identity", "int16", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_device_transforms_bitwise_match_jax(name, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (997, 3)).astype(np.float32)
    # values whose scaled form lands on .5 (round half to even) and zeros
    x[:64, 0] = (np.arange(64) + 0.5) / 32767.0
    x[64:80] = 0.0
    x[80:96] = x[80:96] * 1e-20
    tc, jc = T.get_codec(name), R.get_codec(name)
    tw = tc.encode_device(torch.as_tensor(x))
    jw = jc.encode_device(jnp.asarray(x))
    assert len(tw) == len(jw)
    for t, j in zip(tw, jw):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                      j.view(np.uint8))
    back_t = tc.decode_device(*tw).numpy()
    back_j = np.asarray(jc.decode_device(*jw))
    np.testing.assert_array_equal(back_t.view(np.int32), back_j.view(np.int32))
    for d in (1, 2, 3, 4):
        assert tc.device_bytes_per_item(d) == jc.device_bytes_per_item(d)
    for n in (0, 1, 255, 256, 257, 10_000):
        assert tc.nbytes(n) == jc.nbytes(n)


@pytest.mark.parametrize("seed", range(40))
def test_plan_tiers_matches_reference(seed):
    rng = np.random.default_rng(seed)
    P = int(rng.integers(1, 400))
    n_b = rng.integers(0, 3000, P)
    if seed % 3 == 0:
        n_b[rng.integers(0, P, max(1, P // 20))] *= 20        # skew
    n_o = (n_b * rng.uniform(0.1, 0.5, P)).astype(np.int64)
    tile = int(rng.choice([16, 64, 256]))
    got = tjob.plan_tiers(n_o, n_b, tile)
    want = jjob.plan_tiers(n_o, n_b, tile)
    assert len(got) == len(want)
    for (gi, g1, g2), (wi, w1, w2) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert (g1, g2) == (w1, w2)


# ---------------------------------------------------------------------------
# partitioner coverage under REPLICA_EPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,radius,clump", [
    (0, 0.02, False), (1, 0.05, True), (2, 0.1, False), (3, 0.4, True),
    (4, 0.03, True), (5, 0.25, False), (6, 60 * ARCSEC, False),
    (7, 0.07, True)])
def test_zone_buckets_cover_every_within_radius_pair(seed, radius, clump):
    """For every pair within ``radius`` (f64 oracle), each endpoint's zone
    bucket contains the other, under the host ``replicas`` hook and under
    the device entry stream, whose valid set must be a superset of the host
    replica set (the margin may only ADD copies)."""
    n = 180 if radius > 1e-3 else 4000
    xyz = _catalog(n, seed, clump)
    if radius < 1e-3:                       # give 60" real neighbours
        rng = np.random.default_rng(seed)
        near = xyz[:200].astype(np.float64) + rng.normal(0, 1e-4, (200, 3))
        xyz[200:400] = near / np.linalg.norm(near, axis=1, keepdims=True)
    part = T.ZonePartitioner(radius)
    P = part.n_partitions(xyz)
    keys = part.assign(xyz)
    assert keys.min() >= 0 and keys.max() < P
    buckets = [set(np.flatnonzero(keys == k)) for k in range(P)]
    host_pairs = set()
    for dest, idx in part.replicas(xyz, keys, P):
        assert 0 <= dest < P
        buckets[dest].update(int(i) for i in idx)
        host_pairs.update((int(dest), int(i)) for i in idx)
    dots = np.clip(xyz.astype(np.float64) @ xyz.astype(np.float64).T, -1, 1)
    ii, jj = np.nonzero(dots >= np.cos(radius))
    assert np.any(ii != jj)                 # pairs beyond the self pairs
    for i, j in zip(ii, jj):
        assert j in buckets[keys[i]], (i, j, keys[i], keys[j])

    x = torch.as_tensor(xyz)
    dkeys = part.assign_device(x)
    dest, src, valid = part.bucket_entries_device(x, dkeys, P)
    # the device's own keys may differ from the host's by an arcsin ulp, so
    # check coverage of the device stream on its own terms as well
    dev_buckets = [set() for _ in range(P)]
    for d, s, v in zip(dest.tolist(), src.tolist(), valid.tolist()):
        if v:
            dev_buckets[d].add(s)
    dk = dkeys.numpy()
    for i, j in zip(ii, jj):
        assert j in dev_buckets[dk[i]], (i, j, dk[i])
    dest2, src2, valid2 = part.bucket_entries_device(
        x, torch.as_tensor(keys), P)
    dev_pairs = {(d, s) for d, s, v in zip(dest2.tolist(), src2.tolist(),
                                           valid2.tolist()) if v}
    assert dev_pairs >= {(int(k), i) for i, k in enumerate(keys)}
    assert dev_pairs >= host_pairs


# ---------------------------------------------------------------------------
# entry points: what they refuse, and the auto knobs they resolve
# ---------------------------------------------------------------------------

def test_entry_points_refuse_unported_options():
    """An unknown engine and an incompatible batch are refused; the auto
    knobs resolve through the cost model (``test_torch_cost_model.py``
    holds them equal to their manual twins)."""
    xyz = sky.make_catalog(100, 0)
    job = T.neighbor_search_job(0.05)
    with pytest.raises(ValueError, match="unknown engine"):
        T.run_jobs([job], xyz, engine="mesh", device="cpu")
    np.testing.assert_array_equal(
        T.shuffle_stage(xyz, T.ZonePartitioner(0.05), "auto",
                        device="cpu").owned,
        T.shuffle_stage(xyz, T.ZonePartitioner(0.05), "identity",
                        device="cpu").owned)
    auto = T.run_job(T.neighbor_search_job(0.05, codec="auto"), xyz,
                     device="cpu")
    assert auto.output == T.run_job(job, xyz, device="cpu").output
    assert auto.stats.codec == "identity"
    cat = T.shuffle_once(T.ZonePartitioner(0.05), xyz, tile="auto",
                         device="cpu")
    assert cat.tile == "auto" and cat.tile_resolved in (64, 128, 256, 512)
    with pytest.raises(ValueError, match="share one shuffle"):
        T.run_jobs([job, T.neighbor_search_job(0.05, tile=64)], xyz,
                   device="cpu")
    assert T.run_jobs([], xyz, device="cpu") == []
