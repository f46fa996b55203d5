"""The port's MapReduce query service, case for case with the JAX package's
``tests/test_mr_service.py`` (all but the 8-device mesh case), on the CPU.

Layers, bottom-up:
- ``shuffle_once`` / ``ResidentCatalog``: one shuffle, many bit-identical
  reduces (the ``run_jobs`` decomposition the batch path and the service
  share);
- ``MRQueryService``: submit queue -> micro-batches -> coalesced fused
  reduces, with per-request ``RequestStats`` and the closed-state guard;
- determinism: ANY partition of a request set into micro-batches returns
  the same per-request outputs as single-request execution.

Every threaded wait has a timeout, so a hang fails the test instead of
eating the suite's clock.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.mapreduce as R  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.ft import LaneChaos  # noqa: E402
from repro_torch.mapreduce import (MapReduceJob, Reducer,  # noqa: E402
                                   RequestStats, ZonePartitioner,
                                   group_batch_compatible, latency_summary,
                                   neighbor_search_job,
                                   neighbor_statistics_job, run_job, run_jobs,
                                   shuffle_once, shuffle_signature,
                                   token_histogram_job)
from repro_torch.serving import MRQueryService  # noqa: E402
from repro_torch.serving.mr_service import _job_key  # noqa: E402

RADIUS = 0.1


def _setup(n=600, seed=3, codec="int16"):
    xyz = sky.make_catalog(n, seed)
    part = ZonePartitioner(RADIUS)
    edges = np.linspace(0.03, RADIUS, 4)
    jobs = [neighbor_search_job(RADIUS, partitioner=part, codec=codec,
                                tile=64),
            neighbor_search_job(RADIUS / 2, partitioner=part, codec=codec,
                                tile=64),
            neighbor_statistics_job(edges / sky.ARCSEC, partitioner=part,
                                    codec=codec, tile=64)]
    return xyz, part, jobs


def _service(**kw):
    return MRQueryService(device="cpu", **kw)


def _singles(jobs, xyz):
    return [run_job(j, xyz, device="cpu").output for j in jobs]


# ---------------------------------------------------------------------------
# ResidentCatalog: the shuffle-then-reduce decomposition
# ---------------------------------------------------------------------------

def test_resident_catalog_matches_run_jobs():
    """shuffle_once + run == run_jobs bit-for-bit, and repeated runs reuse
    the resident tiers (zero map/shuffle wall on the request stats)."""
    xyz, part, jobs = _setup()
    mono = run_jobs(jobs, xyz, device="cpu")
    cat = shuffle_once(part, xyz, codec="int16", tile=64, device="cpu")
    res = cat.run(jobs)
    assert res[0].output == mono[0].output
    assert res[1].output == mono[1].output
    np.testing.assert_array_equal(res[2].output, mono[2].output)
    again = cat.run(jobs[0])
    assert again[0].output == mono[0].output
    assert again[0].stats.map_wall_s == 0.0
    assert again[0].stats.shuffle_wall_s == 0.0
    assert again[0].stats.reduce_wall_s > 0.0
    assert cat.load_stats.shuffle_wall_s > 0.0
    assert cat.nbytes > 0 and cat.n_rows == len(xyz)


def test_resident_catalog_rejects_incompatible_jobs():
    xyz, part, jobs = _setup()
    cat = shuffle_once(part, xyz, codec="int16", tile=64, device="cpu")
    other_part = neighbor_search_job(0.05, tile=64)          # own partitioner
    with pytest.raises(ValueError, match="partitioner"):
        cat.run(other_part)
    with pytest.raises(ValueError, match="codec"):
        cat.run(neighbor_search_job(RADIUS, partitioner=part,
                                    codec="identity", tile=64))
    with pytest.raises(ValueError, match="tile"):
        cat.run(neighbor_search_job(RADIUS, partitioner=part, codec="int16",
                                    tile=128))


def test_shuffle_signature_grouping():
    xyz, part, jobs = _setup()
    other = neighbor_search_job(0.05, codec="int16", tile=64)
    assert shuffle_signature(jobs[0]) == shuffle_signature(jobs[2])
    assert shuffle_signature(jobs[0]) != shuffle_signature(other)
    groups = group_batch_compatible([jobs[0], other, jobs[2], jobs[1]])
    assert [len(g) for g in groups] == [3, 1]
    assert groups[0] == [jobs[0], jobs[2], jobs[1]]          # order kept
    assert group_batch_compatible([]) == []


def test_group_batch_compatible_matches_reference():
    """The same job list groups the same way in both packages."""
    spec = [(RADIUS, "int16", 64), (0.05, "int16", 64), (RADIUS, "int16", 64),
            (RADIUS, "identity", 64), (RADIUS, "int16", 128)]

    def jobs(side):
        parts = {}
        out = []
        for r, codec, tile in spec:
            part = parts.setdefault(r, side.ZonePartitioner(r))
            out.append(side.neighbor_search_job(RADIUS / 2, partitioner=part,
                                                codec=codec, tile=tile))
        return out

    t, j = jobs(T), jobs(R)
    ids = {id(x): i for i, x in enumerate(t)}
    jids = {id(x): i for i, x in enumerate(j)}
    assert [[ids[id(x)] for x in g] for g in group_batch_compatible(t)] == \
        [[jids[id(x)] for x in g] for g in R.group_batch_compatible(j)]


# ---------------------------------------------------------------------------
# MRQueryService: queueing, coalescing, accounting
# ---------------------------------------------------------------------------

def test_service_serves_and_coalesces_duplicates():
    """Duplicate queries in one admission window run ONCE (including
    separately-constructed equal jobs); every request still gets its own
    output and RequestStats."""
    xyz, part, jobs = _setup()
    dup = neighbor_search_job(RADIUS, partitioner=part, codec="int16",
                              tile=64)                       # == jobs[0]
    assert _job_key(dup) == _job_key(jobs[0])
    svc = _service(max_batch=8)
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    reqs = [svc.submit(j, catalog="sky") for j in jobs + [dup, jobs[0]]]
    assert svc.pending == 5
    assert svc.run_pending() == 5
    assert svc.batches == [dict(batch=0, size=5, n_unique=3,
                                wall_s=svc.batches[0]["wall_s"])]
    singles = _singles(jobs, xyz)
    for r, want in zip(reqs, singles + [singles[0], singles[0]]):
        np.testing.assert_array_equal(r.output, want)
        assert r.done and r.stats.batch_size == 5 and r.stats.n_unique == 3
        assert r.stats.latency_s >= r.stats.queue_wait_s >= 0.0
    s = svc.latency_summary()
    assert s["n"] == 5 and s["mean_batch"] == 5.0 and s["qps"] > 0
    assert svc.metrics.counter("mr_requests_served").value == 5


@pytest.mark.parametrize("sizes", [[1] * 7, [7], [2, 3, 2], [3, 4],
                                   [5, 1, 1]])
def test_service_any_fixed_microbatch_partition_matches_single(sizes):
    """Several partitions of one request stream into micro-batches all
    reproduce single-request outputs exactly."""
    xyz, part, jobs = _setup()
    stream = [jobs[i % 3] for i in range(7)]
    singles = _singles(stream, xyz)
    svc = _service(max_batch=16)
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    reqs = [svc.submit(j, catalog="sky") for j in stream]
    svc.run_pending(batch_sizes=sizes)
    assert [b["size"] for b in svc.batches] == list(sizes)
    for r, want in zip(reqs, singles):
        np.testing.assert_array_equal(r.output, want)
    svc.close()


@pytest.mark.parametrize("seed", range(4))
def test_service_random_microbatch_partitions_match_single(seed):
    """Random request streams over the four-query mix, cut at random into
    micro-batches: every output equals its single-request run."""
    rng = np.random.default_rng(seed)
    xyz, part, jobs = _setup(n=400, seed=seed)
    jobs.append(neighbor_search_job(RADIUS / 4, partitioner=part,
                                    codec="int16", tile=64))
    singles = _singles(jobs, xyz)
    picks = rng.integers(0, len(jobs), int(rng.integers(1, 12)))
    cuts, left = [], len(picks)
    while left:
        cuts.append(int(rng.integers(1, left + 1)))
        left -= cuts[-1]
    svc = _service(max_batch=16)
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    reqs = [svc.submit(jobs[k], catalog="sky") for k in picks]
    assert svc.run_pending(batch_sizes=cuts) == len(picks)
    for r, k in zip(reqs, picks):
        np.testing.assert_array_equal(r.result(timeout=5), singles[k])


def test_service_multi_catalog_batch():
    """One admission window spanning catalogs: each group reduces against
    its own resident shuffle (sky zones + token hash partitions)."""
    xyz, part, jobs = _setup()
    toks = np.random.default_rng(0).integers(0, 40, 800)
    items = toks.astype(np.float32).reshape(-1, 1)
    wjob = token_histogram_job(40, tile=64, codec="int16")
    svc = _service(max_batch=8)
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    svc.load_catalog("tokens", items, wjob.partitioner, codec=wjob.codec,
                     tile=64, pad_value=wjob.reducer.pad_value)
    r1 = svc.submit(jobs[0], catalog="sky")
    r2 = svc.submit(wjob, catalog="tokens")
    r3 = svc.submit(token_histogram_job(40, tile=64, codec="int16"),
                    catalog="tokens")                        # equal, coalesces
    svc.run_pending()
    assert svc.batches[0]["size"] == 3 and svc.batches[0]["n_unique"] == 2
    assert r1.output == run_job(jobs[0], xyz, device="cpu").output
    np.testing.assert_array_equal(r2.output,
                                  np.bincount(toks, minlength=40))
    np.testing.assert_array_equal(r3.output, r2.output)


@pytest.mark.timeout_s(300)
def test_service_threaded_context_manager():
    xyz, part, jobs = _setup()
    svc = _service(max_batch=4, max_wait_s=0.001)
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    want = run_job(jobs[0], xyz, device="cpu").output
    with svc:
        reqs = [svc.submit(jobs[0], catalog="sky") for _ in range(9)]
        outs = [r.result(timeout=120) for r in reqs]
    assert outs == [want] * 9
    assert sum(b["size"] for b in svc.batches) == 9
    assert all(b["n_unique"] == 1 for b in svc.batches)
    assert svc._thread is None                   # close() joined the worker


def test_service_closed_guard():
    """Like ServeEngine after run() drains, a closed service rejects
    submissions instead of silently enqueueing them forever."""
    xyz, part, jobs = _setup(n=80)
    svc = _service()
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    req = svc.submit(jobs[0], catalog="sky")
    svc.close()                        # drains the pending request first
    assert req.done and svc.pending == 0
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(jobs[0], catalog="sky")
    with pytest.raises(RuntimeError, match="closed"):
        svc.start()
    with pytest.raises(RuntimeError, match="closed"):
        svc.load_catalog("more", xyz, part)
    svc.close()                        # idempotent


def test_service_submit_validates_at_the_door():
    xyz, part, jobs = _setup(n=80)
    svc = _service()
    with pytest.raises(KeyError, match="no catalog"):
        svc.submit(jobs[0], catalog="sky")
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    with pytest.raises(ValueError, match="codec"):
        svc.submit(neighbor_search_job(RADIUS, partitioner=part, tile=64),
                   catalog="sky")
    assert svc.pending == 0            # nothing half-enqueued


def test_service_runs_on_the_card_unless_asked(monkeypatch):
    """``device=None`` means the card: without one the service raises
    rather than quietly serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MRQueryService()
    assert _service().device.type == "cpu"


def test_service_straggler_monitor_hook():
    """Per-batch walls reach the monitor with the executor's record()
    contract: one call per micro-batch, indexed by batch."""
    recorded = []

    class Monitor:
        def record(self, k, wall_s):
            recorded.append((k, wall_s))

    xyz, part, jobs = _setup(n=200)
    svc = _service(max_batch=2, straggler_monitor=Monitor())
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    for _ in range(5):
        svc.submit(jobs[0], catalog="sky")
    svc.run_pending()
    assert [k for k, _ in recorded] == [0, 1, 2]
    assert all(w > 0 for _, w in recorded)
    assert [w for _, w in recorded] == [b["wall_s"] for b in svc.batches]


def test_latency_summary_math():
    reqs = [RequestStats(rid=i, t_submit_s=0.1 * i, queue_wait_s=0.01,
                         latency_s=0.2 + 0.01 * i, batch_size=2)
            for i in range(10)]
    s = latency_summary(reqs)
    assert s == R.latency_summary(
        [R.RequestStats(**r.to_dict()) for r in reqs])
    assert s["n"] == 10 and s["mean_batch"] == 2.0
    # span = last done (0.9 + 0.29) - first submit (0.0)
    assert s["qps"] == pytest.approx(10 / (0.9 + 0.29))
    assert s["p50_ms"] == pytest.approx(245.0)
    assert s["wait_p50_ms"] == pytest.approx(10.0)
    assert s["p99_ms"] <= 290.0
    empty = latency_summary([])
    assert empty["n"] == 0 and empty["qps"] == 0.0
    assert empty == R.latency_summary([])


def test_latency_summary_degenerate_span():
    """One request, or simultaneous zero-latency ones, span ~0 s: qps is 0,
    not a floored-span 1e9."""
    one = [RequestStats(rid=0, t_submit_s=5.0, latency_s=0.0)]
    s = latency_summary(one)
    assert s["qps"] == 0.0 and s["span_s"] == 0.0 and s["n"] == 1
    assert s == R.latency_summary([R.RequestStats(**one[0].to_dict())])


# ---------------------------------------------------------------------------
# failure isolation + lane serving
# ---------------------------------------------------------------------------

@pytest.mark.timeout_s(300)
def test_service_poison_request_does_not_fail_batchmates():
    """One request whose job fails mid-run (passes door validation, raises
    at reduce) must fail ALONE: its coalesced batch-mates are recovered
    with per-job fallback runs and still get bit-exact outputs."""

    @dataclasses.dataclass(frozen=True)
    class PoisonReducer(Reducer):
        pad_value: float = 0.0

        def per_partition(self, owned_p, bucket_p):
            raise ValueError("poison: invalid query parameters")

    xyz, part, jobs = _setup()
    singles = _singles(jobs, xyz)
    svc = _service(max_batch=8)
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    good = [svc.submit(j, catalog="sky") for j in jobs]
    poison = MapReduceJob(name="poison", partitioner=part,
                          reducer=PoisonReducer(), codec="int16", tile=64)
    bad = svc.submit(poison, catalog="sky")
    assert svc.run_pending() == 4
    for r, want in zip(good, singles):
        assert r.error is None
        np.testing.assert_array_equal(r.output, want)
    assert bad.done and isinstance(bad.error, ValueError)
    with pytest.raises(ValueError, match="poison"):
        bad.result(timeout=5)
    # exactly one batch recorded, containing all 4 requests
    assert len(svc.batches) == 1 and svc.batches[0]["size"] == 4


@pytest.mark.timeout_s(300)
def test_service_lanes_concurrent_batches_and_lane_death():
    """Lane-backed serving: micro-batches run concurrently on a LanePool;
    an injected lane death shrinks the pool and requeues the batch instead
    of killing the service: every request still gets the exact answer."""
    xyz, part, jobs = _setup()
    singles = _singles(jobs, xyz)
    chaos = LaneChaos(kills=[(0, 0)])
    svc = _service(max_batch=2, max_wait_s=0.001, n_lanes=3,
                   lane_chaos=chaos)
    svc.load_catalog("sky", xyz, part, codec="int16", tile=64)
    with svc:
        reqs = [svc.submit(jobs[i % 3], catalog="sky") for i in range(8)]
        outs = [r.result(timeout=120) for r in reqs]
    for got, i in zip(outs, range(8)):
        np.testing.assert_array_equal(got, singles[i % 3])
    assert len(chaos.deaths) == 1          # the kill actually fired
    assert sum(b["size"] for b in svc.batches) == 8
    # close() joined the pool: no leaked lane threads
    assert svc._pool is None


@pytest.mark.timeout_s(300)
def test_service_auto_knobs_equal_manual():
    """A catalog loaded with ``codec="auto"``/``tile="auto"`` serves auto
    jobs with the manual jobs' outputs."""
    xyz, part, jobs = _setup(codec="identity")
    auto = [dataclasses.replace(j, codec="auto", tile="auto") for j in jobs]
    svc = _service(max_batch=8)
    cat = svc.load_catalog("sky", xyz, part, codec="auto", tile="auto")
    assert cat.codec.name == "identity" and cat.tile_resolved > 0
    reqs = [svc.submit(dataclasses.replace(j, codec="identity"),
                       catalog="sky") for j in auto]
    svc.run_pending()
    for r, want in zip(reqs, _singles(jobs, xyz)):
        np.testing.assert_array_equal(r.result(timeout=5), want)
