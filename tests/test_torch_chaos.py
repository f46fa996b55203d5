"""Chaos parity for the port's lane scheduler, on the CPU.

Recovery is real only if it is invisible in the results: the port's
streamed outputs must equal its monolithic ``run_job`` under concurrent
lanes, transient fetch faults with retry, speculative clones that win AND
lose, lane deaths and seeded chaos.

Every race here is ordered by state, not by wall-clock margins: a stalled
fetch waits on its cancel event (or on an event the test controls) for far
longer than the run, so which attempt wins never depends on how busy the
machine is.
"""
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.data.pipeline import ArraySplits, SplitSource  # noqa: E402
from repro_torch.ft import (CancelledFetch, FaultySplitSource,  # noqa: E402
                            LaneChaos, SpeculativeConfig, SpeculativePolicy,
                            TransientSplitError)
from repro_torch.kernels import (LAUNCHES, count_launch,  # noqa: E402
                                 reset_launch_counts)

RADIUS = 0.02
STALL_S = 60.0          # far longer than any run: only a cancel ends it


def _catalog(n=3000, seed=0):
    return sky.make_catalog(n, seed)


def _tokens(n=4000, vocab=89):
    return (np.arange(n) % vocab).astype(np.float32).reshape(-1, 1)


def _job():
    return T.neighbor_search_job(RADIUS, tile=128)


def _mono(job, items):
    return T.run_job(job, items, device="cpu").output


def _stream(job, source, **kw):
    return T.run_job_streaming(job, source, device="cpu", **kw)


def _wait_until(cond, timeout_s=STALL_S):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        if time.perf_counter() > deadline:
            raise TimeoutError("condition never held")
        time.sleep(0.002)


class _Gated(SplitSource):
    """Every fetch waits until ``cond()`` holds."""

    def __init__(self, inner, cond):
        self.inner, self.cond = inner, cond

    def n_splits(self):
        return self.inner.n_splits()

    def split(self, k):
        _wait_until(self.cond)
        return self.inner.split(k)


class _CloneLoses(SplitSource):
    """Split 0's first fetch returns only once a second fetch of it (the
    clone's) has started; that second fetch stalls until it is cancelled.
    So the original always finishes first, and the clone always loses."""

    def __init__(self, inner):
        self.inner = inner
        self.clone_started = threading.Event()
        self._lock = threading.Lock()
        self.calls = 0

    def n_splits(self):
        return self.inner.n_splits()

    def split(self, k):
        return self.split_cancellable(k, None)

    def split_cancellable(self, k, cancel):
        if k != 0:
            return self.inner.split(k)
        with self._lock:
            call, self.calls = self.calls, self.calls + 1
        if call == 0:
            if not self.clone_started.wait(STALL_S):
                raise TimeoutError("the clone never started")
        else:
            self.clone_started.set()
            if cancel.wait(STALL_S):
                raise CancelledFetch("clone of split 0 cancelled")
        return self.inner.split(k)


# ---------------------------------------------------------------------------
# parity under lanes / faults / speculation
# ---------------------------------------------------------------------------

@pytest.mark.timeout_s(300)
@pytest.mark.parametrize("n_lanes", [1, 2, 4])
def test_lanes_bit_exact_search(n_lanes):
    """Concurrent lanes == monolithic, accumulate mode (pair search); the
    lane path (forced with max_retries) gives the sequential path's stats."""
    xyz = _catalog()
    job = _job()
    want = _mono(job, xyz)
    res = _stream(job, ArraySplits(xyz, n_splits=5), n_lanes=n_lanes,
                  max_retries=1)
    seq = _stream(job, ArraySplits(xyz, n_splits=5))
    assert res.output == seq.output == want
    st = res.stats
    assert st.n_lanes == n_lanes and len(st.lane_walls) == n_lanes
    assert [r["split"] for r in st.splits] == list(range(5))
    assert all(r["lane"] in range(n_lanes) for r in st.splits)
    assert st.elapsed_s > 0 and st.run_wall_s == st.elapsed_s
    for f in ("n_items", "map_bytes", "n_partitions", "shuffle_wire_bytes",
              "reduce_flops", "reduce_padded_ratio", "tiers", "n_splits"):
        assert getattr(st, f) == getattr(seq.stats, f), f


@pytest.mark.timeout_s(300)
def test_lanes_bit_exact_wordcount_combine():
    """Combine mode over lanes: commit order is nondeterministic, the sums
    must not care."""
    toks = _tokens()
    job = T.token_histogram_job(89)
    res = _stream(job, ArraySplits(toks, n_splits=6), n_lanes=3)
    np.testing.assert_array_equal(res.output, _mono(job, toks))
    assert res.stats.combiner == "token_count"
    assert res.stats.n_items == len(toks)


@pytest.mark.timeout_s(300)
def test_transient_faults_retry_to_parity():
    xyz = _catalog()
    job = _job()
    src = FaultySplitSource(ArraySplits(xyz, n_splits=6),
                            faults={1: 2, 4: 1})
    res = _stream(job, src, n_lanes=2, max_retries=2, retry_backoff_s=0.01)
    assert res.output == _mono(job, xyz)
    assert res.stats.retries == 3 and src.injected_faults == 3


@pytest.mark.timeout_s(120)
def test_retry_budget_exhausted_raises():
    xyz = _catalog(800)
    src = FaultySplitSource(ArraySplits(xyz, n_splits=4), faults={2: 3})
    with pytest.raises(TransientSplitError):
        _stream(_job(), src, n_lanes=2, max_retries=2, retry_backoff_s=0.01)


@pytest.mark.timeout_s(300)
def test_speculation_clone_wins_bit_parity():
    """Split 0's first fetch stalls until cancelled; the clone's re-fetch
    is fast and wins, and the original is cancelled mid-stall."""
    xyz = _catalog()
    job = _job()
    src = FaultySplitSource(ArraySplits(xyz, n_splits=8),
                            delays={0: STALL_S})
    pol = SpeculativePolicy(SpeculativeConfig(slowdown=2.0, min_finished=2,
                                              max_clones=1))
    res = _stream(job, src, n_lanes=2, speculate=pol)
    st = res.stats
    assert res.output == _mono(job, xyz)
    assert st.speculated >= 1 and st.clone_wins >= 1
    assert st.elapsed_s < STALL_S / 2          # the stall was cut short
    assert st.splits[0]["split"] == 0 and st.splits[0]["clone"]
    assert src.calls[0] == 2


@pytest.mark.timeout_s(300)
def test_speculation_clone_loses_bit_parity():
    """The original finishes first (it is released by the clone's start,
    and the clone then stalls until cancelled): the clone is cancelled and
    the result is still bit-identical."""
    xyz = _catalog()
    job = _job()
    src = _CloneLoses(ArraySplits(xyz, n_splits=6))
    pol = SpeculativePolicy(SpeculativeConfig(slowdown=2.0, min_finished=2,
                                              max_clones=1))
    res = _stream(job, src, n_lanes=2, speculate=pol)
    st = res.stats
    assert res.output == _mono(job, xyz)
    assert st.speculated >= 1 and st.clone_wins == 0
    assert not st.splits[0]["clone"] and src.calls == 2


@pytest.mark.timeout_s(300)
def test_speculation_on_vs_off_identical():
    """The same fault schedule with speculation and retry on or off gives
    the same outputs (fresh sources, so fault state does not leak)."""
    xyz, toks = _catalog(), _tokens()
    for job, items in ((_job(), xyz), (T.token_histogram_job(89), toks)):
        def faulty():
            return FaultySplitSource(ArraySplits(items, n_splits=6),
                                     delays={1: 0.05}, faults={3: 1},
                                     seed=0, fault_p=0.2)
        off = _stream(job, faulty(), n_lanes=2, max_retries=3,
                      retry_backoff_s=0.01)
        on = _stream(job, faulty(), n_lanes=3, max_retries=3,
                     retry_backoff_s=0.01,
                     speculate=SpeculativeConfig(slowdown=2.0,
                                                 min_finished=2))
        np.testing.assert_array_equal(on.output, off.output)
        np.testing.assert_array_equal(on.output, _mono(job, items))


@pytest.mark.timeout_s(300)
def test_lane_death_requeues_to_parity():
    """Lane 0 dies on its first task; no fetch proceeds before that death,
    so lane 0 is sure to take a task. Its split requeues on the
    survivors."""
    xyz = _catalog()
    job = _job()
    chaos = LaneChaos(kills=[(0, 0)])
    src = _Gated(ArraySplits(xyz, n_splits=6), lambda: chaos.deaths)
    res = _stream(job, src, n_lanes=3, chaos=chaos)
    assert res.output == _mono(job, xyz)
    assert len(chaos.deaths) == 1
    assert all(r["lane"] != 0 for r in res.stats.splits)


@pytest.mark.timeout_s(120)
def test_deadline_raises_instead_of_hanging():
    xyz = _catalog(800)
    src = FaultySplitSource(ArraySplits(xyz, n_splits=4),
                            delays={0: STALL_S})
    t0 = time.perf_counter()
    with pytest.raises(T.JobDeadlineExceeded, match=r"splits \[0\]"):
        _stream(_job(), src, n_lanes=2, deadline_s=0.5)
    assert time.perf_counter() - t0 < STALL_S / 2   # cancelled, not served


@pytest.mark.timeout_s(600)
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_chaos_parity(seed):
    rng = np.random.default_rng(seed)
    xyz = _catalog(2000, seed=seed)
    job = _job()
    n_splits = int(rng.integers(2, 7))
    n_lanes = int(rng.integers(1, 5))
    src = FaultySplitSource(ArraySplits(xyz, n_splits=n_splits),
                            seed=seed, delay_p=0.3, fault_p=0.3,
                            delay_s=0.05, max_faults=2)
    res = _stream(job, src, n_lanes=n_lanes, max_retries=2,
                  retry_backoff_s=0.01,
                  speculate=SpeculativeConfig(slowdown=2.0, min_finished=2))
    assert res.output == _mono(job, xyz), (seed, n_splits, n_lanes)


# ---------------------------------------------------------------------------
# LanePool unit behaviour
# ---------------------------------------------------------------------------

@pytest.mark.timeout_s(60)
def test_lanepool_first_commit_wins_and_cancels():
    """Two attempts for one key: the first commit wins, the loser's cancel
    event fires and it unwinds."""
    started = threading.Event()
    cancelled = threading.Event()

    def slow(cancel):
        started.set()
        if cancel.wait(STALL_S):
            cancelled.set()
            raise T.LaneCancelled(0)
        return "slow"

    with T.LanePool(2, max_retries=0) as pool:
        pool.submit(0, slow)
        assert started.wait(STALL_S)
        pool.submit(0, lambda cancel: "fast", clone=True)
        pool.drain([0])
        assert pool.results[0] == "fast" and pool.meta[0]["clone"]
        assert pool.clone_wins == 1
    assert cancelled.is_set() and pool.cancelled == 1


@pytest.mark.timeout_s(60)
def test_lanepool_lane_death_shrinks_pool():
    chaos = LaneChaos(kills=[(0, 0)])

    def task(k):
        def fn(cancel):
            _wait_until(lambda: chaos.deaths)
            return k * 10
        return fn

    with T.LanePool(3, chaos=chaos) as pool:
        for k in range(5):
            pool.submit(k, task(k))
        pool.drain(range(5))
        assert pool.results == {k: k * 10 for k in range(5)}
        assert pool.width == 2 and pool.lane_deaths == 1
        assert not pool.lanes[0].alive and "lane 0" in \
            pool.lanes[0].dead_reason


@pytest.mark.timeout_s(60)
def test_lanepool_stuck_lane_declared_dead_and_requeued():
    """A lane wedged past ``stuck_after_s`` (its task ignores cancel) is
    declared dead through the Coordinator's heartbeat machine; its split
    requeues and completes on the survivor."""
    wedged, release = threading.Event(), threading.Event()

    def maybe_wedge(k):
        def fn(cancel):
            if k == 0 and not wedged.is_set():
                wedged.set()
                release.wait(STALL_S)          # ignores cancel
                raise T.LaneCancelled(k)
            return k * 10
        return fn

    with T.LanePool(2, max_retries=0, stuck_after_s=1.0,
                    join_timeout_s=STALL_S) as pool:
        for k in range(4):
            pool.submit(k, maybe_wedge(k))
        try:
            pool.drain(range(4))
            assert {k: pool.results[k] for k in range(4)} == \
                {0: 0, 1: 10, 2: 20, 3: 30}
            assert pool.remeshes, "stuck lane never declared dead"
            assert pool.width == 1
        finally:
            release.set()
    assert not any(lane.thread.is_alive() for lane in pool.lanes)


@pytest.mark.timeout_s(60)
def test_lanepool_shutdown_reports_leaked_thread():
    started, release = threading.Event(), threading.Event()

    def stubborn(cancel):
        started.set()
        release.wait(STALL_S)
        return "late"

    pool = T.LanePool(1, max_retries=0, join_timeout_s=0.2)
    pool.submit(0, stubborn)
    assert started.wait(STALL_S)
    with pytest.raises(RuntimeError, match="leaked lane thread"):
        pool.shutdown()
    release.set()
    pool.lanes[0].thread.join(timeout=STALL_S)
    assert not pool.lanes[0].thread.is_alive()


@pytest.mark.timeout_s(120)
def test_launch_counts_lose_nothing_across_threads():
    """``count_launch`` from more threads than cores, with the interpreter
    switching threads as often as it can: no count is lost."""
    n_threads, per_thread = 32, 2000
    old = sys.getswitchinterval()
    go = threading.Event()

    def worker():
        go.wait(STALL_S)
        for _ in range(per_thread):
            count_launch("pair_count_masked")

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    try:
        sys.setswitchinterval(1e-6)
        reset_launch_counts()
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(timeout=STALL_S)
        assert not any(t.is_alive() for t in threads)
        assert LAUNCHES["pair_count_masked"] == n_threads * per_thread
    finally:
        sys.setswitchinterval(old)
        go.set()
        reset_launch_counts()
