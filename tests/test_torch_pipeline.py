"""The port's split sources, token sources and ``Prefetcher`` against the
JAX package's ``repro.data.pipeline``.

Every split source must give the reference's numpy arrays element for
element, boundaries included (a ragged last split, 1-row splits, an empty
source). The ``Prefetcher`` tests order their threads with events; where a
test waits for another thread to reach a state, it polls that state with a
deadline rather than sleeping for a guessed time.
"""
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jp  # noqa: E402
from repro_torch.data import pipeline as tp  # noqa: E402
from repro_torch.data import sky  # noqa: E402


def _splits(src):
    return [src.split(k) for k in range(src.n_splits())]


def _assert_same_splits(got_src, want_src):
    assert got_src.n_splits() == want_src.n_splits()
    for got, want in zip(_splits(got_src), _splits(want_src)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_src.materialize(),
                                  want_src.materialize())


def _wait_until(cond, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < deadline, "condition never held"
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# split sources: element for element against the reference
# ---------------------------------------------------------------------------

ARRAY_CASES = {
    # name: (n rows, d, n_splits, boundaries)
    "even": (12, 3, 4, None),
    "ragged_last": (10, 3, 3, None),
    "one_row_splits": (5, 3, 5, None),
    "more_splits_than_rows": (3, 3, 8, None),
    "one_split": (7, 3, 1, None),
    "empty": (0, 3, 4, None),
    "flat": (9, None, 2, None),
    "explicit_bounds": (10, 3, 1, [0, 3, 3, 10]),
}


@pytest.mark.timeout_s(60)
@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_array_splits_match_reference(case):
    n, d, k, bounds = ARRAY_CASES[case]
    items = np.arange(n * (d or 1), dtype=np.float32)
    items = items.reshape(n, d) if d else items
    got = tp.ArraySplits(items, n_splits=k, boundaries=bounds)
    want = jp.ArraySplits(items, n_splits=k, boundaries=bounds)
    _assert_same_splits(got, want)
    assert sum(len(s) for s in _splits(got)) == n


@pytest.mark.timeout_s(60)
def test_array_splits_reject_bad_boundaries():
    with pytest.raises(ValueError, match="outside"):
        tp.ArraySplits(np.zeros((4, 3)), boundaries=[5])


@pytest.mark.timeout_s(60)
@pytest.mark.parametrize("n_rows,rows_per_split", [
    (10, 4), (12, 4), (5, 1), (3, 8), (0, 4)])
def test_memmap_catalog_splits_match_reference(tmp_path, n_rows,
                                               rows_per_split):
    rows = sky.make_catalog(n_rows, 3)
    path = str(tmp_path / "cat.f32")
    tp.MemmapCatalogSplits.write(path, rows)
    got = tp.MemmapCatalogSplits(path, d=3, rows_per_split=rows_per_split)
    want = jp.MemmapCatalogSplits(path, d=3, rows_per_split=rows_per_split)
    _assert_same_splits(got, want)
    assert got.n_rows == n_rows
    np.testing.assert_array_equal(got.materialize().reshape(-1, 3), rows)


@pytest.mark.timeout_s(60)
def test_memmap_catalog_round_trip_and_reference_file(tmp_path):
    """A file either package writes reads back identically in both."""
    rows = sky.make_catalog(33, 5)
    mine, theirs = str(tmp_path / "t.f32"), str(tmp_path / "j.f32")
    tp.MemmapCatalogSplits.write(mine, rows)
    jp.MemmapCatalogSplits.write(theirs, rows)
    assert (tmp_path / "t.f32").read_bytes() == (tmp_path / "j.f32").read_bytes()
    src = tp.MemmapCatalogSplits(theirs, d=3, rows_per_split=8)
    np.testing.assert_array_equal(src.materialize(), rows)


@pytest.mark.timeout_s(60)
def test_memmap_catalog_splits_reject_trailing_bytes(tmp_path):
    """A file whose size is not a multiple of d*4 is refused, naming the
    file and the remainder, as in the reference."""
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    path = str(tmp_path / "cat.f32")
    tp.MemmapCatalogSplits.write(path, rows)
    with open(path, "ab") as f:
        f.write(b"\x00" * 5)
    with pytest.raises(ValueError, match=r"5 trailing bytes") as ei:
        tp.MemmapCatalogSplits(path, d=3, rows_per_split=2)
    assert "cat.f32" in str(ei.value)
    ok = str(tmp_path / "ok.f32")
    tp.MemmapCatalogSplits.write(ok, rows)
    assert tp.MemmapCatalogSplits(ok, d=3, rows_per_split=2).n_splits() == 2
    with pytest.raises(ValueError, match="rows_per_split"):
        tp.MemmapCatalogSplits(ok, d=3, rows_per_split=0)


@pytest.mark.timeout_s(60)
@pytest.mark.parametrize("n_rows,rows_per_split", [(1000, 300), (7, 7),
                                                   (0, 5)])
def test_synthetic_catalog_splits_match_reference(n_rows, rows_per_split):
    got = tp.SyntheticCatalogSplits(n_rows, rows_per_split, seed=11)
    want = jp.SyntheticCatalogSplits(n_rows, rows_per_split, seed=11)
    _assert_same_splits(got, want)


@pytest.mark.timeout_s(60)
def test_token_sources_match_reference(tmp_path):
    got, want = tp.SyntheticTokens(500, seed=2), jp.SyntheticTokens(500,
                                                                    seed=2)
    np.testing.assert_array_equal(got.block(3, 5, 16), want.block(3, 5, 16))
    path = str(tmp_path / "tok.i32")
    tp.MemmapTokens.write(path, got.block(0, 6, 16))
    mt, mj = tp.MemmapTokens(path, 16), jp.MemmapTokens(path, 16)
    for row0, rows in ((0, 6), (4, 5), (11, 13)):    # the last two wrap
        np.testing.assert_array_equal(mt.block(row0, rows, 16),
                                      mj.block(row0, rows, 16))
    with pytest.raises(ValueError, match="seq_len"):
        mt.block(0, 2, 8)
    for source_t, source_j in ((got, want), (mt, mj)):
        ts = tp.TokenBlockSplits(source_t, seq_len=16, rows_per_split=4,
                                 n_splits=3, start_row=1)
        js = jp.TokenBlockSplits(source_j, seq_len=16, rows_per_split=4,
                                 n_splits=3, start_row=1)
        _assert_same_splits(ts, js)
        assert ts.split(0).shape == (64, 1)
    with pytest.raises(ValueError, match="n_splits"):
        tp.TokenBlockSplits(got, seq_len=16, rows_per_split=4, n_splits=0)


@pytest.mark.timeout_s(60)
def test_pipeline_batches_match_reference():
    src = tp.SyntheticTokens(1000, seed=3)
    cfg = tp.PipelineConfig(global_batch=8, seq_len=16, host_id=1,
                            n_hosts=2, prefetch=2, start_step=3)
    jcfg = jp.PipelineConfig(global_batch=8, seq_len=16, host_id=1,
                             n_hosts=2, prefetch=2, start_step=3)
    jpipe = jp.Pipeline(jp.SyntheticTokens(1000, seed=3), jcfg)
    with tp.Pipeline(src, cfg) as pipe:
        it = iter(pipe)
        for _ in range(3):
            step, batch = next(it)
            np.testing.assert_array_equal(batch, jpipe.batch_at(step))
            assert batch.shape == (4, 16)
    assert pipe._pf is None
    with pytest.raises(ValueError, match="hosts"):
        tp.Pipeline(src, tp.PipelineConfig(global_batch=7, seq_len=4,
                                           n_hosts=2))


# ---------------------------------------------------------------------------
# Prefetcher
# ---------------------------------------------------------------------------

@pytest.mark.timeout_s(60)
def test_prefetcher_finite_in_order_with_timings():
    with tp.Prefetcher(lambda k: k * k, depth=2, n=5) as pf:
        got = []
        while (rec := pf.get()) is not None:
            k, item, wait, prep = rec
            assert wait >= 0 and prep >= 0
            got.append((k, item))
    assert got == [(k, k * k) for k in range(5)]
    assert pf._thread is None


@pytest.mark.timeout_s(60)
def test_prefetcher_exhaustion_latches():
    with tp.Prefetcher(lambda k: k, depth=2, n=2) as pf:
        assert pf.get()[1] == 0
        assert pf.get()[1] == 1
        for _ in range(3):
            assert pf.get() is None


@pytest.mark.timeout_s(60)
def test_prefetcher_error_propagates_and_latches():
    def produce(k):
        if k == 2:
            raise ValueError("fetch of split 2 failed")
        return k

    with tp.Prefetcher(produce, depth=1, n=5) as pf:
        assert [pf.get()[1] for _ in range(2)] == [0, 1]
        for _ in range(3):
            with pytest.raises(ValueError, match="split 2"):
                pf.get()


@pytest.mark.timeout_s(60)
def test_prefetcher_stuck_fetch_raises_named_error():
    release = threading.Event()
    entered = threading.Event()

    def produce(k):
        if k == 1:
            entered.set()
            release.wait(30.0)
        return k

    pf = tp.Prefetcher(produce, depth=1, n=5).start()
    assert pf.get()[1] == 0
    assert entered.wait(10.0)
    with pytest.raises(RuntimeError, match=r"inside produce\(1\)"):
        pf.stop(timeout=0.2)
    release.set()
    pf._thread.join(timeout=10.0)
    assert not pf._thread.is_alive()


@pytest.mark.timeout_s(60)
def test_prefetcher_stop_wakes_blocked_consumer():
    """A consumer blocked in get() wakes with None when stop() is called
    from another thread; the wedged worker is reported."""
    release = threading.Event()
    entered = threading.Event()

    def produce(k):
        entered.set()
        release.wait(30.0)
        return k

    pf = tp.Prefetcher(produce, depth=1, n=2).start()
    out = {}
    waiting = threading.Event()

    def consume():
        waiting.set()
        out["rec"] = pf.get()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    assert entered.wait(10.0) and waiting.wait(10.0)
    with pytest.raises(RuntimeError, match="leaked"):
        pf.stop(timeout=0.3)
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert out["rec"] is None
    release.set()
    pf._thread.join(timeout=10.0)
    assert not pf._thread.is_alive()


@pytest.mark.timeout_s(60)
def test_prefetcher_drain_keeps_inflight_item():
    """stop(drain=True) lets the in-flight hand-off finish and returns
    every undelivered record."""
    produced = []

    def produce(k):
        produced.append(k)
        return np.full((3,), k, np.int64)

    pf = tp.Prefetcher(produce, depth=1, n=2).start()
    _wait_until(lambda: produced == [0, 1])   # item 1 waits on a full queue
    drained = pf.stop(drain=True)
    assert [rec[0] for rec in drained if isinstance(rec, tuple)] == [0, 1]
    assert drained[1][1][0] == 1
    assert pf._thread is None
