"""Deterministic data pipeline + catalog split sources (numpy).

The port of ``repro.data.pipeline``, line for line where it can be: splits
and token blocks are numpy arrays, equal element for element to the JAX
package's, so both packages stream the same dataset from one seed or file.

Token sources (LM side):
- ``SyntheticTokens``: stateless, hash-based tokens: any (step, position) is
  reproducible on any host without coordination.
- ``MemmapTokens``: packed binary int32 token file read through np.memmap.

``Pipeline`` yields *host-local* slices of the global batch given
(host_id, n_hosts), with a background prefetch thread (depth-bounded queue);
it is a context manager, so the thread can never leak past a ``with`` block.

Split sources (MapReduce side): a ``SplitSource`` is the HDFS-block analogue,
a finite sequence of catalog splits that the streaming executor
(``mapreduce/executor.py``) pulls one at a time, so the full catalog never
has to exist in device memory at once. ``ArraySplits`` chunks an in-memory
array (the one-split case is how ``run_jobs`` delegates to the executor),
``MemmapCatalogSplits`` reads row chunks of a packed float32 file,
``SyntheticCatalogSplits`` generates sky-catalog chunks deterministically
per split, and ``TokenBlockSplits`` adapts the token sources above into
wordcount-shaped ``[rows, 1]`` splits.

Both consumers share one ``Prefetcher``: a depth-bounded background producer
thread that reports, per item, how long the producer spent building it and
how long the consumer was actually blocked waiting: the split between
*hidden* and *exposed* I/O that the executor's ``overlap_hidden_s``
accounting is built on. ``SpilledStreamSplits`` reads the spill tier's
segments (``mapreduce/spill.py``) back as partition-range records.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np


class SyntheticTokens:
    """tokens[i, j] = mix64(seed, i, j) % vocab — O(1) random access."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = np.uint64(seed)

    def block(self, row0: int, rows: int, cols: int) -> np.ndarray:
        i = (np.arange(row0, row0 + rows, dtype=np.uint64)[:, None] *
             np.uint64(0x9E3779B97F4A7C15))
        j = (np.arange(cols, dtype=np.uint64)[None, :] *
             np.uint64(0xBF58476D1CE4E5B9))
        x = i ^ j ^ (self.seed * np.uint64(0x94D049BB133111EB))
        x ^= x >> np.uint64(31)
        x *= np.uint64(0xD6E8FEB86659FD93)
        x ^= x >> np.uint64(27)
        return (x % np.uint64(self.vocab)).astype(np.int32)


class MemmapTokens:
    """Packed int32 token file of shape [n_rows, seq_len]."""

    def __init__(self, path: str, seq_len: int):
        self.arr = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.n_rows = self.arr.shape[0] // seq_len

    def block(self, row0: int, rows: int, cols: int) -> np.ndarray:
        if cols != self.seq_len:
            raise ValueError(f"cols {cols} != the file's seq_len {self.seq_len}")
        out = np.empty((rows, cols), np.int32)
        # contiguous slice reads; the loop only runs when the range wraps
        # around the end of the file (once per full pass)
        got, r = 0, row0 % self.n_rows
        while got < rows:
            take = min(rows - got, self.n_rows - r)
            out[got:got + take] = self.arr[r * cols:(r + take) * cols
                                           ].reshape(take, cols)
            got += take
            r = 0
        return out

    @staticmethod
    def write(path: str, tokens: np.ndarray):
        np.asarray(tokens, np.int32).tofile(path)


class Prefetcher:
    """Depth-bounded background producer (the shared prefetch-thread pattern
    behind ``Pipeline`` and the streaming executor's double buffer).

    ``produce(k)`` is called on a daemon thread for k = start, start+1, ...
    (stopping after ``n`` items when ``n`` is given) and results queue up to
    ``depth`` deep. ``get()`` blocks for the next item and returns
    ``(k, item, wait_s, prep_s)``: ``prep_s`` is how long the producer spent
    building the item, ``wait_s`` how long the *consumer* was blocked — so
    ``prep_s - wait_s`` of I/O was hidden under the consumer's own work.
    Returns ``None`` once the source is exhausted. Context manager: the
    thread is stopped (and joined) on exit, success or failure.

    Terminal state is LATCHED: once the exhaustion sentinel or a producer
    exception has surfaced, every subsequent ``get()`` re-surfaces it
    (returns ``None`` again / re-raises the same exception) instead of
    blocking forever on an empty queue with a dead worker. A consumer
    blocked in ``get()`` wakes with ``None`` when ``stop()`` is called.

    ``stop(drain=True)`` is the producer-side counterpart for writers whose
    produced items must not be lost (the spill writer): the worker finishes
    its in-flight ``produce`` and hands the item off instead of dropping it
    when it races a full queue, and every undelivered record is returned.
    """

    def __init__(self, produce: Callable[[int], object], *, depth: int = 2,
                 start: int = 0, n: int | None = None):
        self._produce = produce
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._start_k = start
        self._n = n
        self._thread: threading.Thread | None = None
        self._busy_k: int | None = None    # index currently inside produce()
        self._terminal = None              # latched: _EXHAUSTED or exception

    _EXHAUSTED = object()

    def start(self) -> "Prefetcher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def _put(self, rec) -> bool:
        # cancel semantics: stop() abandons the in-flight item (the drain
        # path instead empties the queue until this hand-off succeeds)
        while not self._stop.is_set():
            try:
                self._q.put(rec, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        k = self._start_k
        while not (self._stop.is_set() or self._drain.is_set()):
            if self._n is not None and k >= self._start_k + self._n:
                self._put(None)
                return
            t0 = time.perf_counter()
            self._busy_k = k
            try:
                item = self._produce(k)
            except BaseException as e:         # surface in the consumer
                self._put(e)
                return
            finally:
                self._busy_k = None
            self._put((k, item, time.perf_counter() - t0))
            k += 1

    def get(self):
        if self._terminal is not None:         # latched terminal state
            if self._terminal is self._EXHAUSTED:
                return None
            raise self._terminal
        if self._thread is None:
            self.start()
        t0 = time.perf_counter()
        while True:
            try:
                rec = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                if self._stop.is_set():        # stop() wakes blocked consumers
                    rec = None
                    break
        wait = time.perf_counter() - t0
        if rec is None:
            self._terminal = self._EXHAUSTED
            return None
        if isinstance(rec, BaseException):
            self._terminal = rec
            raise rec
        k, item, prep = rec
        return k, item, wait, prep

    def stop(self, timeout: float = 2.0, drain: bool = False):
        """Stop and join the producer thread. A failed join used to pass
        silently — a worker wedged inside ``produce(k)`` would leak past the
        ``with`` block and hold its buffers forever; now it raises, naming
        the stuck fetch so the I/O that wedged is identifiable.

        ``drain=True`` (the spill writer's shutdown path): instead of
        abandoning the worker's in-flight item when it races a full queue,
        let the current ``produce`` finish and hand off, consume every
        undelivered record ourselves, and return them — nothing the
        producer finished is ever dropped on the floor. Returns the drained
        record list (``None``/exception records included, for inspection);
        plain ``stop()`` returns ``None`` and keeps cancel semantics."""
        drained = None
        if drain and self._thread is not None:
            drained = []
            self._drain.set()
            deadline = time.perf_counter() + timeout
            while (self._thread.is_alive()
                   and time.perf_counter() < deadline):
                try:
                    drained.append(self._q.get(timeout=0.02))
                except queue.Empty:
                    pass
            while True:                         # leftovers after worker exit
                try:
                    drained.append(self._q.get_nowait())
                except queue.Empty:
                    break
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                k = self._busy_k
                where = (f"inside produce({k})" if k is not None
                         else "blocked handing off an item")
                raise RuntimeError(
                    f"Prefetcher worker thread leaked: still {where} "
                    f"{timeout}s after stop() — the fetch for "
                    f"{'item ' + str(k) if k is not None else 'the queue'} "
                    f"is stuck and its buffers cannot be reclaimed")
            self._thread = None
        return drained

    def __enter__(self) -> "Prefetcher":
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# SplitSource: HDFS-block-analog catalog splits for the streaming executor
# ---------------------------------------------------------------------------

def _positive(name: str, value) -> int:
    if int(value) < 1:
        raise ValueError(f"{name} must be >= 1, got {value}")
    return int(value)


class SplitSource:
    """A finite, ordered sequence of catalog splits (each a ``[rows, d]`` or
    ``[rows]`` numpy array). The streamed dataset is *defined* as the row
    concatenation of its splits; the streaming executor pulls splits one at
    a time (prefetched), so only one split plus the accumulated partials
    need exist in memory. ``n_splits`` must be >= 1 (an empty dataset is one
    empty split)."""

    def n_splits(self) -> int:
        raise NotImplementedError

    def split(self, k: int) -> np.ndarray:
        raise NotImplementedError

    def materialize(self) -> np.ndarray:
        """The whole dataset at once (oracle/parity runs — defeats the point
        of streaming for anything big)."""
        return np.concatenate([np.atleast_1d(self.split(k))
                               for k in range(self.n_splits())], axis=0)


class ArraySplits(SplitSource):
    """An in-memory array cut at explicit row ``boundaries`` (or into
    ``n_splits`` near-equal chunks). ``ArraySplits(x)`` — one split — is the
    degenerate source ``run_job`` uses to delegate to the executor."""

    def __init__(self, items, n_splits: int = 1,
                 boundaries: "list[int] | None" = None):
        self.items = np.asarray(items)
        n = len(self.items)
        if boundaries is None:
            n_splits = max(1, min(int(n_splits), max(n, 1)))
            step = -(-max(n, 1) // n_splits)
            boundaries = list(range(step, n, step))[:n_splits - 1]
        bounds = [0, *sorted(int(b) for b in boundaries), n]
        if not all(0 <= b <= n for b in bounds):
            raise ValueError(f"split boundaries {bounds} outside 0..{n}")
        self._bounds = bounds

    def n_splits(self) -> int:
        return len(self._bounds) - 1

    def split(self, k: int) -> np.ndarray:
        return self.items[self._bounds[k]:self._bounds[k + 1]]


class MemmapCatalogSplits(SplitSource):
    """Row chunks of a packed float32 ``[n_rows, d]`` catalog file — the
    out-of-core source: each ``split`` reads one chunk through the page
    cache; nothing ever holds the whole catalog."""

    def __init__(self, path: str, d: int, rows_per_split: int):
        import os
        size = os.path.getsize(path)
        self.d = int(d)
        rem = size % (self.d * 4)
        if rem:
            raise ValueError(
                f"catalog file {path!r} is {size} bytes, not a multiple of "
                f"d*4 = {self.d * 4} ({rem} trailing bytes) — truncated or "
                f"corrupt; refusing to silently read a smaller catalog")
        self.arr = (np.zeros(0, np.float32)       # mmap rejects empty files
                    if size == 0
                    else np.memmap(path, dtype=np.float32, mode="r"))
        self.n_rows = self.arr.shape[0] // self.d
        self.rows_per_split = _positive("rows_per_split", rows_per_split)

    def n_splits(self) -> int:
        return max(1, -(-self.n_rows // self.rows_per_split))

    def split(self, k: int) -> np.ndarray:
        lo = k * self.rows_per_split
        hi = min(lo + self.rows_per_split, self.n_rows)
        return np.array(self.arr[lo * self.d:hi * self.d]
                        ).reshape(hi - lo, self.d)

    @staticmethod
    def write(path: str, rows: np.ndarray):
        np.asarray(rows, np.float32).tofile(path)


class SyntheticCatalogSplits(SplitSource):
    """Deterministic synthetic sky-catalog splits: split ``k`` is
    ``sky.make_catalog(rows_k, seed=mix(seed, k))``, so any split is
    regenerable independently (no catalog file, no coordination) and the
    streamed catalog is the concatenation of the per-split chunks."""

    def __init__(self, n_rows: int, rows_per_split: int, seed: int = 0):
        self.n_rows = int(n_rows)
        self.rows_per_split = _positive("rows_per_split", rows_per_split)
        self.seed = int(seed)

    def n_splits(self) -> int:
        return max(1, -(-self.n_rows // self.rows_per_split))

    def split(self, k: int) -> np.ndarray:
        from repro_torch.data import sky
        lo = k * self.rows_per_split
        rows = min(self.rows_per_split, self.n_rows - lo)
        return sky.make_catalog(max(rows, 0),
                                seed=(self.seed * 1_000_003 + k) & 0x7FFFFFFF)


class TokenBlockSplits(SplitSource):
    """Adapts a token source (``SyntheticTokens``/``MemmapTokens``) into
    wordcount-shaped splits: split ``k`` is rows
    ``[k*rows_per_split, (k+1)*rows_per_split)`` of the token matrix,
    flattened to ``[rows*seq_len, 1]`` float32 — the streaming executor's
    input schema."""

    def __init__(self, source, seq_len: int, rows_per_split: int,
                 n_splits: int, start_row: int = 0):
        self.source = source
        self.seq_len = int(seq_len)
        self.rows_per_split = _positive("rows_per_split", rows_per_split)
        self._n = _positive("n_splits", n_splits)
        self.start_row = int(start_row)

    def n_splits(self) -> int:
        return self._n

    def split(self, k: int) -> np.ndarray:
        block = self.source.block(self.start_row + k * self.rows_per_split,
                                  self.rows_per_split, self.seq_len)
        return np.asarray(block, np.float32).reshape(-1, 1)


class SpilledStreamSplits(SplitSource):
    """Reads spilled wire-dtype shuffle segments back as partition-range
    records — the read side of the external shuffle tier. Wraps anything
    with the ``SpillStore`` read interface (``n_ranges``, ``read_range``);
    "split" ``z`` is partition range ``z``.

    Protocol deviation, on purpose: ``split(z)`` returns the *merged range
    record dict* produced by ``SpillStore.read_range`` (host wire arrays +
    ``lo``/``hi`` partition bounds), not a raw ``[n, d]`` float32 catalog
    chunk — the segments hold post-map encoded streams, and decoding them
    back to rows would defeat the codec. Consumers are the streamed-reduce
    path in the executor, which feeds each record straight to
    ``shuffle_reduce_device_streamed``; ``materialize()`` is unsupported
    for the same reason.
    """

    def __init__(self, store):
        self.store = store

    def n_splits(self) -> int:
        return int(self.store.n_ranges)

    def split(self, z: int):
        return self.store.read_range(z)

    def materialize(self):
        raise TypeError(
            "SpilledStreamSplits yields encoded range records, not catalog "
            "rows; there is no meaningful row-matrix materialization")


# ---------------------------------------------------------------------------
# LM batch pipeline
# ---------------------------------------------------------------------------

@dataclass
class PipelineConfig:
    global_batch: int
    seq_len: int
    host_id: int = 0
    n_hosts: int = 1
    prefetch: int = 2
    start_step: int = 0


class Pipeline:
    """Host-local batch stream with background prefetch. Context manager:
    ``with Pipeline(src, cfg) as pipe: ...`` starts the prefetch thread on
    entry and always stops it on exit (tests can't leak the thread)."""

    def __init__(self, source, cfg: PipelineConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not split "
                             f"over {cfg.n_hosts} hosts")
        self.source = source
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._pf: Prefetcher | None = None

    def _row0(self, step: int) -> int:
        return (step * self.cfg.global_batch +
                self.cfg.host_id * self.local_batch)

    def batch_at(self, step: int) -> np.ndarray:
        """Deterministic random access (used for elastic replay + tests)."""
        return self.source.block(self._row0(step), self.local_batch,
                                 self.cfg.seq_len)

    def start(self):
        if self._pf is None:
            self._pf = Prefetcher(self.batch_at, depth=self.cfg.prefetch,
                                  start=self.cfg.start_step).start()
        return self

    def stop(self):
        if self._pf is not None:
            self._pf.stop()
            self._pf = None

    def __enter__(self) -> "Pipeline":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        self.start()
        while True:
            rec = self._pf.get()
            if rec is None:                     # unbounded source: no end
                return
            step, batch, _, _ = rec
            yield step, batch
