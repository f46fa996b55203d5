"""Split-streaming MapReduce executor: the four-stage pipeline
map -> combine -> shuffle -> reduce over HDFS-block-analog catalog splits.

The port of ``repro.mapreduce.executor``. A ``SplitSource``
(``data/pipeline.py``) feeds splits one at a time, each split runs the SAME
map/shuffle/reduce stages as the monolithic path (``run_jobs(jobs, xyz)``
is literally the one-split case), and two things keep memory and wall time
bounded:

- **Map-side combine** (Hadoop's Combiner). A pluggable ``Combiner`` merges
  per-split partials on the device, so only combined accumulators persist
  across splits. The default is derived from the ``Reducer``
  (``Reducer.combiner()``): wordcount's token histogram pre-aggregates each
  split to (token, count) rows before the shuffle, cutting shuffle wire
  bytes by the split's duplication factor. Reducers whose kernels couple
  rows across items (pair counting: a pair can span two splits) have no
  valid combiner; their splits accumulate as wire-dtype ``MappedSplit``
  streams and one global reduce runs at the end. Bit-identical either way
  for exact codecs: bucket contents are the same multisets and partition
  reductions are commutative integer sums.

- **Transfer/compute overlap** (double buffering). A ``Prefetcher`` thread
  fetches and pre-combines split k+1 and copies it to the card through a
  pinned buffer on a side CUDA stream (``_PinnedCopier``) while split k maps
  on the caller's stream. ``StageStats`` splits the I/O into
  ``fetch_wall_s`` (exposed: the executor actually waited) and
  ``overlap_hidden_s`` (hidden under compute), plus a per-split record
  stream for straggler analysis (``ft/stragglers.py``).

- **Concurrent lanes + fault tolerance** (``n_lanes=``, ``speculate=``,
  ``max_retries=``, ``deadline_s=``, ``chaos=``). A ``LanePool`` dispatches
  splits to worker threads, each running its whole life on a CUDA stream
  of its own (the kernels' wrappers launch on the current stream, so a
  lane's launches land on its stream), with Hadoop's reliability semantics:
  ``SpeculativePolicy`` verdicts clone the slow split onto a free lane and
  the first finisher commits (the loser is cancelled between stages),
  transient split failures retry with bounded backoff, a dead or wedged
  lane requeues its split on the survivors through the ``ft.Coordinator``
  liveness machine, and ``deadline_s`` bounds the job. On a machine of
  several cards, with no mesh and a device with no index, lane i runs on
  card i % D (``lane_devices``) and hands its outputs to the first card.

- **External shuffle** (``spill=``, ``mapreduce/spill.py``). Without a
  combiner, the accumulated wire streams spill to partition-range segment
  files once they exceed a byte budget, and the final reduce streams each
  range back through the pinned copier, one range resident at a time.

Every stage records a span on the current tracer (``obs/trace.py``,
a no-op ``NullTracer`` by default) and each run charges its joules to its
``StageStats`` through the current energy meter (``obs/energy.py``,
``NullMeter`` by default).

Entry points take ``device=None``, which means the card; with no card they
raise.

``mesh=`` composes with streaming: every rank streams every split, and each
split's reduce (combine mode) or the one final reduce (accumulate mode,
spilled or not) shards over the mesh's ``data`` axis with an all-reduce of
the partials (``job.py``). With lanes the collectives cannot run inside
them: a lane's commit order and its speculated clones differ from rank to
rank, and the ranks' collectives must match one for one. So under a mesh a
lane reduces its shard of a split without the all-reduce, the combine sums
those partials, and the sum crosses one all-reduce after the pool drains;
that needs the combiner's ``combine`` to be the plain sum. A lane issues
no collective at all: the auto knobs resolve from the mesh's one cost
model, agreed on at the entry point before any lane starts
(``job._entry_device``).

    src = MemmapCatalogSplits("catalog.f32", d=3, rows_per_split=1 << 20)
    res = run_job_streaming(neighbor_search_job(0.02, codec="int16"), src)
    res.stats.overlap_fraction, res.stats.n_splits
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import queue
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.core.cost_model import get_cost_model
from repro_torch.data.pipeline import Prefetcher, SplitSource
from repro_torch.ft.chaos import CancelledFetch, LaneDeath, TransientSplitError
from repro_torch.ft.coordinator import Coordinator, CoordinatorConfig
from repro_torch.ft.stragglers import SpeculativePolicy
from repro_torch.mapreduce.codecs import get_codec
from repro_torch.mapreduce.instrumentation import StageStats
from repro_torch.mapreduce.job import (JobResult, MappedSplit, StreamSummary,
                                       _data_axis_size, _entry_device,
                                       _fence, _psum_partials, _shard_ratios,
                                       concat_mapped,
                                       host_shuffle_reduce, map_timed,
                                       resolve_auto_job,
                                       shuffle_reduce_device,
                                       shuffle_reduce_device_streamed,
                                       validate_batch)
from repro_torch.mapreduce.spill import (SpillConfig, SpillStore,
                                         mapped_to_host, mapped_wire_nbytes,
                                         plan_bounds)
from repro_torch.obs.energy import get_meter
from repro_torch.obs.trace import get_tracer


# ---------------------------------------------------------------------------
# Combiner: the pluggable map-side combine stage
# ---------------------------------------------------------------------------

class Combiner:
    """Hadoop's map-side combine as a pluggable stage.

    ``precombine`` runs on the raw split BEFORE map/shuffle (inside the
    prefetch thread, so it overlaps compute) and may rewrite the split into
    an equivalent, smaller item stream: that is where shuffle bytes
    actually shrink. ``combine`` merges per-split reduce partials on the
    device; the base implementation is the commutative-monoid sum, correct
    for any reducer whose totals add.

    A combiner is only VALID when reduce(split A + split B) equals
    combine(reduce(A), reduce(B)): true for per-row folds like token
    counting, false for cross-row kernels like pair counting. The executor
    therefore derives defaults from ``Reducer.combiner()`` (None = no
    combine, accumulate the shuffle instead) rather than guessing.
    """

    name = "sum"

    def precombine(self, items: np.ndarray) -> np.ndarray:
        """Rewrite one raw split into an equivalent item stream (host side,
        runs in the prefetch thread). Default: unchanged."""
        return items

    def combine(self, acc, partials):
        """Merge a new tuple of per-job reduce partials into the running
        accumulator (tuples of tensors; ``acc`` is None on the first
        split)."""
        if acc is None:
            return partials
        return tuple(a + b for a, b in zip(acc, partials))


class _Agg:
    """Running padded/real cell + partition-count aggregation over splits."""

    def __init__(self):
        self.pair_pad = 0.0
        self.pair_real = 0.0
        self.owned_cells = 0.0
        self.shard_pad = None
        self.shard_real = None
        self.n_owned = None
        self.n_bucket = None

    def add(self, sd):
        self.pair_pad += sd.pair_cells
        self.pair_real += sd.real_pair_cells
        self.owned_cells += sd.owned_cells
        no = np.asarray(sd.n_owned, np.int64)
        nb = np.asarray(sd.n_bucket, np.int64)
        if self.n_owned is None:
            self.n_owned, self.n_bucket = no.copy(), nb.copy()
            self.shard_pad = np.array(sd.shard_pad, np.float64)
            self.shard_real = np.array(sd.shard_real, np.float64)
        else:
            self.n_owned += no
            self.n_bucket += nb
            self.shard_pad += sd.shard_pad
            self.shard_real += sd.shard_real

    def finish(self, stats: StageStats):
        stats.reduce_padded_ratio = (self.pair_pad / self.pair_real
                                     if self.pair_real else 1.0)
        if self.shard_pad is not None:
            stats.shard_padded_ratio = _shard_ratios(self.shard_pad,
                                                     self.shard_real)

    def summary(self) -> StreamSummary:
        return StreamSummary(self.n_owned, self.n_bucket,
                             pair_cells=self.pair_pad,
                             owned_cells=self.owned_cells,
                             real_pair_cells=self.pair_real)


def _resolve_combiner(combiner, jobs, codec):
    """None / "auto" / a ``Combiner`` instance -> the combiner to run (or
    None). "auto" derives from the reducers, and only engages when EVERY
    batched job provides one, they agree, and the codec is exact: a lossy
    codec quantizes the combiner's pre-aggregated counts into a different
    wire domain than the raw items, which would break streaming==monolithic
    parity silently. Pass an instance to force."""
    if combiner is None:
        return None
    if isinstance(combiner, Combiner):
        return combiner
    if combiner != "auto":
        raise ValueError(f"combiner must be None, 'auto', or a Combiner "
                         f"instance, got {combiner!r}")
    if not codec.exact:
        return None
    combs = [j.reducer.combiner() for j in jobs]
    if any(c is None for c in combs):
        return None
    if any(c != combs[0] for c in combs[1:]):
        return None
    return combs[0]


class _PinnedCopier:
    """Host -> card copies for a prefetch thread: the splits of a streamed
    run, and the spilled ranges of its read-back.

    Each split (or each range record's fields, any dtypes, one after
    another at 16-byte offsets) is written into a pinned staging buffer and
    copied with ``non_blocking`` copies on a side stream; an event marks
    the copy's end and is synchronized before the call returns, so the
    producer's ``prep_s`` covers the transfer. ONE buffer, grown to the
    largest item, is reused for every item: the next is written into it
    only after the previous copy's event has completed (a producer that
    returned before its copy ended would need a ring of depth + 1
    buffers).

    The destination tensor is allocated from the pool of the consumer's
    stream (the stream current where the copier was made), not the side
    stream's: that pool is warm across splits and runs, where a fresh side
    stream's pool would cost a ``cudaMalloc`` for every split. A block from
    that pool may have been freed by the consumer with reads of it still
    queued, so the side stream waits for the consumer's queued work before
    it writes. The consumer's stream then waits on the copy's event in
    ``receive``; the tensor belongs to its own stream, so no
    ``record_stream`` is needed when it is dropped."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.consumer = torch.cuda.current_stream(device)
        self.buf = None

    def __call__(self, items) -> tuple:
        """One split as float32 -> (card tensor, copy-done event)."""
        (out,), done = self.copy([np.asarray(items, np.float32)])
        return out, done

    def copy(self, arrays) -> tuple:
        """numpy arrays -> (tuple of card tensors, copy-done event)."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offs, total = [], 0
        for a in arrays:
            total = -(-total // 16) * 16         # a dtype view needs alignment
            offs.append(total)
            total += a.nbytes
        if self.buf is None or self.buf.numel() < total:
            self.buf = torch.empty(max(total, 16), dtype=torch.uint8,
                                   pin_memory=True)
        staged = self.buf.numpy()
        hosts = []
        for a, o in zip(arrays, offs):
            staged[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            hosts.append(self.buf[o:o + a.nbytes].view(dtype).view(a.shape))
        with torch.cuda.stream(self.consumer):
            outs = tuple(torch.empty(h.shape, dtype=h.dtype,
                                     device=self.device) for h in hosts)
        self.stream.wait_stream(self.consumer)
        with torch.cuda.stream(self.stream):
            for out, host in zip(outs, hosts):
                out.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return outs, done

    def receive(self, copied) -> torch.Tensor:
        out, done = copied
        torch.cuda.current_stream(self.device).wait_event(done)
        return out


# ---------------------------------------------------------------------------
# External shuffle: spill accumulated wire streams to disk, stream back
# ---------------------------------------------------------------------------

def _resolve_spill(spill) -> SpillConfig | None:
    """None -> off; a number -> ``SpillConfig(budget_bytes=number)``; a
    ``SpillConfig`` -> itself. A config whose budget is None/inf resolves
    to None: never spill, bit-identical to the accumulate path."""
    if spill is None:
        return None
    cfg = (spill if isinstance(spill, SpillConfig)
           else SpillConfig(budget_bytes=float(spill)))
    return cfg if cfg.enabled else None


class _ResidentMeter:
    """Thread-safe high-water meter of the spill tier's resident wire bytes
    (host-ified pending streams + in-flight writes + read-back ranges):
    what the acceptance bound ``peak <= budget + one chunk`` measures."""

    def __init__(self):
        self._lock = threading.Lock()
        self.cur = 0
        self.peak = 0

    def add(self, n: int):
        with self._lock:
            self.cur += int(n)
            if self.cur > self.peak:
                self.peak = self.cur

    def sub(self, n: int):
        with self._lock:
            self.cur -= int(n)


def _auto_ranges(cfg: SpillConfig, est_total_bytes: float, P: int,
                 device) -> int:
    """Read-back range count: ~4 ranges per budget's worth of estimated
    spill, so one range's resident bytes sit well inside the budget.
    ``n_ranges="auto"`` consults the cost model of ``device`` instead
    (fewest ranges whose per-range read-back fits the flush watermark:
    fewer replans, each with fixed dispatch overhead); an int forces it;
    None keeps the heuristic. Capped at ``P`` and ``max_ranges``."""
    if cfg.n_ranges == "auto":
        return get_cost_model(device=device).choose_spill_ranges(
            float(est_total_bytes), float(cfg.budget_bytes), int(P),
            int(cfg.max_ranges))
    if cfg.n_ranges is not None:
        z = int(cfg.n_ranges)
    else:
        z = int(np.ceil(4.0 * float(est_total_bytes)
                        / max(float(cfg.budget_bytes), 1.0)))
    return max(1, min(z, int(P), int(cfg.max_ranges)))


def _range_record_nbytes(rec: dict) -> int:
    n = sum(int(p.nbytes) for p in rec["payloads"])
    n += (int(rec["keys"].nbytes) + int(rec["dest_eff"].nbytes)
          + int(rec["src"].nbytes))
    if rec["skey"] is not None:
        n += int(rec["skey"].nbytes)
    return n


def _streamed_reduce(store: SpillStore, meter: _ResidentMeter, jobs, P: int,
                     stats: StageStats, device, mesh):
    """Sweep staged litter (cancelled clones, faulted writers), then stream
    every committed partition range back through a ``Prefetcher`` double
    buffer (the read of range z+1, and on the card its copy through the
    pinned copier on a side stream, hidden under range z's
    shuffle+reduce) into ``shuffle_reduce_device_streamed``, and record
    the spill accounting. Exposed read waits land in ``spill_wall_s``;
    hidden prefetch time in ``overlap_hidden_s``. Each range's wire bytes
    leave the meter as soon as its reduce returns, so peak residency is
    O(one range)."""
    store.sweep_staged()
    stats.spill_ranges = store.n_ranges
    copier = _PinnedCopier(device) if device.type == "cuda" else None

    def produce(z):
        with get_tracer().span("spill-read", cat="io", range=z):
            rec = store.read_range(z)
        nb = _range_record_nbytes(rec)
        meter.add(nb)
        fields = (*rec["payloads"], rec["keys"], rec["dest_eff"], rec["src"])
        if rec["skey"] is not None:
            fields += (rec["skey"],)
        moved = (copier.copy(fields) if copier is not None
                 else tuple(torch.as_tensor(f, device=device)
                            for f in fields))
        return rec, moved, nb

    def ranges():
        with Prefetcher(produce, depth=1, n=store.n_ranges) as pf:
            while (got := pf.get()) is not None:
                _, (rec, moved, nb), wait, prep = got
                stats.spill_wall_s += wait
                stats.overlap_hidden_s += max(prep - wait, 0.0)
                t = copier.receive(moved) if copier is not None else moved
                k = len(rec["payloads"])
                yield rec["lo"], rec["hi"], MappedSplit(
                    payloads=t[:k], keys=t[k], dest_eff=t[k + 1],
                    src=t[k + 2], skey=t[k + 3] if len(t) > k + 3 else None,
                    n_rows=int(rec["n_rows"]), d=int(rec["d"]), nbytes_in=0)
                meter.sub(nb)

    out = shuffle_reduce_device_streamed(jobs, ranges(), P, stats, device,
                                         mesh)
    stats.spill_bytes += store.bytes_written
    stats.spill_chunk_bytes = store.max_chunk_bytes
    stats.spill_peak_bytes = meter.peak
    return out


def _spill_root(cfg: SpillConfig, mesh) -> str:
    """A fresh temporary directory, or ``cfg.dir``; under a mesh a
    directory of the rank's own inside it (each rank spills its copy of
    the streams, and each store removes its root when it closes)."""
    if cfg.dir is None:
        return tempfile.mkdtemp(prefix="mr-spill-")
    if mesh is None:
        return cfg.dir
    return os.path.join(cfg.dir, f"rank{torch.distributed.get_rank()}")


class _SpillRuntime:
    """Sequential-path spill runtime for device accumulate mode.

    Double-buffered in the Hadoop ``io.sort.mb`` spirit: mapped splits
    host-ify into a pending buffer; when it crosses HALF the budget it is
    handed to the store's async writer (one buffer filling while one
    drains) with at most one chunk in flight, so resident wire bytes stay
    bounded by the budget plus one chunk. A chunk bigger than half the
    budget is written synchronously instead of overlapped: tiny budgets
    degrade gracefully to spill-every-split, budget=0 included. If the run
    finishes without ever crossing the threshold, ``finish`` falls back to
    the monolithic concat+reduce (enabling spill with a roomy budget costs
    only the host-ify copies and the copies back)."""

    def __init__(self, cfg: SpillConfig, P: int, K: int, stats: StageStats,
                 device, mesh):
        self.cfg = cfg
        self.P = int(P)
        self.K = int(K)
        self.stats = stats
        self.device = device
        self.mesh = mesh
        self.budget = float(cfg.budget_bytes)
        self.meter = _ResidentMeter()
        self.pending: list = []
        self.pending_bytes = 0
        self.splits_seen = 0
        self.n_submitted = 0
        self.exposed_wait_s = 0.0
        self.store: SpillStore | None = None
        self._inflight = collections.deque()   # wire bytes per async chunk

    def _ensure_store(self) -> SpillStore:
        if self.store is None:
            self.store = SpillStore(_spill_root(self.cfg, self.mesh),
                                    self.P, write_fault=self.cfg.write_fault,
                                    on_written=self._on_written)
        return self.store

    def _on_written(self, chunk):
        # writer thread: the chunk's host buffers are on disk and dropped
        if self._inflight:
            self.meter.sub(self._inflight.popleft())

    def add(self, m: MappedSplit):
        """Host-ify one mapped split (its device buffers die with the
        caller's reference) and spill when the pending buffer fills."""
        t0 = time.perf_counter()
        h = mapped_to_host(m)
        self.stats.spill_wall_s += time.perf_counter() - t0
        nb = mapped_wire_nbytes(h)
        if self.pending and self.pending_bytes + nb > self.budget / 2:
            self._flush()                  # keep the filling buffer bounded
        self.meter.add(nb)
        self.pending.append(h)
        self.pending_bytes += nb
        self.splits_seen += 1
        if self.pending_bytes > self.budget / 2:
            self._flush()

    def _flush(self):
        if not self.pending:
            return
        store = self._ensure_store()
        if store._bounds is None:
            # first flush plans the range bounds: weight partitions by this
            # chunk's bucket counts, extrapolate total spill from the
            # splits seen so far
            w = np.zeros(self.P, np.float64)
            for h in self.pending:
                w += np.bincount(h.dest_eff, minlength=self.P + 1)[:self.P]
            est = self.pending_bytes * self.K / max(self.splits_seen, 1)
            store.set_bounds(plan_bounds(
                w, _auto_ranges(self.cfg, est, self.P, self.device)))
        t0 = time.perf_counter()
        store.wait_writes()                    # <= 1 chunk in flight
        chunk_bytes = self.pending_bytes
        self._inflight.append(chunk_bytes)
        store.submit_chunk(self.pending)
        self.n_submitted += 1
        self.stats.spilled_splits += len(self.pending)
        self.pending = []
        self.pending_bytes = 0
        if chunk_bytes > self.budget / 2:
            store.wait_writes()                # no room to overlap: go sync
        self.exposed_wait_s += time.perf_counter() - t0

    def finish(self, jobs, stats: StageStats):
        """Final reduce: streamed per-range read-back when anything
        spilled, else the monolithic concat path over the pending streams,
        copied back to the device. Same return shape as
        ``shuffle_reduce_device``."""
        if self.n_submitted == 0:
            stats.spill_peak_bytes = self.meter.peak
            back = [_mapped_to_device(h, self.device) for h in self.pending]
            return shuffle_reduce_device(jobs, concat_mapped(back), self.P,
                                         stats, self.device, self.mesh)
        self._flush()                          # remainder chunk
        store = self.store
        t0 = time.perf_counter()
        store.wait_writes()
        self.exposed_wait_s += time.perf_counter() - t0
        out = _streamed_reduce(store, self.meter, jobs, self.P, stats,
                               self.device, self.mesh)
        stats.spill_wall_s += self.exposed_wait_s
        stats.overlap_hidden_s += max(
            store.write_wall_s - self.exposed_wait_s, 0.0)
        return out

    def close(self):
        """Reclaim the spill directory: on success, after a write fault and
        on any other exit (the executor calls this in a ``finally``)."""
        if self.store is not None:
            self.store.close()


def _mapped_to_device(h: MappedSplit, device) -> MappedSplit:
    def dev(a):
        return torch.as_tensor(a, device=device)
    return MappedSplit(
        payloads=tuple(dev(p) for p in h.payloads), keys=dev(h.keys),
        dest_eff=dev(h.dest_eff), src=dev(h.src),
        skey=None if h.skey is None else dev(h.skey),
        n_rows=h.n_rows, d=h.d, nbytes_in=h.nbytes_in)


# ---------------------------------------------------------------------------
# LanePool: concurrent split lanes + executed speculative re-execution
# ---------------------------------------------------------------------------

class LaneCancelled(Exception):
    """Internal control flow: a losing attempt noticed its cancel event
    between stages and unwound; its partial buffers are dropped."""


class JobDeadlineExceeded(TimeoutError):
    """The per-job ``deadline_s`` elapsed before every split committed."""


#: exceptions a lane treats as transient: re-dispatched with bounded
#: backoff up to ``max_retries`` (Hadoop's per-task retry budget)
RETRYABLE = (TransientSplitError, OSError)


@dataclasses.dataclass
class _LaneTask:
    """One dispatchable unit: run ``fn(cancel_event)`` for split ``key``."""
    key: int
    fn: object
    attempt: int = 0
    clone: bool = False


_LANE = threading.local()      # the device of the lane this thread runs


def current_lane_device(default):
    """The device this thread's lane is pinned to (``LanePool`` sets it for
    its lanes' whole life), else ``default``."""
    return getattr(_LANE, "device", None) or default


def lane_devices(device: torch.device, *, mesh, on_device: bool) -> list:
    """The devices ``run_jobs_streaming``'s lanes are pinned to, lane i to
    the i % D-th: every card of the machine for the device engine on CUDA
    with no mesh, more than one card and a caller device with no index
    (``device=None`` or ``"cuda"``), as the reference pins lanes over every
    device it sees; else ``[device]``. An explicit ``cuda:k`` keeps that
    card, as the caller asked; the host engine, and every run under a mesh
    (one card a rank), keep theirs."""
    if (on_device and mesh is None and device.type == "cuda"
            and device.index is None and torch.cuda.device_count() > 1):
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _mapped_to(m: MappedSplit, device) -> MappedSplit:
    """``m`` with every tensor on ``device`` (itself where they are). A
    tensor crosses cards contiguous (``skey`` is a column view of the
    split), so the copy is a peer memcpy on the source card's stream, not
    a strided copy kernel that reads one card's memory from another."""
    def to(t):
        return None if t is None else t.contiguous().to(device)
    return dataclasses.replace(
        m, payloads=tuple(to(p) for p in m.payloads), keys=to(m.keys),
        dest_eff=to(m.dest_eff), src=to(m.src), skey=to(m.skey))


@dataclasses.dataclass
class _Lane:
    """One worker lane: a thread, optionally pinned to a device and running
    on a CUDA stream of its own."""
    id: int
    thread: threading.Thread | None = None
    stream: object = None           # the lane's CUDA stream (None off the card)
    alive: bool = True
    declared_dead: bool = False     # liveness machine gave up on it
    last_beat: float = 0.0
    n_tasks: int = 0
    busy_s: float = 0.0
    dead_reason: str = ""


class LanePool:
    """Concurrent split lanes with first-finisher-wins speculative cloning:
    the scheduler that turns ``ft.SpeculativePolicy`` from advisory into
    executed (Hadoop's speculative task re-execution).

    ``n_lanes`` worker threads pull ``_LaneTask``s off one priority queue
    (clones outrank fresh work: a speculation that queues behind the
    backlog can never win). Per key, the FIRST attempt to finish commits:
    its payload lands in ``results`` and the pool's ``on_commit`` hook runs
    under the lock, on the committing lane's thread (and so on its
    stream). Every other in-flight attempt for that key is cancelled via
    its ``threading.Event`` (task fns poll it between stages; chaos-injected
    stalls poll it mid-sleep), so the loser unwinds and its buffers die
    with the frame. Commutative merge contracts make the result
    bit-identical whichever attempt wins.

    ``devices``: torch devices the lanes are pinned to (lane i -> device
    i % D); a task reads its lane's with ``current_lane_device``. A lane on
    a CUDA device makes it the thread's current device and runs its whole
    life inside ``torch.cuda.stream`` of a stream of its own: PyTorch's
    current device and stream are per thread, and the kernels' wrappers
    launch on them.

    Failure ladder, per task:

    - ``RETRYABLE`` (transient fetch errors): re-dispatched with bounded
      exponential backoff, up to ``max_retries``; the budget's last failure
      becomes the run's fatal error.
    - ``LaneDeath``: the lane marks itself dead, requeues the task onto the
      surviving lanes at clone priority, and its thread exits: the pool
      *shrinks* instead of hanging.
    - anything else: fatal; ``drain`` raises it.

    ``drain`` is the control loop (runs on the caller's thread): it feeds
    lane heartbeats into an ``ft.Coordinator`` (heartbeat -> degraded ->
    remesh) and executes its verdicts (remesh = declare stuck lanes dead,
    cancel and requeue their work; abort = every lane is gone), enforces
    the per-job ``deadline_s``, and drives the speculation policy: per tick
    it reports ``running(split, elapsed)`` for in-flight splits and
    executes ``propose()``'s verdict by cloning the slow split onto a free
    lane.

    Context manager: exit joins every lane thread and (on a clean exit)
    raises if any survived the join: the no-leaked-threads guarantee that
    pairs with ``Prefetcher.stop``'s stuck-fetch error.
    """

    def __init__(self, n_lanes: int, *, policy: SpeculativePolicy | None = None,
                 chaos=None, max_retries: int = 2, backoff_s: float = 0.02,
                 deadline_s: float | None = None, devices=None,
                 liveness_cfg: CoordinatorConfig | None = None,
                 stuck_after_s: float | None = None, on_commit=None,
                 join_timeout_s: float = 30.0, name: str = "lane"):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        self.n_lanes = int(n_lanes)
        self.policy = policy
        self.chaos = chaos
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.deadline_s = deadline_s
        self.devices = [torch.device(d) for d in devices] if devices else None
        self.stuck_after_s = stuck_after_s
        self.on_commit = on_commit
        self.join_timeout_s = float(join_timeout_s)
        self._clock = time.perf_counter
        self._q: queue.PriorityQueue = queue.PriorityQueue()
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._fatal: BaseException | None = None
        self._inflight: dict[int, dict] = {}        # id(task) -> record
        self._by_key: dict[int, list] = {}
        self.submitted: set[int] = set()
        self.results: dict[int, object] = {}
        self.meta: dict[int, dict] = {}             # key -> winning attempt info
        self.retries = 0
        self.speculated = 0
        self.clone_wins = 0
        self.cancelled = 0
        self.dup_drops = 0
        self.lane_deaths = 0
        self.remeshes: list[dict] = []
        self.liveness = Coordinator(
            list(range(self.n_lanes)),
            liveness_cfg or CoordinatorConfig(heartbeat_timeout=0.05,
                                              misses_to_degrade=2,
                                              misses_to_dead=4, min_hosts=1))
        now = self._clock()
        self.lanes = [_Lane(i, last_beat=now) for i in range(self.n_lanes)]
        for lane in self.lanes:
            lane.thread = threading.Thread(
                target=self._worker, args=(lane,),
                name=f"{name}-{lane.id}", daemon=True)
            lane.thread.start()

    # -- submission / results ------------------------------------------------

    @property
    def width(self) -> int:
        """Lanes still alive (the pool shrinks on lane death)."""
        return sum(lane.alive for lane in self.lanes)

    def submit(self, key: int, fn, *, clone: bool = False):
        with self._lock:
            self._submit_locked(_LaneTask(int(key), fn, clone=clone))

    def _submit_locked(self, task: _LaneTask):
        self.submitted.add(task.key)
        # clones and re-dispatches jump the queue: priority 0 beats 1
        self._q.put((0 if (task.clone or task.attempt) else 1,
                     next(self._seq), task))

    # -- the worker lanes ----------------------------------------------------

    def _lane_ctx(self, lane: _Lane):
        """Pin this lane's thread to its device (``current_lane_device``)
        and, on a card, make that card the thread's current device and a
        CUDA stream of its own its current stream, for the thread's whole
        life."""
        if not self.devices:
            return contextlib.nullcontext()
        dev = self.devices[lane.id % len(self.devices)]
        _LANE.device = dev
        if dev.type != "cuda":
            return contextlib.nullcontext()
        if dev.index is not None:
            torch.cuda.set_device(dev)
        lane.stream = torch.cuda.Stream(dev)
        return torch.cuda.stream(lane.stream)

    def _worker(self, lane: _Lane):
        with self._lane_ctx(lane):
            while not self._stop.is_set():
                try:
                    _, _, task = self._q.get(timeout=0.01)
                except queue.Empty:
                    lane.last_beat = self._clock()
                    continue
                with self._lock:
                    if task.key in self.results or self._fatal is not None:
                        continue            # stale: this split already won
                    cancel = threading.Event()
                    rec = {"task": task, "lane": lane.id,
                           "t0": self._clock(), "cancel": cancel}
                    self._inflight[id(task)] = rec
                    self._by_key.setdefault(task.key, []).append(rec)
                lane.n_tasks += 1
                t0 = self._clock()
                requeue = None
                dead = False
                tr = get_tracer()
                try:
                    # the lane-exec span closes in its finally even when the
                    # task dies mid-stage (chaos kill, cancel, transient
                    # fault); the exception then continues into the ladder
                    # below with every opened span closed
                    with tr.ids(lane=lane.id, split=task.key), \
                         tr.span("lane-exec", cat="lane", lane=lane.id,
                                 split=task.key, attempt=task.attempt,
                                 clone=task.clone):
                        if self.chaos is not None:
                            self.chaos.on_task_start(lane.id, task.key,
                                                     task.attempt, cancel)
                        out = task.fn(cancel)
                except (LaneCancelled, CancelledFetch):
                    with self._lock:
                        self.cancelled += 1
                except LaneDeath as e:
                    with self._lock:
                        lane.alive = False
                        lane.dead_reason = str(e)
                        self.lane_deaths += 1
                        # the dying lane's split must not be lost: requeue a
                        # fresh copy onto the survivors at clone priority
                        self._submit_locked(dataclasses.replace(task))
                    dead = True
                except RETRYABLE as e:
                    if task.attempt >= self.max_retries:
                        with self._lock:
                            if self._fatal is None:
                                self._fatal = e
                    else:
                        requeue = dataclasses.replace(task,
                                                      attempt=task.attempt + 1)
                except BaseException as e:   # drain re-raises it on the caller
                    with self._lock:
                        if self._fatal is None:
                            self._fatal = e
                else:
                    self._commit(task, out, self._clock() - t0, lane)
                finally:
                    with self._lock:
                        self._inflight.pop(id(task), None)
                        self._by_key.get(task.key, [])[:] = [
                            r for r in self._by_key.get(task.key, ())
                            if r["task"] is not task]
                    lane.busy_s += self._clock() - t0
                    lane.last_beat = self._clock()
                if dead:
                    return
                if requeue is not None:
                    # bounded exponential backoff, interruptible on shutdown
                    with tr.span("retry", cat="lane", lane=lane.id,
                                 split=task.key, attempt=requeue.attempt):
                        self._stop.wait(self.backoff_s * (2 ** task.attempt))
                    with self._lock:
                        self.retries += 1
                        self._submit_locked(requeue)

    def _commit(self, task: _LaneTask, out, wall_s: float, lane: _Lane):
        with self._lock:
            if task.key in self.results:
                self.dup_drops += 1     # lost the race; buffers die here
                return
            meta = {"lane": lane.id, "attempt": task.attempt,
                    "clone": task.clone, "wall_s": wall_s}
            self.results[task.key] = out
            self.meta[task.key] = meta
            if task.clone:
                self.clone_wins += 1
                get_tracer().instant("clone-win", cat="lane",
                                     split=task.key, lane=lane.id)
            for rec in self._by_key.get(task.key, ()):
                if rec["task"] is not task:
                    rec["cancel"].set()         # losers: unwind between stages
            if self.policy is not None:
                self.policy.finished(task.key, wall_s)
            if self.on_commit is not None:
                self.on_commit(task.key, out, meta)

    # -- the control loop: liveness, deadline, speculation -------------------

    def drain(self, keys=None, *, make_task_fn=None, tick_s: float = 0.002):
        """Block until every key has committed (default: everything
        submitted). Runs the lane-liveness state machine, the per-job
        deadline, and the speculation policy; raises the first fatal error,
        ``JobDeadlineExceeded``, or abort (all lanes dead)."""
        t_start = self._clock()
        while True:
            with self._lock:
                want = set(self.submitted if keys is None else keys)
                fatal = self._fatal
                done = want <= self.results.keys()
            if fatal is not None:
                raise fatal
            if done:
                return
            now = self._clock()
            if (self.deadline_s is not None
                    and now - t_start > self.deadline_s):
                missing = sorted(want - set(self.results))
                raise JobDeadlineExceeded(
                    f"job deadline {self.deadline_s}s exceeded with splits "
                    f"{missing} uncommitted ({self.width}/{self.n_lanes} "
                    f"lanes alive)")
            self._liveness_tick(now)
            self._speculate(now, make_task_fn)
            time.sleep(tick_s)

    def _liveness_tick(self, now: float):
        coord = self.liveness
        with self._lock:
            for lane in self.lanes:
                beating = lane.alive and (
                    self.stuck_after_s is None
                    or now - lane.last_beat <= self.stuck_after_s)
                if beating:
                    coord.heartbeat(lane.id, now)
            act = coord.tick(now)
            if act["action"] == "remesh":
                for lid in act["dead"]:
                    lane = self.lanes[lid]
                    lane.declared_dead = True
                    if lane.alive:
                        # stuck, not self-reported: give up on it; cancel
                        # its in-flight work and requeue fresh copies
                        lane.alive = False
                        lane.dead_reason = (lane.dead_reason
                                            or "no heartbeat (stuck)")
                        for rec in list(self._inflight.values()):
                            if rec["lane"] == lid:
                                rec["cancel"].set()
                                self._submit_locked(
                                    dataclasses.replace(rec["task"]))
                self.remeshes.append(act)
                coord.remesh_done()
            elif act["action"] == "abort":
                if self._fatal is None:
                    self._fatal = RuntimeError(
                        "every lane is dead: "
                        + "; ".join(f"lane {ln.id}: {ln.dead_reason}"
                                    for ln in self.lanes if not ln.alive))

    def _speculate(self, now: float, make_task_fn):
        if self.policy is None:
            return
        with self._lock:
            earliest: dict[int, float] = {}
            for rec in self._inflight.values():
                k = rec["task"].key
                earliest[k] = min(earliest.get(k, rec["t0"]), rec["t0"])
            for k, t0 in earliest.items():
                if k not in self.results:
                    self.policy.running(k, now - t0)
            verdict = self.policy.propose()
            if verdict["action"] == "speculate" and make_task_fn is not None:
                k = verdict["split"]
                self.speculated += 1
                get_tracer().instant("clone-race", cat="lane", split=k)
                self._submit_locked(_LaneTask(k, make_task_fn(k), clone=True))

    # -- shutdown ------------------------------------------------------------

    def shutdown(self, *, check: bool = True):
        self._stop.set()
        with self._lock:
            for rec in self._inflight.values():
                rec["cancel"].set()
        leaked = []
        for lane in self.lanes:
            if lane.thread is not None:
                lane.thread.join(timeout=self.join_timeout_s)
                if lane.thread.is_alive():
                    leaked.append(lane.id)
        if leaked and check:
            raise RuntimeError(
                f"LanePool shutdown leaked lane thread(s) {leaked}: still "
                f"running {self.join_timeout_s}s after stop; a task is "
                f"ignoring its cancel event")

    def __enter__(self) -> "LanePool":
        return self

    def __exit__(self, exc_type, exc, tb):
        # on the error path, still stop + join but don't let a leak report
        # mask the original failure
        self.shutdown(check=exc_type is None)


# ---------------------------------------------------------------------------
# The streaming executor
# ---------------------------------------------------------------------------

def _resolve_policy(speculate) -> SpeculativePolicy | None:
    """None/False -> off; True -> default policy; a ``SpeculativeConfig``
    or ``SpeculativePolicy`` -> that policy."""
    if not speculate:
        return None
    if isinstance(speculate, SpeculativePolicy):
        return speculate
    if speculate is True:
        return SpeculativePolicy()
    return SpeculativePolicy(speculate)      # a SpeculativeConfig


def run_jobs_streaming(jobs, source: SplitSource, *, mesh=None,
                       engine: str = "auto", combiner="auto",
                       prefetch: int = 2,
                       straggler_monitor=None, n_lanes: int = 1,
                       speculate=None, chaos=None, max_retries: int = 0,
                       retry_backoff_s: float = 0.05,
                       deadline_s: float | None = None, spill=None,
                       device=None) -> list[JobResult]:
    """Stream every split of ``source`` through map -> combine -> shuffle ->
    reduce and return one ``JobResult`` per job (all sharing one
    ``StageStats`` with per-split records).

    - ``combiner="auto"`` derives the map-side combine from the reducers
      (see ``_resolve_combiner``); ``None`` disables it (splits accumulate
      as wire-dtype streams, one global reduce at the end); a ``Combiner``
      instance forces it.
    - ``prefetch`` is the double-buffer depth: > 0 fetches split k+1 on a
      background thread (and, on the card, copies it there on a side
      stream) while split k computes (``overlap_hidden_s`` records what
      that hid); 0 runs synchronously (what ``run_jobs`` uses for its
      one-split delegate).
    - ``straggler_monitor`` (``ft.StragglerMonitor``) receives
      ``record(split_index, split_wall_s)`` per split.
    - ``device=None`` means the card; pass ``device="cpu"`` for the plain
      versions.
    - ``mesh`` (a ``DeviceMesh`` with a ``"data"`` axis): every rank calls
      this with the same arguments; each split's (or the final) reduce
      shards over ``data`` with an all-reduce of the partials, and every
      rank returns the same results (module docstring for lanes).

    Lane execution (any of the following engages the ``LanePool`` path;
    the default is the sequential prefetched pipeline above):

    - ``n_lanes > 1``: splits dispatch concurrently over worker lanes, each
      on a CUDA stream of its own on the card.
    - ``speculate``: True / ``SpeculativeConfig`` / ``SpeculativePolicy``;
      the policy's verdicts are EXECUTED: a slow split is cloned onto a
      free lane, first finisher wins, the loser is cancelled between
      stages. Bit-identical results either way (commutative merges).
    - ``chaos`` (``ft.LaneChaos``): injected lane deaths/delays; a dead
      lane's work requeues onto the survivors and the pool shrinks.
    - ``max_retries`` / ``retry_backoff_s``: per-split transient-fault
      retry budget with bounded exponential backoff.
    - ``deadline_s``: per-job deadline: ``JobDeadlineExceeded`` instead of
      a hang when splits cannot finish.

    ``spill`` (a byte budget or a ``SpillConfig``) engages the external
    shuffle tier for device-engine accumulate mode (no valid combiner):
    when the accumulated wire streams exceed the budget they spill to
    partition-range-bucketed segment files and the final reduce streams
    each range back through a prefetch double buffer: peak resident wire
    bytes O(spill chunk) instead of O(catalog/codec ratio), bit-identical
    for any budget (0 = spill everything, None/inf = never spill, the same
    as off). When a combiner is active nothing accumulates, so ``spill`` is
    a no-op; the host engine rejects it. With lanes, every split's stream
    spills at map time (segments commit with the split, so retried/cloned
    splits stay lane-safe). Spill files live under ``SpillConfig.dir`` (a
    fresh temp dir by default) and are reclaimed on exit, success or
    failure.

    The partition space must be split-independent (``n_partitions`` is read
    from the first split): true for the stock zone/hash partitioners.
    """
    if not jobs:
        return []
    device = _entry_device(device, mesh)
    # codec="auto" materializes here, BEFORE signature validation: every
    # downstream get_codec/shuffle_signature sees a concrete codec. The
    # cost model only picks among exact codecs, so results cannot change.
    jobs = [resolve_auto_job(j, device) for j in jobs]
    validate_batch(jobs)
    if engine == "auto":
        engine = "device"
    if engine not in ("device", "host"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'auto', 'device', or 'host'")
    spill_cfg = _resolve_spill(spill)
    on_device = engine == "device"
    if spill_cfg is not None and not on_device:
        raise ValueError("spill= requires the device engine: the spill "
                         "tier stores wire-dtype encoded streams")
    j0 = jobs[0]
    codec = get_codec(j0.codec)
    part = j0.partitioner
    comb = _resolve_combiner(combiner, jobs, codec)
    if comb is not None:
        spill_cfg = None     # combine mode never accumulates: nothing to spill
    K = int(source.n_splits())
    stats = StageStats(job="+".join(j.name for j in jobs), engine=engine,
                       codec=codec.name, device=str(device), n_splits=K,
                       combiner=comb.name if comb else "")
    policy = _resolve_policy(speculate)
    tr = get_tracer()
    meter = get_meter()
    mtok = meter.begin()
    t_job0 = time.perf_counter()
    if (n_lanes > 1 or policy is not None or chaos is not None
            or max_retries > 0 or deadline_s is not None):
        out = _run_jobs_lanes(
            jobs, source, mesh=mesh, device=device, on_device=on_device,
            codec=codec, part=part, comb=comb, K=K, stats=stats,
            straggler_monitor=straggler_monitor, n_lanes=max(1, int(n_lanes)),
            policy=policy, chaos=chaos, max_retries=max_retries,
            retry_backoff_s=retry_backoff_s, deadline_s=deadline_s,
            spill_cfg=spill_cfg)
        if tr.enabled:
            tr.record("job", t_job0, time.perf_counter(), cat="job",
                      job=stats.job, mode="lanes")
        meter.attribute(mtok, stats)
        return out

    def fetch(k):
        # -> (items, raw_rows, raw_bytes): the RAW split size is carried
        # alongside so n_items/map_bytes report what was actually fetched,
        # not the combiner's pre-aggregated rewrite
        s = source.split(k)
        raw_rows, raw_bytes = len(s), int(np.asarray(s).nbytes)
        if comb is not None:
            s = comb.precombine(s)
        return s, raw_rows, raw_bytes

    copier = None
    if K > 1 and prefetch > 0 and on_device and device.type == "cuda":
        copier = _PinnedCopier(device)

    def fetch_to_device(k):
        # runs on the prefetch thread: host I/O, precombine, AND (on the
        # card) the host -> card copy all overlap the caller's compute
        with tr.span("fetch", cat="io", split=k):
            s, raw_rows, raw_bytes = fetch(k)
            return (s if copier is None else copier(s)), raw_rows, raw_bytes

    def synchronous():
        for k in range(K):
            t0 = time.perf_counter()
            item = fetch(k)
            dt = time.perf_counter() - t0
            yield k, item, dt, dt

    acc = None
    mapped = []
    host_items = []
    recs = []
    agg = _Agg()
    raw_items_total = 0
    raw_bytes_total = 0
    P = None
    spill_rt = None

    def consume(k, item, wait_s, prep_s):
        nonlocal acc, P, raw_items_total, raw_bytes_total, spill_rt
        items_k, raw_rows, raw_bytes = item
        if copier is not None:
            items_k = copier.receive(items_k)
        raw_items_total += raw_rows
        raw_bytes_total += raw_bytes
        stats.fetch_wall_s += wait_s
        stats.overlap_hidden_s += max(prep_s - wait_s, 0.0)
        if tr.enabled and wait_s > 0:
            # the wait just ended: record the exposed fetch stall span
            # retroactively (the hidden part already traced as "fetch" on
            # the prefetch thread)
            t_now = tr.now()
            tr.record("fetch-wait", t_now - wait_s, t_now, cat="io", split=k)
        if P is None:
            P = int(part.n_partitions(items_k))
        rec = {"split": k, "n_items": raw_rows, "fetch_wait_s": wait_s,
               "fetch_prep_s": prep_s}
        m0, s0, r0 = stats.map_wall_s, stats.shuffle_wall_s, stats.reduce_wall_s
        if on_device:
            m = map_timed(part, codec, items_k, P, device, stats)
            if comb is None:
                if spill_cfg is not None:
                    if spill_rt is None:
                        spill_rt = _SpillRuntime(spill_cfg, P, K, stats,
                                                 device, mesh)
                    spill_rt.add(m)      # host-ify + maybe flush to disk
                else:
                    mapped.append(m)
            else:
                totals, sd = shuffle_reduce_device(jobs, m, P, stats, device,
                                                   mesh)
                agg.add(sd)
                acc = _combine(comb, acc, totals, stats, device, k)
        else:
            items_h = np.asarray(items_k)
            if comb is None:
                host_items.append(items_h)
            else:
                totals, sd = host_shuffle_reduce(jobs, items_h, stats, device,
                                                 mesh)
                agg.add(sd)
                acc = _combine(comb, acc, totals, stats, device, k)
        rec["map_s"] = stats.map_wall_s - m0
        rec["shuffle_s"] = stats.shuffle_wall_s - s0
        rec["reduce_s"] = stats.reduce_wall_s - r0
        # the split's own end-to-end cost: its fetch/transfer work (prep, as
        # measured in the producer whether or not it was hidden) plus its
        # processing walls. In accumulate mode processing is deferred to the
        # one global reduce, so per-split cost is I/O-dominated: exactly
        # the signal Hadoop's speculative execution watches.
        rec["wall_s"] = (prep_s + rec["map_s"] + rec["shuffle_s"]
                         + rec["reduce_s"])
        recs.append(rec)
        if straggler_monitor is not None:
            straggler_monitor.record(k, rec["wall_s"])

    try:
        if K > 1 and prefetch > 0:
            produce = fetch_to_device if on_device else fetch
            with Prefetcher(produce, depth=prefetch, n=K) as pf:
                while (got := pf.get()) is not None:
                    with tr.ids(split=got[0]):
                        consume(*got)
        else:
            for got in synchronous():
                with tr.ids(split=got[0]):
                    consume(*got)
        if len(recs) != K:
            raise RuntimeError(f"{len(recs)} of {K} splits consumed")

        if comb is None:
            # no valid map-side combine: the accumulated wire-format streams
            # cross ONE global shuffle+reduce (Hadoop's reduce-after-last-map),
            # streamed per partition range from disk when they spilled
            if on_device:
                if spill_rt is not None:
                    totals, sd = spill_rt.finish(jobs, stats)
                else:
                    totals, sd = shuffle_reduce_device(
                        jobs, concat_mapped(mapped), P, stats, device, mesh)
            else:
                items_all = (host_items[0] if len(host_items) == 1
                             else np.concatenate(host_items, axis=0))
                totals, sd = host_shuffle_reduce(jobs, items_all, stats,
                                                 device, mesh)
            agg.add(sd)
            summary = sd
        else:
            totals, summary = acc, agg.summary()
    finally:
        if spill_rt is not None:
            spill_rt.close()         # reclaim segments, success or failure
    agg.finish(stats)
    # n_items/map_bytes always mean the RAW catalog (what the maps read):
    # the per-split stages counted post-precombine rows when a combiner ran
    stats.n_items = raw_items_total
    stats.map_bytes = raw_bytes_total
    stats.splits = tuple(recs)
    if tr.enabled:
        tr.record("job", t_job0, time.perf_counter(), cat="job",
                  job=stats.job, mode="stream")
    meter.attribute(mtok, stats)
    return [JobResult(j.reducer.finalize(t, summary), stats)
            for j, t in zip(jobs, totals)]


def _combine(comb: Combiner, acc, totals, stats: StageStats, device, split):
    """Fold one split's partials into the accumulator on this thread's
    stream and wait for it there. The wait is what makes dropping the old
    accumulator safe when it was allocated on another lane's stream: its
    memory returns to that stream's pool only after this sum has read it."""
    with get_tracer().span("combine", cat="stage", split=split):
        t0 = time.perf_counter()
        acc = comb.combine(acc, totals)
        _fence(device)
        stats.combine_wall_s += time.perf_counter() - t0
    return acc


def _run_jobs_lanes(jobs, source, *, mesh, device, on_device, codec, part,
                    comb, K, stats, straggler_monitor, n_lanes, policy, chaos,
                    max_retries, retry_backoff_s, deadline_s, spill_cfg):
    """The ``LanePool`` execution path of ``run_jobs_streaming``: splits run
    concurrently, each lane's stages fill a PRIVATE ``StageStats`` that
    merges into the shared one at commit (under the pool lock), and only
    the FIRST committed attempt per split contributes: a cancelled
    speculation loser's partial work is dropped with its frame. Commit
    order is nondeterministic; every cross-split merge is commutative
    (integer-sum accumulators / multiset bucket contents), which is exactly
    the contract that makes the results bit-identical to the sequential and
    monolithic paths.

    Each lane fetches and copies its split to the card synchronously on its
    own stream, and synchronizes that stream before its payload is handed
    over (``_fence``), so a committed split's tensors are complete whatever
    stream reads them next.

    Lane-mode spill: every split's stream is staged to disk by its own
    lane (no cross-lane accumulation buffer to bound: lanes run
    concurrently, so the budget degenerates to spill-per-split) and the
    winning attempt's segments are finalize-renamed in ``on_commit``, under
    the pool lock. Losing clones leave only staged litter, swept before
    read-back. The first lane to stage plans the range bounds from its
    split; under a mesh from split 0 whatever the lane's split, since the
    ranks' lanes stage in different orders and their bounds (and so their
    shards of each range) must match. A lane issues no collective.

    Under a mesh a lane's reduce leaves this rank's shard partials, the
    combine sums them, and the sum crosses one all-reduce after the drain
    (module docstring).

    Lanes across cards (``lane_devices``): lane i runs its split's stages
    on card i % D, then copies what it hands over (combine mode: its
    totals; else its mapped split) to the first card and fences its own
    stream, which the copy ran on, before it returns. A committed split's
    tensors on the first card are then finished, whichever lane or clone
    made them, and the merge and the final reduce run there."""
    sharded = _data_axis_size(mesh) > 1
    devices = lane_devices(device, mesh=mesh, on_device=on_device)
    first = devices[0]
    if (sharded and comb is not None
            and type(comb).combine is not Combiner.combine):
        raise ValueError(f"combiner {comb.name!r} under a mesh with lanes: "
                         "its combine must be the sum, since the shard "
                         "partials are combined before their one all-reduce")
    t_run0 = time.perf_counter()
    agg = _Agg()
    mapped: dict[int, object] = {}
    host_items: dict[int, np.ndarray] = {}
    recs: list[dict] = []
    state = {"acc": None, "P": None, "raw_items": 0, "raw_bytes": 0}
    spill_state = None
    if spill_cfg is not None:
        spill_state = {"store": None, "meter": _ResidentMeter(),
                       "lock": threading.Lock()}

    def spill_store_for(h, k, P_k, cancel):
        st = spill_state
        with st["lock"]:
            if st["store"] is None:
                if sharded and k != 0:
                    s0 = torch.as_tensor(np.ascontiguousarray(np.asarray(
                        fetch(0, cancel)[0], np.float32)), device=device)
                    h = mapped_to_host(map_timed(part, codec, s0, P_k,
                                                 device, StageStats()))
                w = np.bincount(h.dest_eff, minlength=P_k + 1)[:P_k]
                est = mapped_wire_nbytes(h) * K
                bounds = plan_bounds(w, _auto_ranges(spill_cfg, est, P_k,
                                                     device))
                store = SpillStore(_spill_root(spill_cfg, mesh), P_k,
                                   write_fault=spill_cfg.write_fault)
                st["store"] = store          # owned (and closed) from birth
                store.set_bounds(bounds)
            return st["store"]

    def fetch(k, cancel):
        if hasattr(source, "split_cancellable"):
            s = source.split_cancellable(k, cancel)
        else:
            s = source.split(k)
        raw_rows, raw_bytes = len(s), int(np.asarray(s).nbytes)
        if comb is not None:
            s = comb.precombine(s)
        return s, raw_rows, raw_bytes

    def to_first(x):
        """A lane's mapped split or totals on the first card: a copy only
        when the lanes span cards."""
        if len(devices) == 1:
            return x
        if isinstance(x, MappedSplit):
            return _mapped_to(x, first)
        return tuple(t.to(first) for t in x)

    def make_task(k):
        def fn(cancel):
            tr = get_tracer()
            local = StageStats()
            dev = current_lane_device(device)
            t0 = time.perf_counter()
            s, raw_rows, raw_bytes = fetch(k, cancel)
            if on_device:
                s = torch.as_tensor(
                    np.ascontiguousarray(np.asarray(s, np.float32)),
                    device=dev)
                _fence(dev)
            t1 = time.perf_counter()
            local.fetch_wall_s = t1 - t0
            if tr.enabled:
                # lane fetches are synchronous, so the whole fetch is an
                # exposed wait from the lane's point of view
                tr.record("fetch-wait", t0, t1, cat="io", split=k)
            if cancel.is_set():
                raise LaneCancelled(k)
            P_k = int(part.n_partitions(s))
            if on_device:
                m = map_timed(part, codec, s, P_k, dev, local)
                if cancel.is_set():
                    raise LaneCancelled(k)
                if comb is None and spill_state is not None:
                    t0 = time.perf_counter()
                    h = mapped_to_host(m)
                    del m, s                 # device buffers reclaimable now
                    nb = mapped_wire_nbytes(h)
                    store = spill_store_for(h, k, P_k, cancel)
                    spill_state["meter"].add(nb)
                    try:
                        if cancel.is_set():
                            raise LaneCancelled(k)
                        chunk = store.stage_chunk([h], store.next_tag())
                    finally:
                        spill_state["meter"].sub(nb)
                    local.spill_wall_s += time.perf_counter() - t0
                    local.spilled_splits = 1
                    payload = ("spilled", chunk)
                elif comb is None:
                    payload = ("mapped", to_first(m))
                else:
                    totals, sd = shuffle_reduce_device(jobs, m, P_k, local,
                                                       dev, mesh, psum=False)
                    payload = ("acc", to_first(totals), sd)
                # the stages fenced this lane's stream before they returned;
                # the copies to the first card ran on it after them
                _fence(dev)
            else:
                items_h = np.asarray(s)
                if comb is None:
                    payload = ("items", items_h)
                else:
                    totals, sd = host_shuffle_reduce(jobs, items_h, local,
                                                     device, mesh, psum=False)
                    payload = ("acc", totals, sd)
            if cancel.is_set():
                raise LaneCancelled(k)
            return {"payload": payload, "P": P_k, "raw_rows": raw_rows,
                    "raw_bytes": raw_bytes, "local": local,
                    "device": str(dev)}
        return fn

    def on_commit(k, out, meta):
        # runs under the pool lock on the committing lane's thread: the one
        # winning attempt per split merges its private stats + partials
        # into the shared state, serialized
        local = out["local"]
        stats.merge_from(local)
        state["raw_items"] += out["raw_rows"]
        state["raw_bytes"] += out["raw_bytes"]
        if state["P"] is None:
            state["P"] = out["P"]
        kind, *rest = out["payload"]
        if kind == "acc":
            totals, sd = rest
            agg.add(sd)
            state["acc"] = _combine(comb, state["acc"], totals, stats, first,
                                    k)
        elif kind == "spilled":
            # lane-safe commit: the winning attempt's staged segments
            # finalize-rename here, serialized under the pool lock; a
            # losing clone's chunk never reaches this hook
            spill_state["store"].commit_chunk(rest[0])
        elif kind == "mapped":
            mapped[k] = rest[0]
        else:
            host_items[k] = rest[0]
        recs.append({"split": k, "n_items": out["raw_rows"],
                     "fetch_wait_s": local.fetch_wall_s,
                     "fetch_prep_s": local.fetch_wall_s,
                     "map_s": local.map_wall_s,
                     "shuffle_s": local.shuffle_wall_s,
                     "reduce_s": local.reduce_wall_s,
                     "wall_s": meta["wall_s"], "lane": meta["lane"],
                     "attempt": meta["attempt"], "clone": meta["clone"],
                     "device": out["device"]})
        if straggler_monitor is not None and straggler_monitor is not policy:
            straggler_monitor.record(k, meta["wall_s"])

    try:
        with LanePool(n_lanes, policy=policy, chaos=chaos,
                      max_retries=max_retries, backoff_s=retry_backoff_s,
                      deadline_s=deadline_s, devices=devices,
                      on_commit=on_commit) as pool:
            for k in range(K):
                pool.submit(k, make_task(k))
            pool.drain(range(K), make_task_fn=make_task)
            stats.n_lanes = n_lanes
            stats.speculated = pool.speculated
            stats.clone_wins = pool.clone_wins
            stats.retries = pool.retries
            stats.lane_walls = tuple(ln.busy_s for ln in pool.lanes)
        if len(recs) != K:
            raise RuntimeError(f"{len(recs)} of {K} splits committed")

        P = state["P"]
        if comb is None:
            # one global shuffle+reduce over the accumulated per-split
            # streams: streamed back per partition range when they spilled,
            # else concatenated in split order (deterministic regardless of
            # commit order, and bit-identical to any order by the multiset
            # contract)
            if spill_state is not None:
                totals, sd = _streamed_reduce(
                    spill_state["store"], spill_state["meter"], jobs, P,
                    stats, first, mesh)
            elif on_device:
                totals, sd = shuffle_reduce_device(
                    jobs, concat_mapped([mapped[k] for k in range(K)]), P,
                    stats, first, mesh)
            else:
                hs = [host_items[k] for k in range(K)]
                items_all = (hs[0] if len(hs) == 1
                             else np.concatenate(hs, axis=0))
                totals, sd = host_shuffle_reduce(jobs, items_all, stats,
                                                 device, mesh)
            agg.add(sd)
            summary = sd
        else:
            totals, summary = state["acc"], agg.summary()
            if sharded:
                totals = _psum_partials(totals, mesh, device, stats)
    finally:
        if spill_state is not None and spill_state["store"] is not None:
            spill_state["store"].close()
    agg.finish(stats)
    stats.n_items = state["raw_items"]
    stats.map_bytes = state["raw_bytes"]
    stats.splits = tuple(sorted(recs, key=lambda r: r["split"]))
    stats.elapsed_s = time.perf_counter() - t_run0
    return [JobResult(j.reducer.finalize(t, summary), stats)
            for j, t in zip(jobs, totals)]


def run_job_streaming(job, source: SplitSource, *, mesh=None,
                      engine: str = "auto", combiner="auto",
                      prefetch: int = 2,
                      straggler_monitor=None, n_lanes: int = 1,
                      speculate=None, chaos=None, max_retries: int = 0,
                      retry_backoff_s: float = 0.05,
                      deadline_s: float | None = None, spill=None,
                      device=None) -> JobResult:
    """Stream one job over a ``SplitSource``. -> JobResult(output, stats)."""
    return run_jobs_streaming([job], source, mesh=mesh, engine=engine,
                              combiner=combiner, prefetch=prefetch,
                              straggler_monitor=straggler_monitor,
                              n_lanes=n_lanes, speculate=speculate,
                              chaos=chaos, max_retries=max_retries,
                              retry_backoff_s=retry_backoff_s,
                              deadline_s=deadline_s, spill=spill,
                              device=device)[0]
