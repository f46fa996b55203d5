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
  liveness machine, and ``deadline_s`` bounds the job.

Entry points take ``device=None``, which means the card; with no card they
raise. The disk-spill tier (``spill=``, ROADMAP queue 1 item 2) and the
tracer and energy-meter hooks (item 3) are not ported yet.

    src = MemmapCatalogSplits("catalog.f32", d=3, rows_per_split=1 << 20)
    res = run_job_streaming(neighbor_search_job(0.02, codec="int16"), src)
    res.stats.overlap_fraction, res.stats.n_splits
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import Prefetcher, SplitSource
from repro_torch.ft.chaos import CancelledFetch, LaneDeath, TransientSplitError
from repro_torch.ft.coordinator import Coordinator, CoordinatorConfig
from repro_torch.ft.stragglers import SpeculativePolicy
from repro_torch.mapreduce.codecs import get_codec
from repro_torch.mapreduce.instrumentation import StageStats
from repro_torch.mapreduce.job import (JobResult, StreamSummary, _fence,
                                       _require_concrete, concat_mapped,
                                       host_shuffle_reduce, map_split_device,
                                       shuffle_reduce_device, validate_batch)


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
        else:
            self.n_owned += no
            self.n_bucket += nb

    def finish(self, stats: StageStats):
        stats.reduce_padded_ratio = (self.pair_pad / self.pair_real
                                     if self.pair_real else 1.0)

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
    """Host -> card copies for the prefetch thread.

    Each split is written into a pinned staging buffer and copied with a
    ``non_blocking`` copy on a side stream; an event marks the copy's end
    and is synchronized before the call returns, so the producer's
    ``prep_s`` covers the transfer. ONE buffer is reused for every split:
    the next split is written into it only after the previous copy's event
    has completed (a producer that returned before its copy ended would
    need a ring of depth + 1 buffers).

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
        arr = np.ascontiguousarray(np.asarray(items, np.float32))
        if self.buf is None or self.buf.numel() < arr.nbytes:
            self.buf = torch.empty(max(arr.nbytes, 4), dtype=torch.uint8,
                                   pin_memory=True)
        host = self.buf[:arr.nbytes].view(torch.float32).view(arr.shape)
        host.numpy()[...] = arr
        with torch.cuda.stream(self.consumer):
            out = torch.empty(arr.shape, dtype=torch.float32,
                              device=self.device)
        self.stream.wait_stream(self.consumer)
        with torch.cuda.stream(self.stream):
            out.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return out, done

    def receive(self, copied) -> torch.Tensor:
        out, done = copied
        torch.cuda.current_stream(self.device).wait_event(done)
        return out


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
    i % D). A lane on a CUDA device runs its whole life inside
    ``torch.cuda.stream`` of a stream of its own: PyTorch's current stream
    is per thread, and the kernels' wrappers launch on it.

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
        """Pin this lane's thread to its device and, on a card, to a CUDA
        stream of its own for the thread's whole life."""
        if not self.devices:
            return contextlib.nullcontext()
        dev = self.devices[lane.id % len(self.devices)]
        if dev.type != "cuda":
            return contextlib.nullcontext()
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
                try:
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


def run_jobs_streaming(jobs, source: SplitSource, *, engine: str = "auto",
                       combiner="auto", prefetch: int = 2,
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

    ``spill`` (the external shuffle tier) raises ``NotImplementedError``
    unless None: it comes with ``mapreduce/spill.py``.

    The partition space must be split-independent (``n_partitions`` is read
    from the first split): true for the stock zone/hash partitioners.
    """
    if not jobs:
        return []
    if spill is not None:
        raise NotImplementedError(
            "spill= needs the disk-spill tier (mapreduce/spill.py, ROADMAP "
            "queue 1 item 2); pass spill=None")
    for j in jobs:
        _require_concrete(j.codec, j.tile)
    validate_batch(jobs)
    if engine == "auto":
        engine = "device"
    if engine not in ("device", "host"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'auto', 'device', or 'host'")
    device = resolve_device(device)
    j0 = jobs[0]
    codec = get_codec(j0.codec)
    part = j0.partitioner
    comb = _resolve_combiner(combiner, jobs, codec)
    K = int(source.n_splits())
    on_device = engine == "device"
    stats = StageStats(job="+".join(j.name for j in jobs), engine=engine,
                       codec=codec.name, device=str(device), n_splits=K,
                       combiner=comb.name if comb else "")
    policy = _resolve_policy(speculate)
    if (n_lanes > 1 or policy is not None or chaos is not None
            or max_retries > 0 or deadline_s is not None):
        return _run_jobs_lanes(
            jobs, source, device=device, on_device=on_device, codec=codec,
            part=part, comb=comb, K=K, stats=stats,
            straggler_monitor=straggler_monitor, n_lanes=max(1, int(n_lanes)),
            policy=policy, chaos=chaos, max_retries=max_retries,
            retry_backoff_s=retry_backoff_s, deadline_s=deadline_s)

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
        # runs on the prefetch thread: host I/O, precombine, AND the
        # host -> card copy all overlap the caller's compute
        s, raw_rows, raw_bytes = fetch(k)
        return copier(s), raw_rows, raw_bytes

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

    def consume(k, item, wait_s, prep_s):
        nonlocal acc, P, raw_items_total, raw_bytes_total
        items_k, raw_rows, raw_bytes = item
        if copier is not None:
            items_k = copier.receive(items_k)
        raw_items_total += raw_rows
        raw_bytes_total += raw_bytes
        stats.fetch_wall_s += wait_s
        stats.overlap_hidden_s += max(prep_s - wait_s, 0.0)
        if P is None:
            P = int(part.n_partitions(items_k))
        rec = {"split": k, "n_items": raw_rows, "fetch_wait_s": wait_s,
               "fetch_prep_s": prep_s}
        m0, s0, r0 = stats.map_wall_s, stats.shuffle_wall_s, stats.reduce_wall_s
        if on_device:
            t0 = time.perf_counter()
            m = map_split_device(part, codec, items_k, P, device)
            _fence(device)
            stats.map_wall_s += time.perf_counter() - t0
            if comb is None:
                mapped.append(m)
            else:
                totals, sd = shuffle_reduce_device(jobs, m, P, stats, device)
                agg.add(sd)
                acc = _combine(comb, acc, totals, stats, device)
        else:
            items_h = np.asarray(items_k)
            if comb is None:
                host_items.append(items_h)
            else:
                totals, sd = host_shuffle_reduce(jobs, items_h, stats, device)
                agg.add(sd)
                acc = _combine(comb, acc, totals, stats, device)
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

    if K > 1 and prefetch > 0:
        produce = fetch_to_device if copier is not None else fetch
        with Prefetcher(produce, depth=prefetch, n=K) as pf:
            while (got := pf.get()) is not None:
                consume(*got)
    else:
        for got in synchronous():
            consume(*got)
    if len(recs) != K:
        raise RuntimeError(f"{len(recs)} of {K} splits consumed")

    if comb is None:
        # no valid map-side combine: the accumulated wire-format streams
        # cross ONE global shuffle+reduce (Hadoop's reduce-after-last-map)
        if on_device:
            totals, sd = shuffle_reduce_device(jobs, concat_mapped(mapped),
                                               P, stats, device)
        else:
            items_all = (host_items[0] if len(host_items) == 1
                         else np.concatenate(host_items, axis=0))
            totals, sd = host_shuffle_reduce(jobs, items_all, stats, device)
        agg.add(sd)
        summary = sd
    else:
        totals, summary = acc, agg.summary()
    agg.finish(stats)
    # n_items/map_bytes always mean the RAW catalog (what the maps read):
    # the per-split stages counted post-precombine rows when a combiner ran
    stats.n_items = raw_items_total
    stats.map_bytes = raw_bytes_total
    stats.splits = tuple(recs)
    return [JobResult(j.reducer.finalize(t, summary), stats)
            for j, t in zip(jobs, totals)]


def _combine(comb: Combiner, acc, totals, stats: StageStats, device):
    """Fold one split's partials into the accumulator on this thread's
    stream and wait for it there. The wait is what makes dropping the old
    accumulator safe when it was allocated on another lane's stream: its
    memory returns to that stream's pool only after this sum has read it."""
    t0 = time.perf_counter()
    acc = comb.combine(acc, totals)
    _fence(device)
    stats.combine_wall_s += time.perf_counter() - t0
    return acc


def _run_jobs_lanes(jobs, source, *, device, on_device, codec, part, comb, K,
                    stats, straggler_monitor, n_lanes, policy, chaos,
                    max_retries, retry_backoff_s, deadline_s):
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
    stream reads them next."""
    t_run0 = time.perf_counter()
    agg = _Agg()
    mapped: dict[int, object] = {}
    host_items: dict[int, np.ndarray] = {}
    recs: list[dict] = []
    state = {"acc": None, "P": None, "raw_items": 0, "raw_bytes": 0}

    def fetch(k, cancel):
        if hasattr(source, "split_cancellable"):
            s = source.split_cancellable(k, cancel)
        else:
            s = source.split(k)
        raw_rows, raw_bytes = len(s), int(np.asarray(s).nbytes)
        if comb is not None:
            s = comb.precombine(s)
        return s, raw_rows, raw_bytes

    def make_task(k):
        def fn(cancel):
            local = StageStats()
            t0 = time.perf_counter()
            s, raw_rows, raw_bytes = fetch(k, cancel)
            if on_device:
                s = torch.as_tensor(
                    np.ascontiguousarray(np.asarray(s, np.float32)),
                    device=device)
                _fence(device)
            local.fetch_wall_s = time.perf_counter() - t0
            if cancel.is_set():
                raise LaneCancelled(k)
            P_k = int(part.n_partitions(s))
            if on_device:
                t0 = time.perf_counter()
                m = map_split_device(part, codec, s, P_k, device)
                _fence(device)
                local.map_wall_s += time.perf_counter() - t0
                if cancel.is_set():
                    raise LaneCancelled(k)
                if comb is None:
                    payload = ("mapped", m)
                else:
                    totals, sd = shuffle_reduce_device(jobs, m, P_k, local,
                                                       device)
                    payload = ("acc", totals, sd)
            else:
                items_h = np.asarray(s)
                if comb is None:
                    payload = ("items", items_h)
                else:
                    totals, sd = host_shuffle_reduce(jobs, items_h, local,
                                                     device)
                    payload = ("acc", totals, sd)
            if cancel.is_set():
                raise LaneCancelled(k)
            return {"payload": payload, "P": P_k, "raw_rows": raw_rows,
                    "raw_bytes": raw_bytes, "local": local}
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
            state["acc"] = _combine(comb, state["acc"], totals, stats, device)
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
                     "attempt": meta["attempt"], "clone": meta["clone"]})
        if straggler_monitor is not None and straggler_monitor is not policy:
            straggler_monitor.record(k, meta["wall_s"])

    with LanePool(n_lanes, policy=policy, chaos=chaos,
                  max_retries=max_retries, backoff_s=retry_backoff_s,
                  deadline_s=deadline_s, devices=[device],
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
        # one global shuffle+reduce over the accumulated per-split streams,
        # concatenated in split order (deterministic regardless of commit
        # order, and bit-identical to any order by the multiset contract)
        if on_device:
            totals, sd = shuffle_reduce_device(
                jobs, concat_mapped([mapped[k] for k in range(K)]), P, stats,
                device)
        else:
            hs = [host_items[k] for k in range(K)]
            items_all = hs[0] if len(hs) == 1 else np.concatenate(hs, axis=0)
            totals, sd = host_shuffle_reduce(jobs, items_all, stats, device)
        agg.add(sd)
        summary = sd
    else:
        totals, summary = state["acc"], agg.summary()
    agg.finish(stats)
    stats.n_items = state["raw_items"]
    stats.map_bytes = state["raw_bytes"]
    stats.splits = tuple(sorted(recs, key=lambda r: r["split"]))
    stats.elapsed_s = time.perf_counter() - t_run0
    return [JobResult(j.reducer.finalize(t, summary), stats)
            for j, t in zip(jobs, totals)]


def run_job_streaming(job, source: SplitSource, *, engine: str = "auto",
                      combiner="auto", prefetch: int = 2,
                      straggler_monitor=None, n_lanes: int = 1,
                      speculate=None, chaos=None, max_retries: int = 0,
                      retry_backoff_s: float = 0.05,
                      deadline_s: float | None = None, spill=None,
                      device=None) -> JobResult:
    """Stream one job over a ``SplitSource``. -> JobResult(output, stats)."""
    return run_jobs_streaming([job], source, engine=engine,
                              combiner=combiner, prefetch=prefetch,
                              straggler_monitor=straggler_monitor,
                              n_lanes=n_lanes, speculate=speculate,
                              chaos=chaos, max_retries=max_retries,
                              retry_backoff_s=retry_backoff_s,
                              deadline_s=deadline_s, spill=spill,
                              device=device)[0]
