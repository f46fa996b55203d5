"""MapReduce query service: a resident catalog serving online queries.

The port of ``repro.serving.mr_service``. The LM side serves continuously
(``serving/engine.py``'s slot-based ``ServeEngine``); this is its MapReduce
twin, shaped for the workload the paper argues about: a long-running node
kept busy by a stream of many small data-intensive requests against shared
resident data (the consolidation result: throughput hinges on
co-scheduling, not on one-shot batch jobs):

- the catalog is loaded, mapped and shuffled ONCE (``shuffle_once`` ->
  ``ResidentCatalog``): its tiered wire-dtype partitions stay on the card
  across every request the service will answer;
- queries enter a submit queue and an admission window groups them into
  micro-batches, count-triggered at ``max_batch`` or time-triggered after
  ``max_wait_s``, whichever fires first (the slot-fill trade
  ``ServeEngine`` makes); each batch is grouped per catalog and COALESCED
  (identical jobs run once; distinct compatible jobs fuse into one batched
  reduce pass, the ``run_jobs`` multi-job path), so N queries cost one
  shuffle ever plus about one reduce pass per distinct job: on the card,
  one masked-kernel launch per tier and distinct reducer;
- every request carries a ``RequestStats`` (queue wait, batch wall,
  latency); ``latency_summary`` turns the stream into qps/p50/p99, and
  per-batch walls feed an optional ``straggler_monitor=`` hook with the
  streaming executor's ``record(index, wall_s)`` contract.

On the card: the catalog is built on the loading thread's current stream
and fenced there before ``load_catalog`` returns, so the admission thread
and every lane (each on a CUDA stream of its own, ``LanePool``) read
finished tensors. Each batch fences its own stream before it returns and
hands its callers host values only (``finalize`` copies to the host), so
once ``close()`` has drained the lanes no stream still reads the catalog
and freeing it is safe.

    svc = MRQueryService(max_batch=16, max_wait_s=0.002)      # on the card
    svc.load_catalog("sky", xyz, ZonePartitioner(0.02), codec="int16")
    with svc:                              # background admission thread
        reqs = [svc.submit(neighbor_search_job(r, partitioner=part,
                                               codec="int16"), catalog="sky")
                for r in radii]
        outs = [r.result(timeout=60) for r in reqs]
    svc.latency_summary()                  # {"qps": ..., "p99_ms": ...}
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from repro_torch.core.device import resolve_device
from repro_torch.mapreduce.codecs import get_codec
from repro_torch.mapreduce.instrumentation import RequestStats, latency_summary
from repro_torch.mapreduce.job import (MapReduceJob, ResidentCatalog,
                                       shuffle_once)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer


def _job_key(job: MapReduceJob) -> tuple:
    """Equality key for request coalescing: two submissions with this key
    are THE SAME query and share one reduce. Codec instances (e.g. the
    wordcount job's per-vocab ``Int16Codec``) compare by parameters, not
    identity, so independently-built identical jobs still coalesce."""
    c = get_codec(job.codec)
    return (job.name, job.partitioner, job.reducer, job.tile,
            type(c).__name__, tuple(sorted(vars(c).items())))


@dataclasses.dataclass
class MRRequest:
    """One queued query: a ``MapReduceJob`` against a named resident
    catalog. ``result()`` blocks until the admitting micro-batch completes
    and returns the job's host output; ``stats`` is the request's
    ``RequestStats`` once served."""

    rid: int
    job: MapReduceJob
    catalog: str
    t_submit: float
    output: object = None
    error: BaseException | None = None
    stats: RequestStats | None = None
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still queued/running "
                               f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.output


class MRQueryService:
    """Long-running MapReduce query service over resident shuffled catalogs.

    Two execution modes share one admission path: ``start()`` (or the
    context manager) runs micro-batches on a background thread as windows
    fire; ``run_pending()`` drains synchronously: deterministic, and its
    ``batch_sizes=`` override replays ANY partition of the queue into
    micro-batches (the batching-determinism tests use this). ``close()``
    rejects further submits, serves what is queued, and joins the worker;
    like ``ServeEngine`` after ``run()`` drains, a closed service raises on
    ``submit``. ``device=None`` means the card.
    """

    def __init__(self, *, device=None, max_batch: int = 16,
                 max_wait_s: float = 0.002, straggler_monitor=None,
                 n_lanes: int = 1, lane_chaos=None,
                 clock=time.perf_counter, metrics: MetricsRegistry = None):
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.straggler_monitor = straggler_monitor
        self.n_lanes = int(n_lanes)
        self.lane_chaos = lane_chaos
        self.clock = clock
        # live service metrics (obs/metrics.py): per-instance by default so
        # two services don't mix counters; pass a shared registry to scrape
        # several services off one page
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._t_first_submit: float | None = None
        self.catalogs: dict[str, ResidentCatalog] = {}
        self.request_stats: list[RequestStats] = []
        self.batches: list[dict] = []       # per-batch records (size, wall, ...)
        self.closed = False
        self._queue: deque[MRRequest] = deque()
        self._cond = threading.Condition()
        self._blk = threading.Lock()        # batches/request_stats bookkeeping
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._pool = None                   # LanePool when n_lanes > 1
        self._nbatch = 0                    # lane-pool batch keys
        self._rid = 0

    # -- catalog management -------------------------------------------------

    def load_catalog(self, name: str, items, partitioner, *,
                     codec="identity", tile: int | str = 256,
                     pad_value: float = 0.0) -> ResidentCatalog:
        """Map + shuffle ``items`` once into resident tiers on the
        service's device under ``name``; every later query against ``name``
        is a pure reduce."""
        if self.closed:
            raise RuntimeError("MRQueryService is closed")
        cat = shuffle_once(partitioner, items, codec=codec, tile=tile,
                           pad_value=pad_value, device=self.device)
        self.catalogs[name] = cat
        return cat

    def catalog(self, name: str = "default") -> ResidentCatalog:
        return self.catalogs[name]

    # -- submission ---------------------------------------------------------

    def submit(self, job: MapReduceJob, *,
               catalog: str = "default") -> MRRequest:
        """Enqueue one query. Validates the job against the target catalog's
        shuffle signature HERE (fail fast at the caller, not in the worker);
        raises RuntimeError once the service is closed: submissions would
        otherwise enqueue into a dead service and never complete."""
        cat = self.catalogs.get(catalog)
        if cat is None:
            raise KeyError(f"no catalog {catalog!r} loaded "
                           f"(have {sorted(self.catalogs)}); "
                           f"call load_catalog() first")
        cat.validate([job])
        with self._cond:
            if self.closed:
                raise RuntimeError(
                    "MRQueryService is closed: submit() after close() "
                    "would never be served (same guard as ServeEngine "
                    "after run() drains)")
            req = MRRequest(self._rid, job, catalog, self.clock())
            self._rid += 1
            self._queue.append(req)
            if self._t_first_submit is None:
                self._t_first_submit = req.t_submit
            self.metrics.counter("mr_requests").inc()
            self.metrics.gauge("mr_queue_depth").set(len(self._queue))
            self._cond.notify()
        return req

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- admission / batching policy ----------------------------------------

    def _admit(self) -> list[MRRequest]:
        """Take one micro-batch off the queue (worker thread): the first
        waiting request opens an admission window that closes after
        ``max_wait_s`` OR as soon as ``max_batch`` requests are queued:
        waiting fills the batch (throughput), the deadline bounds queue
        wait (latency)."""
        with self._cond:
            while not self._queue and not self._stop.is_set():
                self._cond.wait(timeout=0.05)
            if not self._queue:
                return []
            deadline = self.clock() + self.max_wait_s
            while len(self._queue) < self.max_batch and not self._stop.is_set():
                left = deadline - self.clock()
                if left <= 0:
                    break
                self._cond.wait(timeout=left)
            take = min(self.max_batch, len(self._queue))
            return [self._queue.popleft() for _ in range(take)]

    def _run_batch(self, batch: list[MRRequest]) -> None:
        """Serve one admitted micro-batch: group by catalog, coalesce
        duplicate jobs, one fused batched reduce per catalog group, then
        stamp RequestStats, wake waiters and feed the straggler hook.

        Failure isolation: coalescing maps many requests onto one fused
        ``cat.run``, so when the fused pass fails it falls back to running
        each distinct job alone: only the requests mapped to the failing
        job see its error; batch-mates are served. Bookkeeping appends under
        a lock so lane-concurrent batches cannot interleave records."""
        tr = get_tracer()
        t_admit = self.clock()
        t_span0 = time.perf_counter()
        by_cat: dict[str, list[MRRequest]] = {}
        for r in batch:
            by_cat.setdefault(r.catalog, []).append(r)
        n_unique = 0
        for cname, reqs in by_cat.items():
            cat = self.catalogs[cname]
            uniq_keys: list[tuple] = []
            uniq_jobs: list[MapReduceJob] = []
            slots: list[int] = []       # per-request index into uniq_jobs
            for r in reqs:
                k = _job_key(r.job)
                try:
                    slots.append(uniq_keys.index(k))
                except ValueError:
                    slots.append(len(uniq_jobs))
                    uniq_keys.append(k)
                    uniq_jobs.append(r.job)
            n_unique += len(uniq_jobs)
            try:
                outs = [(res.output, None) for res in cat.run(uniq_jobs)]
            except Exception:
                # the fused pass died: isolate per distinct job so one
                # poison query cannot fail its coalesced batch-mates
                outs = []
                for job in uniq_jobs:
                    try:
                        outs.append((cat.run([job])[0].output, None))
                    except Exception as e:
                        outs.append((None, e))
            for r, s in zip(reqs, slots):
                r.output, r.error = outs[s]
        t_done = self.clock()
        wall = t_done - t_admit
        m = self.metrics
        with self._blk:
            bidx = len(self.batches)
            self.batches.append({"batch": bidx, "size": len(batch),
                                 "n_unique": n_unique, "wall_s": wall})
            if self.straggler_monitor is not None:
                self.straggler_monitor.record(bidx, wall)
            for r in batch:
                r.stats = RequestStats(
                    rid=r.rid, job=r.job.name, catalog=r.catalog,
                    batch_index=bidx, batch_size=len(batch),
                    n_unique=n_unique, t_submit_s=r.t_submit,
                    queue_wait_s=t_admit - r.t_submit,
                    batch_wall_s=wall, latency_s=t_done - r.t_submit)
                self.request_stats.append(r.stats)
                m.histogram("mr_latency_ms").observe(r.stats.latency_s * 1e3)
                m.histogram("mr_queue_wait_ms").observe(
                    r.stats.queue_wait_s * 1e3)
            m.counter("mr_batches").inc()
            m.counter("mr_requests_served").inc(len(batch))
            n_served = len(self.request_stats)
            t_first = self._t_first_submit
        if tr.enabled:
            tr.record("service-batch", t_span0, time.perf_counter(),
                      cat="service", batch=bidx, size=len(batch),
                      n_unique=n_unique,
                      rids=[r.rid for r in batch[:32]])
        span = (t_done - t_first) if t_first is not None else 0.0
        if span > 1e-9:
            m.gauge("mr_qps").set(n_served / span)
        m.gauge("mr_queue_depth").set(self.pending)
        for r in batch:
            r._done.set()

    # -- execution: synchronous drain or background serving thread ----------

    def run_pending(self, *, batch_sizes=None) -> int:
        """Synchronously drain the queue in micro-batches. ``batch_sizes``
        forces an explicit partition of the queue (replay / determinism
        tests); default chunks by ``max_batch`` with no admission wait.
        -> number of requests served."""
        sizes = iter(batch_sizes if batch_sizes is not None else [])
        served = 0
        while True:
            with self._cond:
                if not self._queue:
                    break
                k = next(sizes, self.max_batch)
                k = max(1, min(int(k), len(self._queue)))
                batch = [self._queue.popleft() for _ in range(k)]
            self._run_batch(batch)
            served += len(batch)
        return served

    def _serve_loop(self) -> None:
        """Admission loop. With a lane pool, admitted micro-batches are
        SUBMITTED and run concurrently across lanes (each on a CUDA stream
        of its own on the card); a lane death shrinks the pool and requeues
        the batch onto the survivors instead of killing the service."""
        while True:
            t0 = time.perf_counter()
            batch = self._admit()
            if batch:
                tr = get_tracer()
                if tr.enabled:
                    # covers waiting for the first request plus the
                    # admission window it opened
                    tr.record("service-admit", t0, time.perf_counter(),
                              cat="service", size=len(batch))
                if self._pool is not None:
                    key, self._nbatch = self._nbatch, self._nbatch + 1
                    self._pool.submit(
                        key, (lambda b: lambda cancel: self._run_batch(b))(
                            batch))
                else:
                    self._run_batch(batch)
            elif self._stop.is_set():
                return

    def start(self) -> "MRQueryService":
        """Start the background admission/serving thread (idempotent); with
        ``n_lanes > 1`` also start the concurrent-batch lane pool."""
        if self.closed:
            raise RuntimeError("MRQueryService is closed")
        if self._thread is None:
            if self.n_lanes > 1 and self._pool is None:
                from repro_torch.mapreduce.executor import LanePool
                self._pool = LanePool(self.n_lanes, chaos=self.lane_chaos,
                                      max_retries=0, devices=[self.device],
                                      name="mr-batch")
            self._stop.clear()
            self._thread = threading.Thread(target=self._serve_loop,
                                            name="mr-service", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Reject further submits, serve everything already queued, and
        stop the worker (and the lane pool, raising if a lane thread
        outlived the join). Idempotent; also the context-manager exit."""
        with self._cond:
            self.closed = True
            self._stop.set()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                raise RuntimeError("MRQueryService: the admission thread "
                                   "did not stop within 60 s")
            self._thread = None
        self.run_pending()               # anything the worker left behind
        if self._pool is not None:
            pool, self._pool = self._pool, None
            try:
                pool.drain()             # in-flight lane batches finish
            finally:
                pool.shutdown()          # raises on leaked lane threads

    def __enter__(self) -> "MRQueryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- accounting ---------------------------------------------------------

    def latency_summary(self) -> dict:
        """qps + p50/p99 latency over everything served so far."""
        return latency_summary(self.request_stats)
