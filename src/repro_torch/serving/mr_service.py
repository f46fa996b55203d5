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

Under a mesh (``mesh=``, ``launch/mesh.py``) the service is SPMD, like
every mesh entry point: every rank builds it, loads the same catalogs and
makes the same ``start``/``run_pending``/``close`` calls. The tiers are
replicated and each rank reduces its rows of every tier. The mesh's first
rank takes the clients (``submit`` raises on the others): it admits and
coalesces each batch as above, then broadcasts it (catalog names, distinct
jobs, request-to-job slots) on a gloo control group before any rank
reduces it. The other ranks follow: they receive each batch and reduce the
same jobs, with no collective (``ResidentCatalog.partials``). Each rank
then reports, on a second control group, each distinct job's partial
shape or its reducer's error, and the partials of the jobs that no rank
failed cross ONE all-reduce over ``data`` a batch. Reports and all-reduces
come from one thread a rank, in batch order: the caller's under
``run_pending``, a commit thread's under ``start``. Lanes only reduce. A
job whose reducer raised on any rank fails on every rank, with that rank's
message; its batch-mates are served. ``close()`` on the first rank
broadcasts a stop, at which the others' ``close()`` returns. Every wait
across ranks times out after ``MESH_TIMEOUT_S``; a first rank that admits
nothing for a quarter of it sends the others a heartbeat. Every job must
pickle to cross to the others: ``submit`` refuses one that does not.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
import threading
import time
from collections import deque

import torch

from repro_torch.core.device import resolve_device
from repro_torch.mapreduce.codecs import get_codec
from repro_torch.mapreduce.instrumentation import (RequestStats, StageStats,
                                                   latency_summary)
from repro_torch.mapreduce.job import (MapReduceJob, ResidentCatalog,
                                       _data_axis_size, _psum_partials,
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




@dataclasses.dataclass
class _Group:
    """One catalog's share of a micro-batch after coalescing."""

    catalog: str
    reqs: list          # its requests, in batch order
    jobs: list          # the distinct jobs
    slots: list         # per request: its job's index in ``jobs``


# every wait across a mesh's ranks raises after this long; an idle first
# rank sends a heartbeat every quarter of it
MESH_TIMEOUT_S = 120.0
# control messages on a mesh's batch group, first field
_BATCH, _DRAINED, _IDLE, _STOP = "batch", "drained", "idle", "stop"


class _MeshPlane:
    """The SPMD side of a service under a mesh: which rank leads, and two
    gloo control groups (``launch/mesh.py::control_group``), made on every
    rank in this order. ``batches`` carries the leader's batch descriptions
    and is driven by the thread that admits (first rank) or receives (the
    others) them; ``reports`` carries each rank's per-job report and is
    driven, like the data all-reduce, by the thread that commits batches
    in order. One thread a group: two threads on one group could enqueue
    its collectives in different orders on different ranks."""

    def __init__(self, mesh):
        import torch.distributed as dist
        from repro_torch.launch.mesh import control_group, mesh_ranks
        self.dist = dist
        self.rank = dist.get_rank()
        self.leader = mesh_ranks(mesh)[0]
        self.is_leader = self.rank == self.leader
        self.batches = control_group(mesh, timeout_s=MESH_TIMEOUT_S)
        self.reports = control_group(mesh, timeout_s=MESH_TIMEOUT_S)
        self.report_ranks = dist.get_process_group_ranks(self.reports)
        self.sharded = _data_axis_size(mesh) > 1

    def send(self, *msg) -> None:
        self.dist.broadcast_object_list([msg], src=self.leader,
                                        group=self.batches)

    def recv(self) -> tuple:
        box = [None]
        self.dist.broadcast_object_list(box, src=self.leader,
                                        group=self.batches)
        return box[0]

    def exchange(self, report) -> dict:
        """-> {rank: that rank's report}, on every rank."""
        got = [None] * len(self.report_ranks)
        self.dist.all_gather_object(got, report, group=self.reports)
        return dict(zip(self.report_ranks, got))


class MRQueryService:
    """Long-running MapReduce query service over resident shuffled catalogs.

    Two execution modes share one admission path: ``start()`` (or the
    context manager) runs micro-batches on a background thread as windows
    fire; ``run_pending()`` drains synchronously: deterministic, and its
    ``batch_sizes=`` override replays ANY partition of the queue into
    micro-batches (the batching-determinism tests use this). ``close()``
    rejects further submits, serves what is queued, and joins the worker;
    like ``ServeEngine`` after ``run()`` drains, a closed service raises on
    ``submit``. ``device=None`` means the card (under a mesh, the rank's).

    ``mesh=``: SPMD over the mesh's ranks (module docstring). The first
    rank's requests are those ``submit`` returns; the others keep theirs,
    mirrored from its batches, in ``followed``.
    """

    def __init__(self, *, mesh=None, device=None, max_batch: int = 16,
                 max_wait_s: float = 0.002, straggler_monitor=None,
                 n_lanes: int = 1, lane_chaos=None,
                 clock=time.perf_counter, metrics: MetricsRegistry = None):
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
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
        self.followed: list[MRRequest] = []   # a follower rank's requests
        self.closed = False
        self._queue: deque[MRRequest] = deque()
        self._cond = threading.Condition()
        self._blk = threading.Lock()        # batches/request_stats bookkeeping
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._pool = None                   # LanePool when n_lanes > 1
        self._nbatch = 0                    # lane-pool / commit-order keys
        self._rid = 0
        # under a mesh: the control plane, and the ordered commit of
        # reduced batches (their reports and all-reduces)
        self._plane = None if mesh is None else _MeshPlane(mesh)
        self._committer: threading.Thread | None = None
        self._seq = threading.Condition()
        self._ready: dict[int, dict] = {}   # reduced batches by key
        self._next = 0                      # the next key to commit
        self._commit_stop = False
        self._failure: BaseException | None = None
        self._stopped = False               # a follower got the stop
        self._finished = False              # close() ran to its end

    # -- catalog management -------------------------------------------------

    def load_catalog(self, name: str, items, partitioner, *,
                     codec="identity", tile: int | str = 256,
                     pad_value: float = 0.0) -> ResidentCatalog:
        """Map + shuffle ``items`` once into resident tiers on the
        service's device under ``name``; every later query against ``name``
        is a pure reduce. Under a mesh every rank calls it alike (SPMD),
        before ``start``."""
        if self.closed:
            raise RuntimeError("MRQueryService is closed")
        cat = shuffle_once(partitioner, items, codec=codec, tile=tile,
                           pad_value=pad_value, device=self.device,
                           mesh=self.mesh)
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
        if self._plane is not None and not self._plane.is_leader:
            raise RuntimeError(
                f"MRQueryService under a mesh: rank {self._plane.rank} takes "
                f"no clients; submit on the mesh's first rank "
                f"({self._plane.leader}), whose batches this rank follows")
        if self._failure is not None:
            raise RuntimeError("MRQueryService: the mesh's control plane "
                               "failed") from self._failure
        cat = self.catalogs.get(catalog)
        if cat is None:
            raise KeyError(f"no catalog {catalog!r} loaded "
                           f"(have {sorted(self.catalogs)}); "
                           f"call load_catalog() first")
        cat.validate([job])
        if self._plane is not None:
            # the first rank broadcasts every admitted job to the others: a
            # job that does not pickle fails here, not in its batch
            try:
                pickle.dumps(job)
            except Exception as e:
                raise TypeError(
                    f"job {job.name!r} does not pickle, so it cannot reach "
                    f"the mesh's other ranks: {type(e).__name__}: {e}") from e
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

    def _admit(self, idle_s: float | None = None) -> list[MRRequest]:
        """Take one micro-batch off the queue (worker thread): the first
        waiting request opens an admission window that closes after
        ``max_wait_s`` OR as soon as ``max_batch`` requests are queued:
        waiting fills the batch (throughput), the deadline bounds queue
        wait (latency). -> [] at a stop, or after ``idle_s`` with nothing
        queued."""
        give_up = None if idle_s is None else time.monotonic() + idle_s
        with self._cond:
            while not self._queue and not self._stop.is_set():
                if give_up is not None and time.monotonic() >= give_up:
                    return []
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

    def _take(self, k: int) -> list[MRRequest]:
        with self._cond:
            k = max(1, min(int(k), len(self._queue)))
            return [self._queue.popleft() for _ in range(k)] \
                if self._queue else []

    @staticmethod
    def _coalesce(batch: list[MRRequest]) -> list[_Group]:
        """Group a batch by catalog, in order of first appearance, and map
        each request onto its catalog's distinct jobs (``_job_key``)."""
        groups: dict[str, _Group] = {}
        keys: dict[str, list] = {}
        for r in batch:
            g = groups.setdefault(r.catalog, _Group(r.catalog, [], [], []))
            ks = keys.setdefault(r.catalog, [])
            k = _job_key(r.job)
            try:
                g.slots.append(ks.index(k))
            except ValueError:
                g.slots.append(len(g.jobs))
                ks.append(k)
                g.jobs.append(r.job)
            g.reqs.append(r)
        return list(groups.values())

    def _run_batch(self, batch: list[MRRequest]) -> None:
        """Serve one admitted micro-batch on one card: group by catalog,
        coalesce duplicate jobs, one fused batched reduce per catalog group
        (``_partials``), then finalize, stamp RequestStats, wake waiters and
        feed the straggler hook (``_commit``, with no mesh to sum over).
        Bookkeeping appends under a lock so lane-concurrent batches cannot
        interleave records."""
        t_admit = self.clock()
        t_span0 = time.perf_counter()
        groups = self._coalesce(batch)
        self._commit({"batch": batch, "groups": groups, "t_admit": t_admit,
                      "t_span0": t_span0, "parts": self._partials(groups)})

    @staticmethod
    def _isolated(jobs, run) -> list:
        """``run(jobs)``, one value a job, as ``[(value, None), ...]``. When
        the fused call raises, each job runs alone, so one poison query
        cannot fail its coalesced batch-mates: ``(None, its exception)``
        for a job that raises alone."""
        try:
            return [(v, None) for v in run(jobs)]
        except Exception:
            outs = []
            for job in jobs:
                try:
                    outs.append((run([job])[0], None))
                except Exception as e:
                    outs.append((None, e))
            return outs

    def _record(self, batch, n_unique: int, t_admit: float, t_span0: float,
                **extra) -> None:
        """Stamp a served batch: its record, its requests' RequestStats,
        the metrics, the straggler hook and the trace span; then wake the
        requests' waiters."""
        tr = get_tracer()
        t_done = self.clock()
        wall = t_done - t_admit
        m = self.metrics
        with self._blk:
            bidx = len(self.batches)
            self.batches.append({"batch": bidx, "size": len(batch),
                                 "n_unique": n_unique, "wall_s": wall,
                                 **extra})
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

    # -- under a mesh: lead or follow, reduce, commit in order ---------------

    def _lead(self, batch: list[MRRequest]) -> None:
        """First rank: coalesce the batch and broadcast it, then reduce it
        like every other rank."""
        t_admit = self.clock()
        t_span0 = time.perf_counter()
        groups = self._coalesce(batch)
        at = {id(r): i for i, r in enumerate(batch)}
        try:
            self._plane.send(_BATCH, [r.rid for r in batch],
                             [(g.catalog, [at[id(r)] for r in g.reqs],
                               g.jobs, g.slots) for g in groups])
        except BaseException as e:
            self._abandon(batch, e)
            raise
        self._reduce_then_commit(batch, groups, t_admit, t_span0)

    def _follow(self, until: str) -> int:
        """Another rank: receive the first rank's batches and serve each
        until the message ``until`` (``_DRAINED`` or ``_STOP``; a stop ends
        any wait). -> requests served."""
        served = 0
        while True:
            msg = self._plane.recv()
            if msg[0] == _BATCH:
                t_admit = self.clock()
                t_span0 = time.perf_counter()
                rids, desc = msg[1:]
                batch: list = [None] * len(rids)
                groups = []
                for cname, at, jobs, slots in desc:
                    reqs = []
                    for i, s in zip(at, slots):
                        batch[i] = MRRequest(rids[i], jobs[s], cname, t_admit)
                        reqs.append(batch[i])
                    groups.append(_Group(cname, reqs, jobs, slots))
                self.followed.extend(batch)
                self._reduce_then_commit(batch, groups, t_admit, t_span0)
                served += len(batch)
            elif msg[0] == _STOP:
                self._stopped = True
                with self._cond:
                    self.closed = True
                return served
            elif msg[0] == until:
                return served

    def _reduce_then_commit(self, batch, groups, t_admit, t_span0) -> None:
        """Reduce a batch's distinct jobs on this rank (here, or on a lane),
        then commit it: here when nothing runs in the background, else on
        the commit thread, in key order."""
        st = {"batch": batch, "groups": groups, "t_admit": t_admit,
              "t_span0": t_span0}
        key, self._nbatch = self._nbatch, self._nbatch + 1
        if self._pool is not None:
            # the pool's on_commit hands the result to the commit thread
            self._pool.submit(key, lambda cancel: dict(
                st, parts=self._partials(groups)))
        elif self._committer is not None:
            self._ready_put(key, dict(st, parts=self._partials(groups)))
        else:
            self._commit(dict(st, parts=self._partials(groups)))
            self._next = self._nbatch

    def _partials(self, groups) -> list:
        """This rank's partial totals of every distinct job, with no
        collective. Failure isolation: coalescing maps many requests onto
        one fused reduce, so when it fails each distinct job reduces alone
        (``_isolated``): only the requests mapped to the failing job see its
        error; batch-mates are served. -> per group, per job, (tensor or
        None, exception or None)."""
        return [self._isolated(g.jobs, lambda jobs, cat=self.catalogs[
            g.catalog]: cat.partials(jobs)[0]) for g in groups]

    def _commit(self, st: dict) -> None:
        """Finalize a reduced batch and serve its requests. Under a mesh,
        every rank, in batch order, first exchanges the per-job reports and
        sums the partials of the jobs no rank failed in one all-reduce over
        ``data`` (one a dtype; every reducer of the repo returns int64)."""
        plane = self._plane
        t0 = time.perf_counter()
        reports = {} if plane is None else plane.exchange([
            [("ok", tuple(t.shape), str(t.dtype)) if e is None
             else ("err", f"{type(e).__name__}: {e}") for t, e in res]
            for res in st["parts"]])
        report_s = time.perf_counter() - t0
        errors, ok = {}, {}
        for gi, (g, res) in enumerate(zip(st["groups"], st["parts"])):
            for ji, (t, e) in enumerate(res):
                said = {r: rep[gi][ji] for r, rep in sorted(reports.items())}
                bad = [(r, v[1]) for r, v in said.items() if v[0] == "err"]
                if e is not None:
                    errors[gi, ji] = e            # this rank's own
                elif bad:
                    r, msg = bad[0]
                    errors[gi, ji] = RuntimeError(
                        f"job {g.jobs[ji].name!r} failed on rank {r}: {msg}")
                elif len(set(said.values())) > 1:
                    errors[gi, ji] = RuntimeError(
                        f"job {g.jobs[ji].name!r}: the ranks' partials "
                        f"differ in shape or dtype: {said}")
                else:
                    ok.setdefault(t.dtype, []).append(((gi, ji), t))
        stats = StageStats()
        summed = {}
        sharded = plane is not None and plane.sharded
        for items in ok.values():
            if not sharded:
                summed.update(items)
                continue
            flat = torch.cat([t.reshape(-1) for _, t in items])
            (flat,) = _psum_partials((flat,), self.mesh, self.device, stats)
            off = 0
            for key, t in items:
                summed[key] = flat[off:off + t.numel()].reshape(t.shape)
                off += t.numel()
        for gi, g in enumerate(st["groups"]):
            outs = []
            for ji, job in enumerate(g.jobs):
                if (gi, ji) in errors:
                    outs.append((None, errors[gi, ji]))
                    continue
                try:
                    outs.append((job.reducer.finalize(
                        summed[gi, ji], self.catalogs[g.catalog].sd), None))
                except Exception as e:
                    outs.append((None, e))
            for r, s in zip(g.reqs, g.slots):
                r.output, r.error = outs[s]
        extra = {} if plane is None else {
            "allreduces": len(ok) if sharded else 0,
            "collective_wall_s": stats.collective_wall_s,
            "report_wall_s": report_s}
        self._record(st["batch"], sum(len(g.jobs) for g in st["groups"]),
                     st["t_admit"], st["t_span0"], **extra)

    def _ready_put(self, key: int, st: dict) -> None:
        with self._seq:
            if self._failure is None:
                self._ready[key] = st
                self._seq.notify_all()
                return
        self._abandon(st["batch"], self._failure)

    def _commit_loop(self) -> None:
        """The commit thread: commit reduced batches in key order. A batch
        dispatched and not reduced within ``MESH_TIMEOUT_S`` fails the
        service."""
        self._on_device()
        stream = (torch.cuda.stream(torch.cuda.Stream(self.device))
                  if self.device.type == "cuda" else contextlib.nullcontext())
        try:
            with stream:
                while True:
                    waited_since = None
                    with self._seq:
                        while self._next not in self._ready:
                            if self._commit_stop and self._next >= self._nbatch:
                                return
                            fatal = getattr(self._pool, "_fatal", None)
                            if fatal is not None:
                                raise fatal
                            if self._next < self._nbatch:
                                now = time.monotonic()
                                waited_since = waited_since or now
                                if now - waited_since > MESH_TIMEOUT_S:
                                    raise TimeoutError(
                                        f"MRQueryService: batch {self._next} "
                                        f"not reduced within "
                                        f"{MESH_TIMEOUT_S} s")
                            self._seq.wait(timeout=0.05)
                        st = self._ready.pop(self._next)
                        self._next += 1
                    self._commit(st)
        except BaseException as e:
            self._fail(e)

    def _fail(self, e: BaseException) -> None:
        """The control plane or the commit failed: fail every request still
        waiting for a commit, and refuse new work."""
        with self._seq:
            if self._failure is None:
                self._failure = e
            waiting = list(self._ready.values())
            self._ready.clear()
        for st in waiting:
            self._abandon(st["batch"], e)

    @staticmethod
    def _abandon(batch, cause: BaseException) -> None:
        for r in batch:
            if not r.done:
                r.error = RuntimeError(f"request {r.rid}: the service's mesh "
                                       f"plane failed: {cause!r}")
                r._done.set()

    def _on_device(self) -> None:
        """Make the service's card this thread's current device (a new
        thread starts on card 0)."""
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)

    # -- execution: synchronous drain or background serving thread ----------

    def run_pending(self, *, batch_sizes=None) -> int:
        """Synchronously drain the queue in micro-batches. ``batch_sizes``
        forces an explicit partition of the queue (replay / determinism
        tests); default chunks by ``max_batch`` with no admission wait.
        Under a mesh the other ranks serve the same batches in their own
        ``run_pending``, which returns when this one does.
        -> number of requests served."""
        plane = self._plane
        if plane is not None and self._thread is not None:
            raise RuntimeError("run_pending() under a mesh while the serving "
                               "thread runs: every batch goes through it")
        if plane is not None and not plane.is_leader:
            return 0 if self._stopped else self._follow(_DRAINED)
        sizes = iter(batch_sizes if batch_sizes is not None else [])
        served = 0
        while True:
            batch = self._take(next(sizes, self.max_batch))
            if not batch:
                break
            if plane is not None:
                self._lead(batch)
            else:
                self._run_batch(batch)
            served += len(batch)
        if plane is not None:
            plane.send(_DRAINED)
        return served

    def _serve_loop(self) -> None:
        """Admission loop. With a lane pool, admitted micro-batches are
        SUBMITTED and run concurrently across lanes (each on a CUDA stream
        of its own on the card); a lane death shrinks the pool and requeues
        the batch onto the survivors instead of killing the service. Under
        a mesh each batch is led (``_lead``), and a quarter of
        ``MESH_TIMEOUT_S`` with nothing admitted sends the other ranks a
        heartbeat, so their wait for the next batch times out only when
        this rank is gone."""
        plane = self._plane
        self._on_device()
        try:
            while True:
                t0 = time.perf_counter()
                batch = self._admit(None if plane is None
                                    else MESH_TIMEOUT_S / 4)
                if batch:
                    tr = get_tracer()
                    if tr.enabled:
                        # covers waiting for the first request plus the
                        # admission window it opened
                        tr.record("service-admit", t0, time.perf_counter(),
                                  cat="service", size=len(batch))
                    if plane is not None:
                        self._lead(batch)
                    elif self._pool is not None:
                        key, self._nbatch = self._nbatch, self._nbatch + 1
                        self._pool.submit(
                            key, (lambda b: lambda cancel: self._run_batch(b))(
                                batch))
                    else:
                        self._run_batch(batch)
                elif self._stop.is_set():
                    return
                else:                    # idle under a mesh: a heartbeat
                    plane.send(_IDLE)
        except BaseException as e:
            if plane is None:
                raise
            self._fail(e)

    def _follow_loop(self) -> None:
        self._on_device()
        try:
            self._follow(_STOP)
        except BaseException as e:
            self._fail(e)

    def start(self) -> "MRQueryService":
        """Start the background admission/serving thread (idempotent); with
        ``n_lanes > 1`` also start the concurrent-batch lane pool. Under a
        mesh the first rank's thread admits, the others' follow, and each
        rank starts its commit thread."""
        if self.closed:
            raise RuntimeError("MRQueryService is closed")
        if self._thread is None:
            plane = self._plane
            if self.n_lanes > 1 and self._pool is None:
                from repro_torch.mapreduce.executor import LanePool
                self._pool = LanePool(
                    self.n_lanes, chaos=self.lane_chaos, max_retries=0,
                    devices=[self.device], name="mr-batch",
                    on_commit=(None if plane is None else
                               lambda key, st, meta: self._ready_put(key, st)))
            if plane is not None and self._committer is None:
                self._commit_stop = False
                self._committer = threading.Thread(
                    target=self._commit_loop, name="mr-commit", daemon=True)
                self._committer.start()
            self._stop.clear()
            target = (self._serve_loop if plane is None or plane.is_leader
                      else self._follow_loop)
            self._thread = threading.Thread(target=target,
                                            name="mr-service", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Reject further submits, serve everything already queued, and
        stop the worker (and the lane pool, raising if a lane thread
        outlived the join). Idempotent; also the context-manager exit.
        Under a mesh the first rank then broadcasts a stop; the others'
        ``close`` serves the batches up to it and returns there."""
        with self._cond:
            self.closed = True
            self._stop.set()
            self._cond.notify_all()
        plane = self._plane
        join_s = 60.0 if plane is None else MESH_TIMEOUT_S + 30.0
        if self._thread is not None:
            self._thread.join(timeout=join_s)
            if self._thread.is_alive():
                raise RuntimeError(f"MRQueryService: the admission thread "
                                   f"did not stop within {join_s} s")
            self._thread = None
        if plane is None:
            self.run_pending()           # anything the worker left behind
        elif not self._finished and self._failure is None:
            if plane.is_leader:
                while True:              # anything the worker left behind
                    batch = self._take(self.max_batch)
                    if not batch:
                        break
                    self._lead(batch)
                plane.send(_STOP)
            elif not self._stopped:
                self._follow(_STOP)
        if self._committer is not None:
            with self._seq:
                self._commit_stop = True
                self._seq.notify_all()
            self._committer.join(timeout=join_s)
            if self._committer.is_alive():
                raise RuntimeError(f"MRQueryService: the commit thread did "
                                   f"not stop within {join_s} s")
            self._committer = None
        self._finished = True
        if self._pool is not None:
            pool, self._pool = self._pool, None
            try:
                pool.drain()             # in-flight lane batches finish
            finally:
                pool.shutdown()          # raises on leaked lane threads
        if self._failure is not None:
            raise RuntimeError("MRQueryService: the mesh's control plane "
                               "failed") from self._failure

    def __enter__(self) -> "MRQueryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- accounting ---------------------------------------------------------

    def latency_summary(self) -> dict:
        """qps + p50/p99 latency over everything served so far."""
        return latency_summary(self.request_stats)
