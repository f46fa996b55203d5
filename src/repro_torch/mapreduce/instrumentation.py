"""Per-stage accounting for MapReduce jobs (the paper's Table 4, per job).

The port of ``repro.mapreduce.instrumentation.StageStats`` with the fields
the device and host engines and the streaming executor fill. Walls are
fenced on the card by synchronising the current stream, so a stage reports
device time, not dispatch time. ``device`` names where the run executed.

Streaming runs (``mapreduce/executor.py``) add a fourth boundary: splits are
fetched and copied to the card while earlier splits compute, so split I/O
divides into *exposed* time (``fetch_wall_s``, the executor actually
blocked; part of ``wall_s``) and *hidden* time (``overlap_hidden_s``,
prefetch work that ran under compute). ``splits`` keeps one record per
split for straggler analysis. With concurrent lanes the stage walls sum
over lanes, and ``elapsed_s`` carries the run's own wall.

The external shuffle (``mapreduce/spill.py``) adds the disk boundary
(``spill_*``), and an energy meter (``obs/energy.py``) fills the joule
fields, from which ``rows_per_joule``, the paper's unit, follows.

``roofline()`` recasts a run as ``core.amdahl.RooflineTerms`` (map + reduce
bytes -> the memory term, shuffle wire bytes -> the collective term, reduce
FLOPs -> the compute term), priced at the card's ``DeviceSpec``, so the
paper's AD / ADN / dominant-resource analysis falls out of any job. The
cost model (``core/cost_model.py``) records its predicted stage walls
beside the measured ones (``prediction_error``).

``RequestStats`` and ``latency_summary`` are the MapReduce query service's
per-request twin (``serving/mr_service.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.amdahl import DeviceSpec, RooflineTerms, device_spec


@dataclasses.dataclass
class StageStats:
    """Bytes, FLOPs, and wall time per MapReduce stage of one job run."""

    job: str = ""
    codec: str = "identity"
    engine: str = "device"             # which engine ran: "device" | "host"
    device: str = ""                   # torch device the run executed on
    n_items: int = 0
    n_partitions: int = 0
    n_shards: int = 1                  # mesh data-axis size the reduce ran over
    # map: key assignment + border replication + wire encode
    map_wall_s: float = 0.0
    map_bytes: int = 0                 # input bytes read by the mappers
    # shuffle: count, tier plan, sort, scatter into padded tiers
    shuffle_wall_s: float = 0.0
    shuffle_wire_bytes: int = 0        # bytes that crossed the shuffle
    shuffle_raw_bytes: int = 0         # float32-equivalent (compression baseline)
    shuffle_index_impl: str = ""       # index path: "torch" (device) | "numpy" (host)
    # reduce: decode + pair kernels (per tier, or over all partitions)
    reduce_wall_s: float = 0.0
    reduce_flops: float = 0.0
    reduce_bytes: int = 0              # resident wire bytes the reduce streams
    reduce_padded_ratio: float = 1.0   # padded / real pair cells (capacity waste)
    tiers: tuple = ()                  # (Pt, C1, C2) per capacity tier (host: one)
    # per-shard padded/real pair-cell ratios, length n_shards (a shard of
    # pure phantom padding shows its full padded cell count: load imbalance
    # and phantom waste in one vector)
    shard_padded_ratio: tuple = ()
    # the all-reduces of the shard partials under a mesh, fenced: part of
    # reduce_wall_s
    collective_wall_s: float = 0.0
    # streaming (split) execution: one record per split plus the
    # exposed-vs-hidden split I/O decomposition
    n_splits: int = 1
    combiner: str = ""                 # active map-side combiner ("" = none)
    fetch_wall_s: float = 0.0          # split fetch/transfer the run WAITED on
    combine_wall_s: float = 0.0        # cross-split combine of partials
    overlap_hidden_s: float = 0.0      # prefetch work hidden under compute
    splits: tuple = ()                 # per-split record dicts (see executor)
    # external shuffle (disk spill): wire streams written to / read back from
    # the spill store when the accumulated mapped splits exceed the budget.
    # spill_wall_s is the EXPOSED spill I/O (flush waits + read-back waits
    # the executor actually blocked on; async write time hidden under map
    # compute lands in overlap_hidden_s like any other hidden I/O)
    spill_bytes: int = 0               # wire bytes written to spill segments
    spill_wall_s: float = 0.0          # exposed spill write + read-back wall
    spilled_splits: int = 0            # splits whose streams went to disk
    spill_peak_bytes: int = 0          # max resident wire bytes observed
    spill_chunk_bytes: int = 0         # largest single spill chunk written
    spill_ranges: int = 0              # partition ranges streamed back
    # lane execution (concurrent splits + speculative re-execution): with
    # n_lanes > 1 the per-stage walls above are SUMS over lanes that ran
    # concurrently, so ``elapsed_s`` carries the true end-to-end wall
    n_lanes: int = 1
    elapsed_s: float = 0.0             # measured end-to-end wall (0 = wall_s)
    speculated: int = 0                # clone dispatches the policy triggered
    clone_wins: int = 0                # splits where the clone finished first
    retries: int = 0                   # transient-fault re-dispatches
    lane_walls: tuple = ()             # per-lane busy seconds, length n_lanes
    # cost-model accounting (core/cost_model.py): the predicted stage walls
    # recorded alongside the measured ones, so model error is observable in
    # every run, and the tile the model resolved when tile="auto"
    predicted_shuffle_wall_s: float = 0.0
    predicted_reduce_wall_s: float = 0.0
    auto_tile: int = 0                 # 0 = tile was not auto-planned
    # energy accounting (obs/energy.py): joules per stage, measured (RAPL/
    # NVML counter deltas spread by active-wall share) or modeled
    # (PowerProfile watts x stage wall). All zero when metering is off.
    energy_j: float = 0.0              # total joules attributed to this run
    map_energy_j: float = 0.0
    shuffle_energy_j: float = 0.0
    reduce_energy_j: float = 0.0
    fetch_energy_j: float = 0.0
    combine_energy_j: float = 0.0
    spill_energy_j: float = 0.0
    energy_source: str = ""            # "" off | "modeled:<profile>" | "rapl" | "nvml"

    # per-stage accumulator fields that add across per-split / per-lane
    # partial StageStats when lanes merge their local stats into the shared one
    _ACCUM_FIELDS = ("n_items", "map_wall_s", "map_bytes", "shuffle_wall_s",
                     "shuffle_wire_bytes", "shuffle_raw_bytes",
                     "reduce_wall_s", "reduce_flops", "reduce_bytes",
                     "collective_wall_s", "fetch_wall_s", "combine_wall_s",
                     "overlap_hidden_s",
                     "spill_bytes", "spill_wall_s", "spilled_splits",
                     "speculated", "clone_wins", "retries",
                     "predicted_shuffle_wall_s", "predicted_reduce_wall_s",
                     "energy_j", "map_energy_j", "shuffle_energy_j",
                     "reduce_energy_j", "fetch_energy_j", "combine_energy_j",
                     "spill_energy_j")

    def merge_from(self, other: "StageStats") -> "StageStats":
        """Fold a per-split/per-lane partial ``StageStats`` into this one:
        accumulator fields add; identity fields (partition geometry, shard
        count, index impl, device, tiers, auto tile, energy source) adopt
        the partial's value when unset here.
        Lanes each fill a private partial and commit it under the pool lock,
        so concurrent lanes never mutate the shared stats mid-stage."""
        for f in self._ACCUM_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in ("n_partitions", "n_shards", "shuffle_index_impl", "device",
                  "tiers", "auto_tile", "energy_source"):
            if getattr(self, f) in (0, 1, "", ()):
                setattr(self, f, getattr(other, f))
        return self

    @property
    def prediction_error(self) -> float:
        """Worst predicted-vs-actual stage-wall ratio, folded to >= 1.0
        (a 2.0 means the cost model was off by 2x in either direction on
        some stage); 0.0 when no prediction was recorded."""
        errs = [max(p / a, a / p) for p, a in
                ((self.predicted_shuffle_wall_s, self.shuffle_wall_s),
                 (self.predicted_reduce_wall_s, self.reduce_wall_s))
                if p > 0.0 and a > 0.0]
        return max(errs) if errs else 0.0

    @property
    def wall_s(self) -> float:
        return (self.map_wall_s + self.shuffle_wall_s + self.reduce_wall_s
                + self.fetch_wall_s + self.combine_wall_s
                + self.spill_wall_s)

    @property
    def run_wall_s(self) -> float:
        """The run's true end-to-end wall: the measured elapsed time when
        lanes ran splits concurrently (stage walls then sum ACROSS lanes and
        over-count), else the stage-wall sum."""
        return self.elapsed_s if self.elapsed_s > 0 else self.wall_s

    @property
    def overlap_fraction(self) -> float:
        """Fraction of total split-I/O time hidden under compute (1.0 =
        perfectly overlapped, 0.0 = fully exposed or not streaming)."""
        total = self.overlap_hidden_s + self.fetch_wall_s
        return self.overlap_hidden_s / total if total > 0 else 0.0

    @property
    def rows_per_joule(self) -> float:
        """Work per joule — the paper's energy-efficiency unit (its 7.7x /
        3.4x ratios are this number, blade over cluster). 0.0 when no
        metering was active."""
        return self.n_items / self.energy_j if self.energy_j > 0 else 0.0

    @property
    def compression_ratio(self) -> float:
        """Raw/wire shuffle bytes (1.0 = identity, 2.0 = int16, ~2.4 = int8)."""
        if not self.shuffle_wire_bytes:
            return 1.0
        return self.shuffle_raw_bytes / self.shuffle_wire_bytes

    @property
    def dominant_stage(self) -> str:
        """Which stage dominated wall time (the paper's per-task breakdown)."""
        times = {"map": self.map_wall_s, "shuffle": self.shuffle_wall_s,
                 "reduce": self.reduce_wall_s, "fetch": self.fetch_wall_s,
                 "combine": self.combine_wall_s, "spill": self.spill_wall_s}
        return max(times, key=times.get)

    def roofline(self, chips: int = 1, chip_w: float = 0.0,
                 spec: DeviceSpec = None) -> RooflineTerms:
        """Recast as three-resource roofline terms (Amdahl-number analysis)
        priced at ``spec`` (None: the spec of the card the run used; a CPU
        run has none and needs one passed). Spilled bytes cross the memory
        boundary twice (write + read back), the paper's disk term folded
        into the HBM analogue. Pass ``chip_w`` (watts per chip, e.g. the
        spec's power limit) to get the balance point in watts as well as
        chips."""
        if spec is None:
            spec = device_spec(self.device or None)
        return RooflineTerms.from_stage_bytes(
            flops=self.reduce_flops,
            hbm_bytes=self.map_bytes + self.reduce_bytes
            + 2 * self.spill_bytes,
            wire_bytes=self.shuffle_wire_bytes,
            chips=chips, chip_w=chip_w, spec=spec)

    def to_dict(self, chips: int = 1, spec: DeviceSpec = None) -> dict:
        """Every field and derived number. ``amdahl`` is ``roofline(chips,
        spec=spec)``'s dict, or None for a run off the card with no spec
        given (no CPU spec exists)."""
        d = dataclasses.asdict(self)
        d.update(wall_s=self.wall_s, dominant_stage=self.dominant_stage,
                 compression_ratio=self.compression_ratio,
                 overlap_fraction=self.overlap_fraction,
                 prediction_error=self.prediction_error,
                 rows_per_joule=self.rows_per_joule)
        on_card = self.device.startswith("cuda")
        d["amdahl"] = (self.roofline(chips, spec=spec).to_dict()
                       if spec is not None or on_card else None)
        return d


@dataclasses.dataclass
class RequestStats:
    """Per-request latency accounting for the MapReduce query service
    (``serving/mr_service.py``), the request-level twin of the per-run
    ``StageStats``: how long the request waited in the submit queue, which
    micro-batch admitted it, and the wall of that batch's fused reduce.
    One batch serves many requests, so ``batch_wall_s`` repeats across the
    batch's members while ``queue_wait_s``/``latency_s`` are per-request."""

    rid: int = -1
    job: str = ""
    catalog: str = ""
    batch_index: int = -1       # micro-batch that served this request
    batch_size: int = 0         # requests admitted into that batch
    n_unique: int = 0           # distinct jobs the batch ran after coalescing
    t_submit_s: float = 0.0     # service-clock submit time
    queue_wait_s: float = 0.0   # submit -> admitted into a micro-batch
    batch_wall_s: float = 0.0   # the admitting batch's end-to-end wall
    latency_s: float = 0.0      # submit -> result ready

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def latency_summary(requests) -> dict:
    """Aggregate a stream of ``RequestStats`` into service-level numbers:
    queries/s over the observed span plus p50/p99 latency and queue wait,
    the latency-vs-throughput trade the admission window buys (the paper's
    consolidation question, asked of tails instead of means)."""
    reqs = list(requests)
    if not reqs:
        return {"n": 0, "span_s": 0.0, "qps": 0.0, "p50_ms": 0.0,
                "p99_ms": 0.0, "wait_p50_ms": 0.0, "wait_p99_ms": 0.0,
                "mean_batch": 0.0}
    lat = np.array([r.latency_s for r in reqs])
    wait = np.array([r.queue_wait_s for r in reqs])
    t0 = min(r.t_submit_s for r in reqs)
    span = max(r.t_submit_s + r.latency_s for r in reqs) - t0
    # A single request (or simultaneous zero-latency ones) spans ~0 s;
    # dividing by a floored span would report ~1e9 qps. A degenerate span
    # carries no throughput information, so report qps = 0 and let the
    # caller read span_s.
    qps = len(reqs) / span if span > 1e-9 else 0.0
    return {
        "n": len(reqs),
        "span_s": float(span),
        "qps": qps,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "wait_p50_ms": float(np.percentile(wait, 50)) * 1e3,
        "wait_p99_ms": float(np.percentile(wait, 99)) * 1e3,
        "mean_batch": float(np.mean([r.batch_size for r in reqs])),
    }
