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
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StageStats:
    """Bytes, FLOPs, and wall time per MapReduce stage of one job run."""

    job: str = ""
    codec: str = "identity"
    engine: str = "device"             # which engine ran: "device" | "host"
    device: str = ""                   # torch device the run executed on
    n_items: int = 0
    n_partitions: int = 0
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
    # streaming (split) execution: one record per split plus the
    # exposed-vs-hidden split I/O decomposition
    n_splits: int = 1
    combiner: str = ""                 # active map-side combiner ("" = none)
    fetch_wall_s: float = 0.0          # split fetch/transfer the run WAITED on
    combine_wall_s: float = 0.0        # cross-split combine of partials
    overlap_hidden_s: float = 0.0      # prefetch work hidden under compute
    splits: tuple = ()                 # per-split record dicts (see executor)
    # lane execution (concurrent splits + speculative re-execution): with
    # n_lanes > 1 the per-stage walls above are SUMS over lanes that ran
    # concurrently, so ``elapsed_s`` carries the true end-to-end wall
    n_lanes: int = 1
    elapsed_s: float = 0.0             # measured end-to-end wall (0 = wall_s)
    speculated: int = 0                # clone dispatches the policy triggered
    clone_wins: int = 0                # splits where the clone finished first
    retries: int = 0                   # transient-fault re-dispatches
    lane_walls: tuple = ()             # per-lane busy seconds, length n_lanes
    # cost-model predictions: not ported yet, always 0
    predicted_shuffle_wall_s: float = 0.0
    predicted_reduce_wall_s: float = 0.0

    # per-stage accumulator fields that add across per-split / per-lane
    # partial StageStats when lanes merge their local stats into the shared one
    _ACCUM_FIELDS = ("n_items", "map_wall_s", "map_bytes", "shuffle_wall_s",
                     "shuffle_wire_bytes", "shuffle_raw_bytes",
                     "reduce_wall_s", "reduce_flops", "reduce_bytes",
                     "fetch_wall_s", "combine_wall_s", "overlap_hidden_s",
                     "speculated", "clone_wins", "retries",
                     "predicted_shuffle_wall_s", "predicted_reduce_wall_s")

    def merge_from(self, other: "StageStats") -> "StageStats":
        """Fold a per-split/per-lane partial ``StageStats`` into this one:
        accumulator fields add; identity fields (partition geometry, index
        impl, device, tiers) adopt the partial's value when unset here.
        Lanes each fill a private partial and commit it under the pool lock,
        so concurrent lanes never mutate the shared stats mid-stage."""
        for f in self._ACCUM_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in ("n_partitions", "shuffle_index_impl", "device", "tiers"):
            if getattr(self, f) in (0, "", ()):
                setattr(self, f, getattr(other, f))
        return self

    @property
    def wall_s(self) -> float:
        return (self.map_wall_s + self.shuffle_wall_s + self.reduce_wall_s
                + self.fetch_wall_s + self.combine_wall_s)

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
                 "combine": self.combine_wall_s}
        return max(times, key=times.get)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(wall_s=self.wall_s, dominant_stage=self.dominant_stage,
                 compression_ratio=self.compression_ratio,
                 overlap_fraction=self.overlap_fraction)
        return d
