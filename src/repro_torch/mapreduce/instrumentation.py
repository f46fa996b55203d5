"""Per-stage accounting for MapReduce jobs (the paper's Table 4, per job).

The port of ``repro.mapreduce.instrumentation.StageStats`` with the fields
the device and host engines' one-split paths fill. Walls are fenced with
``torch.cuda.synchronize()`` on the card, so a stage reports device time,
not dispatch time. ``device`` names where the run executed.
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
    # cost-model predictions: not ported yet, always 0
    predicted_shuffle_wall_s: float = 0.0
    predicted_reduce_wall_s: float = 0.0

    @property
    def wall_s(self) -> float:
        return self.map_wall_s + self.shuffle_wall_s + self.reduce_wall_s

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
                 "reduce": self.reduce_wall_s}
        return max(times, key=times.get)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(wall_s=self.wall_s, dominant_stage=self.dominant_stage,
                 compression_ratio=self.compression_ratio)
        return d
