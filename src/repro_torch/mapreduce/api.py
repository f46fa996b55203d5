"""Legacy MapReduce surface, thin shims over the host engine's stages.

The original hard-coded pipeline (``bucket_by_zone`` with a
``compress_coords`` boolean + ``sharded_zone_reduce``) is kept for backward
compatibility; both delegate to ``shuffle_stage`` / ``reduce_stage`` in
``job.py``. New code should build a ``MapReduceJob`` and call
``run_job``/``run_jobs`` instead. ``device=None`` means the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.mapreduce.instrumentation import StageStats
from repro_torch.mapreduce.job import (Reducer, ShuffledData, reduce_stage,
                                       shuffle_stage)
from repro_torch.mapreduce.zones import ZonePartitioner


@dataclasses.dataclass
class ZonedData:
    owned: np.ndarray          # [Z, C1, 3] float32 (zero-padded)
    bucket: np.ndarray         # [Z, C2, 3] float32 (owned + borders, zero-padded)
    n_owned: np.ndarray        # [Z] int32 real counts
    zone_height: float
    radius: float
    shuffle_bytes: int         # bytes that crossed the shuffle (for the benches)


def bucket_by_zone(xyz: np.ndarray, radius: float, *, zone_height: float = 0.0,
                   tile: int = 256, compress_coords: bool = False,
                   pad_zones_to: int = 1, device=None) -> ZonedData:
    """Map + shuffle via ``shuffle_stage`` with a ``ZonePartitioner``;
    ``compress_coords`` selects the int16 codec (the LZO analogue).
    zone_height defaults to the radius (the paper's choice)."""
    part = ZonePartitioner(radius, zone_height)
    stats = StageStats()
    sd = shuffle_stage(xyz, part, "int16" if compress_coords else "identity",
                       tile=tile, pad_partitions_to=pad_zones_to, stats=stats,
                       device=device)
    return ZonedData(sd.owned, sd.bucket, sd.n_owned, part.height, radius,
                     stats.shuffle_wire_bytes)


class _FnReducer(Reducer):
    def __init__(self, fn):
        self._fn = fn

    def per_partition(self, owned_p, bucket_p):
        return self._fn(owned_p, bucket_p)


def sharded_zone_reduce(per_zone_fn, zd: ZonedData, mesh=None, device=None):
    """Apply ``per_zone_fn(owned_z, bucket_z) -> tensor`` to every zone on
    ``device`` and sum the results, sharded over the mesh's data axis when
    given (``bucket_by_zone(pad_zones_to=)`` that axis's size)."""
    sd = ShuffledData(owned=np.asarray(zd.owned), bucket=np.asarray(zd.bucket),
                      n_owned=np.asarray(zd.n_owned),
                      n_bucket=np.zeros(len(zd.n_owned), np.int32))
    return reduce_stage([_FnReducer(per_zone_fn)], sd, device, mesh)[0]
