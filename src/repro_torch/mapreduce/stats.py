"""Neighbor Statistics (the paper's compute-intensive app) as a MapReduce job.

Same map/shuffle stages as Neighbor Searching (shared via ``ZonePartitioner``
— batch both apps over one shuffle with ``run_jobs``); the reducer emits
cumulative counts per angular edge, and ``finalize`` (the paper's second,
trivial MapReduce) removes self pairs, halves the double count, and
differentiates the cumulative counts into a histogram.

``neighbor_statistics`` keeps the original signature as a deprecated
wrapper over ``neighbor_statistics_job`` + ``run_job``.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.data.sky import ARCSEC
from repro_torch.kernels.zones_pairs.ops import pair_hist, pair_hist_masked
from repro_torch.mapreduce.job import MapReduceJob, Reducer, run_job
from repro_torch.mapreduce.zones import ZonePartitioner

DEFAULT_EDGES_ARCSEC = tuple(float(e) for e in range(1, 61))


@dataclasses.dataclass(frozen=True)
class PairHistReducer(Reducer):
    """Cumulative per-edge pair counts per zone tier; finalize
    differentiates."""

    edges_rad: tuple

    def cos_edges(self) -> torch.Tensor:
        """cos of every edge in f64, rounded once to f32."""
        return torch.as_tensor(
            np.cos(np.asarray(self.edges_rad)).astype(np.float32))

    def per_partition(self, owned_p, bucket_p):
        return pair_hist(owned_p, bucket_p, self.cos_edges().to(owned_p.device))

    def per_partition_sum(self, owned, bucket):
        return pair_hist(owned, bucket, self.cos_edges().to(owned.device))

    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        return pair_hist_masked(owned, bucket, n_owned, n_bucket,
                                self.cos_edges().to(owned.device))

    def finalize(self, total, sd):
        cum = total.cpu().numpy().astype(np.int64)
        cum -= int(sd.n_owned.sum())   # self pairs (theta=0) hit every edge
        cum //= 2                      # each unordered pair seen twice
        return np.diff(np.concatenate([[0], cum]))

    def flops(self, sd):
        return sd.pair_cells * (6.0 + len(self.edges_rad))


def neighbor_statistics_job(edges_arcsec=None, *, codec="identity",
                            tile: int = 256,
                            partitioner: ZonePartitioner | None = None,
                            ) -> MapReduceJob:
    """The Neighbor Statistics app as a composable job. The partition radius
    is the largest edge; pass a shared ``partitioner`` to batch with the
    search job over one shuffle."""
    if edges_arcsec is None:
        edges_arcsec = DEFAULT_EDGES_ARCSEC
    edges_rad = tuple(float(e) * ARCSEC for e in np.asarray(edges_arcsec))
    part = partitioner or ZonePartitioner(edges_rad[-1])
    return MapReduceJob("neighbor_statistics", part,
                        PairHistReducer(edges_rad),
                        codec=codec, tile=tile)


def neighbor_statistics(xyz: np.ndarray, *, edges_arcsec=None,
                        compress_coords: bool = False, tile: int = 256,
                        device=None) -> np.ndarray:
    """Deprecated wrapper (use ``neighbor_statistics_job`` + ``run_job``):
    histogram over (0, e1], (e1, e2], ... in arcsec (unordered pairs), on
    the device engine (``device=None`` means the card)."""
    warnings.warn("neighbor_statistics is deprecated; build a job with "
                  "neighbor_statistics_job() and execute it with run_job()",
                  DeprecationWarning, stacklevel=2)
    job = neighbor_statistics_job(
        edges_arcsec, tile=tile,
        codec="int16" if compress_coords else "identity")
    return run_job(job, xyz, device=device).output
