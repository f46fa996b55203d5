"""Neighbor Searching (the paper's data-intensive app) as a MapReduce job.

Zones algorithm [Gray/Nieto-Santisteban/Szalay, MSR-TR-2006-52]: declination
bands with border replication make each zone bucket self-contained, so a
blockwise pair kernel reduces every zone independently. Every within-radius
unordered pair (p, q) is seen exactly twice across zones (once from each
endpoint's own zone), plus each owned point sees itself once; ``finalize``
corrects for both.

``ZonePartitioner`` is the map-stage plugin (zone assignment + border
replication, as numpy on the host and as tensor ops on the device),
``PairCountReducer`` the reduce-stage plugin. ``neighbor_search_count``
keeps the original signature as a deprecated wrapper.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.data import sky
from repro_torch.kernels.zones_pairs.ops import pair_count, pair_count_masked
from repro_torch.mapreduce.codecs import f32_scalar as _f32
from repro_torch.mapreduce.job import (MapReduceJob, Partitioner, Reducer,
                                       run_job, stable_argsort)

# Border-replication margin: replicating a hair MORE than the radius is
# always safe (extra copies can only re-find pairs that are already counted
# from both endpoints' zones), while replicating a hair less silently drops
# a pair. With zone_height == radius every bucket holds the whole
# neighbouring zones, so a point whose f32 arcsin lands it in the other zone
# (torch and JAX differ in the last bit) still counts exactly its neighbours.
REPLICA_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ZonePartitioner(Partitioner):
    """Declination bands of height ``zone_height`` (default: the radius).
    Points within ``radius`` (+eps) of a band edge are replicated into the
    neighboring band's bucket."""

    radius: float
    zone_height: float = 0.0

    @property
    def height(self) -> float:
        return self.zone_height or max(self.radius, 1e-4)

    def n_partitions(self, items=None):
        return sky.n_zones(self.height)

    def assign(self, items):
        dec = sky.dec_of(items)
        Z = self.n_partitions(items)
        return np.clip(((dec + np.pi / 2) / self.height).astype(np.int32),
                       0, Z - 1)

    def replicas(self, items, keys, n_parts):
        """For k in 0..n_parts-1: (k-1, the items of zone k near its lower
        edge), then (k+1, those near its upper edge), each in index order:
        the JAX package's arrays in its order, from one stable sort of the
        items by zone in place of a ``keys == k`` test per zone."""
        h, margin = self.height, self.radius + REPLICA_EPS
        dec = sky.dec_of(items)
        kf = keys.astype(np.float32)        # f32 edge math, same as device
        lo_edge = (dec - (kf * h - np.pi / 2)) <= margin
        hi_edge = (((kf + 1) * h - np.pi / 2) - dec) <= margin
        inside = np.flatnonzero((keys >= 0) & (keys < n_parts))
        by_zone = inside[stable_argsort(keys[inside], n_parts)]
        splits = []
        for edge in (lo_edge, hi_edge):
            idx = by_zone[edge[by_zone]]
            counts = np.bincount(keys[idx], minlength=n_parts)
            splits.append(np.split(idx, np.cumsum(counts)[:-1]))
        lo, hi = splits
        for k in range(n_parts):
            if k > 0:
                yield k - 1, lo[k]
            if k + 1 < n_parts:
                yield k + 1, hi[k]

    # device map stage: every constant is an f32 tensor on the items' device
    # (a division by a Python scalar on CUDA is a reciprocal multiply). The
    # whole (owned, lower-border, upper-border) entry stream has length 3n.

    def _dec_device(self, items):
        return torch.asin(torch.clamp(items[:, 2], -1.0, 1.0))

    def assign_device(self, items):
        Z = self.n_partitions(items)
        dec = self._dec_device(items)
        zone = (dec + _f32(np.pi / 2, dec)) / _f32(self.height, dec)
        return torch.clamp(zone.to(torch.int32), 0, Z - 1)

    def sort_key_device(self, items):
        return items[:, 2]        # z-order within each zone

    def bucket_entries_device(self, items, keys, n_parts):
        dec = self._dec_device(items)
        h = _f32(self.height, dec)
        half_pi = _f32(np.pi / 2, dec)
        margin = _f32(self.radius + REPLICA_EPS, dec)
        kf = keys.to(torch.float32)
        lo_edge = (dec - (kf * h - half_pi)) <= margin
        hi_edge = (((kf + 1) * h - half_pi) - dec) <= margin
        n = keys.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=keys.device)
        dest = torch.cat([keys, keys - 1, keys + 1])
        src = torch.cat([idx, idx, idx])
        valid = torch.cat([torch.ones(n, dtype=torch.bool, device=keys.device),
                           lo_edge & (keys > 0),
                           hi_edge & (keys + 1 < n_parts)])
        return dest, src, valid


@dataclasses.dataclass(frozen=True)
class PairCountReducer(Reducer):
    """Within-radius pair count per zone tier; finalize removes self pairs
    and the double count."""

    radius: float

    def cos_min(self) -> torch.Tensor:
        """cos(radius) in f64, rounded once to f32 (as the reference does)."""
        return torch.tensor(np.float32(np.cos(self.radius)))

    def per_partition(self, owned_p, bucket_p):
        return pair_count(owned_p, bucket_p, self.cos_min())

    def per_partition_sum(self, owned, bucket):
        return pair_count(owned, bucket, self.cos_min())   # one launch, all P

    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        return pair_count_masked(owned, bucket, n_owned, n_bucket,
                                 self.cos_min())

    def finalize(self, total, sd):
        return (int(total) - int(sd.n_owned.sum())) // 2

    def flops(self, sd):
        # per cell: 3 products + 2 sums + compare and count
        return sd.pair_cells * 8.0


def neighbor_search_job(radius_rad: float, *, zone_height: float = 0.0,
                        codec="identity", tile: int = 256,
                        partitioner: ZonePartitioner | None = None,
                        ) -> MapReduceJob:
    """The Neighbor Searching app as a composable job. Pass ``partitioner``
    explicitly to batch it with other jobs over one shuffle (``run_jobs``)."""
    part = partitioner or ZonePartitioner(radius_rad, zone_height)
    return MapReduceJob("neighbor_search", part,
                        PairCountReducer(radius_rad),
                        codec=codec, tile=tile)


def neighbor_search_count(xyz: np.ndarray, radius_rad: float, *,
                          compress_coords: bool = False, tile: int = 256,
                          zone_height: float = 0.0, device=None) -> int:
    """Deprecated wrapper (use ``neighbor_search_job`` + ``run_job``):
    total number of unordered neighbor pairs within radius, on the device
    engine (``device=None`` means the card)."""
    warnings.warn("neighbor_search_count is deprecated; build a job with "
                  "neighbor_search_job() and execute it with run_job()",
                  DeprecationWarning, stacklevel=2)
    job = neighbor_search_job(radius_rad, zone_height=zone_height,
                              codec="int16" if compress_coords else "identity",
                              tile=tile)
    return run_job(job, xyz, device=device).output


def neighbor_pairs_dense(xyz: np.ndarray, radius_rad: float):
    """Small-N exact pair list (test oracle / example output)."""
    dots = xyz @ xyz.T
    np.fill_diagonal(dots, -2)
    i, j = np.where(dots >= np.cos(radius_rad))
    keep = i < j
    return np.stack([i[keep], j[keep]], axis=1)
