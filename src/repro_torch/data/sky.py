"""Synthetic astronomy catalogs (the paper's input data, generated).

Points uniform on the unit sphere; the Zones algorithm [Gray et al., MSR-TR-2006-52]
partitions by declination zones of height h (radians). Distances are angular:
theta(a, b) = arccos(a . b); neighbors: theta <= radius.

numpy only, and the same generator as ``repro.data.sky`` so both packages see
identical catalogs from one seed.
"""
from __future__ import annotations

import numpy as np

ARCSEC = np.pi / (180.0 * 3600.0)


def make_catalog(n: int, seed: int = 0) -> np.ndarray:
    """-> unit vectors [n, 3] float32, uniform on the sphere."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2 * np.pi, n)
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    axis=1).astype(np.float32)


def dec_of(xyz: np.ndarray) -> np.ndarray:
    return np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0))


def n_zones(zone_height: float) -> int:
    return int(np.ceil(np.pi / zone_height))


def brute_force_pairs(xyz: np.ndarray, radius_rad: float) -> int:
    """O(n^2) oracle: number of unordered pairs within radius."""
    dots = xyz @ xyz.T
    np.fill_diagonal(dots, -2.0)
    return int(np.sum(dots >= np.cos(radius_rad)) // 2)


def brute_force_hist(xyz: np.ndarray, edges_rad: np.ndarray) -> np.ndarray:
    """Pair-distance histogram oracle (the Neighbor Statistics application)."""
    dots = np.clip(xyz @ xyz.T, -1.0, 1.0)
    iu = np.triu_indices(len(xyz), k=1)
    theta = np.arccos(dots[iu])
    h, _ = np.histogram(theta, bins=edges_rad)
    return h
