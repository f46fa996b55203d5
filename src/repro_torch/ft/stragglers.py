"""Straggler detection + mitigation policy (the port of
``repro.ft.stragglers``, pure Python and numpy).

At thousand-node scale some hosts run slow (thermal, faulty HBM, noisy neighbors).
The monitor tracks per-host step-time EMAs; hosts slower than ``k x median`` are
flagged. Mitigation ladder (in order):

1. rebalance: shift microbatch quota away from the straggler (keeps the mesh),
2. exclude: drop the host and trigger an elastic remesh via checkpoint restore.

``SpeculativePolicy`` is the MapReduce-side analogue — Hadoop's speculative
execution: the streaming executor's ``LanePool``
(``mapreduce/executor.py``) feeds it per-split wall times; a running split
whose elapsed time exceeds ``slowdown x`` the median completed-split wall is
a re-dispatch candidate, slowest first, each split cloned at most
``max_clones`` times — and the executor now *executes* the verdict (clone
onto a free lane, first finisher wins).

Both monitors share one ``WallTracker`` core — the per-key latest wall
(optionally EMA-smoothed), the completed-wall stream, and the
``k x median`` slowness test — so lane, host, and batch monitors cannot
drift apart in how they define "slow".

Pure policy logic — deterministic and unit-testable with synthetic timings; the
launcher and lane pool wire it to real step/split times.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


class WallTracker:
    """Shared wall-time state for every straggler-shaped monitor.

    Tracks two views of the same observations: ``by_key`` — the latest wall
    per key, EMA-smoothed when ``ema`` is set (host monitors smooth; split
    monitors don't, a split completes once) — and ``completed``, the raw
    ordered stream of observed walls (what split-median speculation judges
    against). The ``k x median`` slowness test lives here so "slow" means
    the same thing to every consumer.
    """

    def __init__(self, ema: float | None = None):
        self.ema = ema
        self.by_key: dict[int, float] = {}
        self.completed: list[float] = []

    def observe(self, key: int, wall_s: float):
        wall_s = float(wall_s)
        self.completed.append(wall_s)
        prev = self.by_key.get(key)
        a = self.ema
        self.by_key[key] = (wall_s if prev is None or a is None
                            else a * prev + (1 - a) * wall_s)

    def median_by_key(self) -> float:
        return float(np.median(list(self.by_key.values())))

    def median_completed(self) -> float:
        return float(np.median(self.completed))

    @staticmethod
    def is_slow(elapsed_s: float, median_s: float, threshold: float) -> bool:
        return elapsed_s > threshold * median_s


@dataclasses.dataclass
class StragglerConfig:
    ema: float = 0.8
    threshold: float = 1.5          # k x median -> straggler
    patience: int = 3               # consecutive flags before action
    rebalance_cap: float = 0.5      # max fraction of quota that can be shifted
    exclude_after: int = 10         # flags before recommending exclusion


class StragglerMonitor:
    def __init__(self, hosts: list[int], cfg: StragglerConfig | None = None):
        self.cfg = cfg or StragglerConfig()
        self.hosts = list(hosts)
        self.track = WallTracker(ema=self.cfg.ema)
        self.ema = self.track.by_key    # legacy name: per-host smoothed walls
        self.flags: dict[int, int] = defaultdict(int)
        self.quota: dict[int, float] = {h: 1.0 for h in hosts}

    def record(self, host: int, step_time: float):
        self.track.observe(host, step_time)

    def stragglers(self) -> list[int]:
        if len(self.track.by_key) < 2:
            return []
        med = self.track.median_by_key()
        out = []
        for h, t in self.track.by_key.items():
            if self.track.is_slow(t, med, self.cfg.threshold):
                self.flags[h] += 1
                if self.flags[h] >= self.cfg.patience:
                    out.append(h)
            else:
                self.flags[h] = 0
        return out

    def propose(self) -> dict:
        """-> {"action": "none"|"rebalance"|"exclude", ...}."""
        s = self.stragglers()
        if not s:
            return {"action": "none"}
        med = self.track.median_by_key()
        worst = max(s, key=lambda h: self.track.by_key[h])
        if self.flags[worst] >= self.cfg.exclude_after:
            return {"action": "exclude", "host": worst,
                    "surviving": [h for h in self.hosts if h != worst]}
        # shift quota proportionally to the slowdown, capped
        slow = self.track.by_key[worst] / med
        shift = min(1.0 - 1.0 / slow, self.cfg.rebalance_cap)
        new_quota = dict(self.quota)
        taken = new_quota[worst] * shift
        new_quota[worst] -= taken
        others = [h for h in self.hosts if h != worst]
        for h in others:
            new_quota[h] += taken / len(others)
        self.quota = new_quota
        return {"action": "rebalance", "host": worst, "quota": new_quota}


@dataclasses.dataclass
class SpeculativeConfig:
    slowdown: float = 1.5       # elapsed > k x median completed wall -> slow
    min_finished: int = 3       # completed splits needed before judging
    max_clones: int = 1         # re-dispatches allowed per split


class SpeculativePolicy:
    """Hadoop's speculative re-execution as pure, clock-free policy.

    The caller reports ``finished(split, wall_s)`` for completed splits and
    ``running(split, elapsed_s)`` for in-flight ones (elapsed measured by
    the caller — no wall clock in here, so decisions replay exactly in
    tests). ``propose()`` picks the slowest running split whose elapsed
    already exceeds ``slowdown x`` the median completed wall — by then a
    fresh re-execution on a healthy worker is expected to beat the original
    — unless that split has been cloned ``max_clones`` times. The winner of
    original-vs-clone is whichever calls ``finished`` first; duplicates are
    idempotent because split results are deterministic.

    ``mapreduce.executor.LanePool`` executes the verdict: the slow split is
    cloned onto a free lane, the first finisher's result commits, and the
    loser is cancelled between stages and its buffers dropped."""

    def __init__(self, cfg: SpeculativeConfig | None = None):
        self.cfg = cfg or SpeculativeConfig()
        self.track = WallTracker()      # completed-wall stream, no smoothing
        self._running: dict[int, float] = {}
        self.clones: dict[int, int] = defaultdict(int)

    @property
    def walls(self) -> list[float]:
        return self.track.completed

    def running(self, split: int, elapsed_s: float):
        self._running[split] = float(elapsed_s)

    def finished(self, split: int, wall_s: float):
        self._running.pop(split, None)
        self.track.observe(split, wall_s)

    def record(self, split: int, wall_s: float):
        """StragglerMonitor-shaped alias, so the streaming executor can feed
        either monitor through one ``straggler_monitor=`` hook."""
        self.finished(split, wall_s)

    def propose(self) -> dict:
        """-> {"action": "none"} | {"action": "speculate", "split": s,
        "elapsed_s": t, "expected_s": median} (slowest eligible split)."""
        if len(self.walls) < self.cfg.min_finished or not self._running:
            return {"action": "none"}
        med = self.track.median_completed()
        cands = [(t, s) for s, t in self._running.items()
                 if self.track.is_slow(t, med, self.cfg.slowdown)
                 and self.clones[s] < self.cfg.max_clones]
        if not cands:
            return {"action": "none"}
        t, s = max(cands)
        self.clones[s] += 1
        return {"action": "speculate", "split": s, "elapsed_s": t,
                "expected_s": med}
