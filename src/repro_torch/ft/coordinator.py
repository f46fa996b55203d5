"""Failure-handling coordinator: heartbeat tracking and liveness verdicts.

The port of ``repro.ft.coordinator``. State machine: HEALTHY -> DEGRADED
(missed heartbeats) -> REMESH (host declared dead) -> HEALTHY (after the
caller has acted). Decisions are pure functions of observed events, so they
can be tested deterministically.

``mapreduce.executor.LanePool`` registers its lanes as "hosts", forwards
each lane's last heartbeat into ``heartbeat()`` from the drain loop, and
executes ``tick()``'s verdicts: "remesh" shrinks the pool and requeues the
dead lanes' in-flight splits, "abort" (below ``min_hosts`` survivors) fails
the job.
"""
from __future__ import annotations

import dataclasses
import enum


class State(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    REMESH = "remesh"


@dataclasses.dataclass
class CoordinatorConfig:
    heartbeat_timeout: float = 30.0
    misses_to_degrade: int = 2
    misses_to_dead: int = 5
    min_hosts: int = 1


class Coordinator:
    def __init__(self, hosts: list[int], cfg: CoordinatorConfig | None = None):
        self.cfg = cfg or CoordinatorConfig()
        self.hosts = set(hosts)
        self.last_seen: dict[int, float] = {}
        self.misses: dict[int, int] = {h: 0 for h in hosts}
        self.state = State.HEALTHY
        self.dead: set[int] = set()

    def heartbeat(self, host: int, now: float):
        self.last_seen[host] = now
        self.misses[host] = 0

    def tick(self, now: float) -> dict:
        """Advance the state machine; returns the action the launcher must take."""
        for h in sorted(self.hosts - self.dead):
            seen = self.last_seen.get(h)
            if seen is None or now - seen > self.cfg.heartbeat_timeout:
                self.misses[h] = self.misses.get(h, 0) + 1
        degraded = [h for h in self.hosts - self.dead
                    if self.misses.get(h, 0) >= self.cfg.misses_to_degrade]
        newly_dead = [h for h in self.hosts - self.dead
                      if self.misses.get(h, 0) >= self.cfg.misses_to_dead]
        if newly_dead:
            self.dead.update(newly_dead)
            surviving = sorted(self.hosts - self.dead)
            if len(surviving) < self.cfg.min_hosts:
                self.state = State.REMESH
                return {"action": "abort", "reason": "below min_hosts"}
            self.state = State.REMESH
            return {"action": "remesh", "dead": sorted(self.dead),
                    "surviving": surviving}
        if degraded:
            self.state = State.DEGRADED
            return {"action": "checkpoint_now", "degraded": degraded}
        self.state = State.HEALTHY
        return {"action": "none"}

    def remesh_done(self):
        self.hosts -= self.dead
        self.state = State.HEALTHY

    def alive(self) -> list[int]:
        """Hosts (or lanes) not declared dead, sorted."""
        return sorted(self.hosts - self.dead)
