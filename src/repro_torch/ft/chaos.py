"""Fault injection for the lane scheduler — chaos testing the MapReduce path
(the port of ``repro.ft.chaos``).

The paper's cluster survives slow and dying Atom nodes through Hadoop's
retry + speculative re-execution; this module injects exactly those faults
into the repro, deterministically, so the recovery machinery can be tested
and benchmarked instead of trusted:

- ``FaultySplitSource`` wraps any ``SplitSource`` and injects, per split
  index, seeded **delays** (a slow disk/NIC on the node that owns the
  block — by default only the first ``delay_calls`` fetches pay it, so a
  speculative clone's re-fetch on a healthy lane is fast and wins; raise
  ``delay_calls`` to make the slowness data-bound so the clone LOSES) and
  **transient fetch errors** (``TransientSplitError`` for the first
  ``faults[k]`` calls, then success — what bounded-backoff retry exists
  for). Delay sleeps poll a cancel event so a cancelled speculation loser
  wakes immediately instead of serving out its injected stall.
- ``LaneChaos`` injects faults at the lane (worker) level: scheduled
  **lane deaths** (``LaneDeath`` on the n-th task a lane starts — the pool
  must shrink and requeue, not hang) and per-lane **delays** (a uniformly
  slow worker, Hadoop's weak node).

Everything is seeded/deterministic and thread-safe; nothing here imports
the executor, so chaos wrappers compose with any consumer of the split
protocol.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.data.pipeline import SplitSource


class TransientSplitError(RuntimeError):
    """A fetch failure that a retry is expected to cure (flaky I/O)."""


class LaneDeath(RuntimeError):
    """A lane (worker) died mid-run; its queued work must be re-dispatched
    onto the surviving lanes."""


def _interruptible_sleep(seconds: float, cancel=None, poll_s: float = 0.02):
    """Sleep ``seconds`` but wake early if ``cancel`` (threading.Event) is
    set. -> True if the sleep was cut short by cancellation."""
    if seconds <= 0:
        return False
    if cancel is None:
        time.sleep(seconds)
        return False
    deadline = time.perf_counter() + seconds
    while not cancel.is_set():
        left = deadline - time.perf_counter()
        if left <= 0:
            return False
        time.sleep(min(poll_s, left))
    return True


class FaultySplitSource(SplitSource):
    """A ``SplitSource`` with per-split injected delays and transient fetch
    errors.

    - ``delays[k] = s``: fetching split ``k`` sleeps ``s`` seconds, for the
      first ``delay_calls.get(k, 1)`` calls only (the straggler is the slow
      node holding the block; a clone re-fetching elsewhere is fast). Set
      ``delay_calls[k]`` large to make every attempt slow (clone loses).
    - ``faults[k] = n``: the first ``n`` calls for split ``k`` raise
      ``TransientSplitError``; call ``n+1`` succeeds — so a retry budget of
      ``n`` wins and ``n-1`` loses, deterministically.
    - ``seed``/``delay_p``/``fault_p``: optionally derive the two maps
      randomly but reproducibly over ``inner.n_splits()`` splits.

    ``split_cancellable(k, cancel)`` is the lane-aware entry point: the
    injected sleep polls ``cancel`` and raises ``CancelledFetch`` when the
    pool cancels the losing attempt mid-stall.
    """

    def __init__(self, inner: SplitSource, *,
                 delays: dict[int, float] | None = None,
                 delay_calls: dict[int, int] | None = None,
                 faults: dict[int, int] | None = None,
                 seed: int | None = None, delay_p: float = 0.0,
                 fault_p: float = 0.0, delay_s: float = 0.05,
                 max_faults: int = 1):
        self.inner = inner
        self.delays = dict(delays or {})
        self.delay_calls = dict(delay_calls or {})
        self.faults = dict(faults or {})
        if seed is not None:
            rng = np.random.default_rng(seed)
            for k in range(inner.n_splits()):
                if delay_p and rng.random() < delay_p:
                    self.delays.setdefault(k, delay_s)
                if fault_p and rng.random() < fault_p:
                    self.faults.setdefault(
                        k, int(rng.integers(1, max_faults + 1)))
        self._lock = threading.Lock()
        self.calls: dict[int, int] = {}          # per-split fetch attempts
        self.injected_delay_s = 0.0              # total stall actually served
        self.injected_faults = 0

    def n_splits(self) -> int:
        return self.inner.n_splits()

    def split(self, k: int):
        return self.split_cancellable(k, None)

    def split_cancellable(self, k: int, cancel):
        with self._lock:
            call = self.calls.get(k, 0)
            self.calls[k] = call + 1
            fault = call < self.faults.get(k, 0)
            stall = (self.delays.get(k, 0.0)
                     if call < self.delay_calls.get(k, 1) else 0.0)
            if fault:
                self.injected_faults += 1
        if fault:
            raise TransientSplitError(
                f"injected transient fetch error for split {k} "
                f"(attempt {call})")
        if stall:
            t0 = time.perf_counter()
            cut = _interruptible_sleep(stall, cancel)
            with self._lock:
                self.injected_delay_s += time.perf_counter() - t0
            if cut:
                raise CancelledFetch(f"split {k} fetch cancelled mid-delay")
        return self.inner.split(k)

    def materialize(self):
        # parity oracle must not pay (or consume) the injected faults
        return self.inner.materialize()


class CancelledFetch(RuntimeError):
    """An injected stall was cancelled by the lane pool (speculation loser)."""


class LaneChaos:
    """Lane-level fault schedule for ``LanePool``.

    - ``kills``: iterable of ``(lane_id, nth_task)`` — that lane raises
      ``LaneDeath`` when it STARTS its nth task (0-based), before touching
      it, so the task is safely re-dispatched.
    - ``lane_delay[lane_id] = s``: every task that lane runs first sleeps
      ``s`` seconds (a uniformly slow worker). Interruptible by the task's
      cancel event.
    """

    def __init__(self, *, kills=(), lane_delay: dict[int, float] | None = None):
        self.kills = {(int(lane), int(n)) for lane, n in kills}
        self.lane_delay = dict(lane_delay or {})
        self._lock = threading.Lock()
        self.n_started: dict[int, int] = {}
        self.deaths: list[tuple[int, int]] = []  # (lane, key) actually killed

    def on_task_start(self, lane_id: int, key: int, attempt: int, cancel=None):
        with self._lock:
            nth = self.n_started.get(lane_id, 0)
            self.n_started[lane_id] = nth + 1
            kill = (lane_id, nth) in self.kills
            if kill:
                self.deaths.append((lane_id, key))
        if kill:
            raise LaneDeath(f"injected death of lane {lane_id} "
                            f"at task #{nth} (split {key})")
        stall = self.lane_delay.get(lane_id, 0.0)
        if stall:
            if _interruptible_sleep(stall, cancel):
                raise CancelledFetch(
                    f"lane {lane_id} task for split {key} cancelled mid-delay")
