"""Structured tracing: nestable spans on a monotonic clock.

The port of ``repro.obs.trace``, plain Python as it is there.

A ``Tracer`` records complete spans (Chrome trace-event ``ph: "X"``) and
instant marks (``ph: "i"``) from any thread. Spans carry the recording
thread id plus whatever correlation ids the caller attaches (lane /
split / request / attempt ...), either per-span or ambiently via the
``ids()`` context so nested spans inherit them — the lane worker opens
``ids(lane=..., split=...)`` once and every stage span recorded inside
the task picks the ids up.

Export targets:

- ``chrome_trace()`` / ``export_json()`` / ``save(path)``: the Chrome
  trace-event JSON object format (``{"traceEvents": [...]}``), loadable
  in Perfetto or chrome://tracing. Timestamps are microseconds relative
  to tracer construction.
- ``summary()``: a per-span-name text table (count / total / mean / max).

The module-level current tracer defaults to ``NullTracer`` whose
``span()`` / ``ids()`` return a shared reentrant no-op context manager,
so instrumented hot paths cost one attribute lookup and one method call
when tracing is off.

Spans close in a ``finally`` block, so an exception thrown mid-stage (a
chaos-killed lane, a cancelled clone) still closes every opened span —
``open_spans`` returning 0 after a crashy run is a tested invariant.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional


class _NullCtx:
    """Reentrant no-op context manager shared by every NullTracer call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """Disabled tracer: every call is a no-op returning shared objects."""

    enabled = False

    def span(self, name: str, cat: str = "stage", **ids) -> _NullCtx:
        return _NULL_CTX

    def ids(self, **ids) -> _NullCtx:
        return _NULL_CTX

    def record(self, name: str, t0_s: float, t1_s: float,
               cat: str = "stage", **ids) -> None:
        return None

    def instant(self, name: str, cat: str = "mark", **ids) -> None:
        return None

    @property
    def events(self) -> tuple:
        return ()

    @property
    def open_spans(self) -> int:
        return 0


class Tracer:
    """Thread-safe span recorder with ambient correlation ids."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self._opened = 0
        self._closed = 0

    # -- ambient correlation ids -------------------------------------
    def _id_stack(self) -> List[Dict[str, Any]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _ambient(self) -> Dict[str, Any]:
        merged: Dict[str, Any] = {}
        for frame in self._id_stack():
            merged.update(frame)
        return merged

    @contextlib.contextmanager
    def ids(self, **ids) -> Iterator[None]:
        """Attach correlation ids to every span opened in this thread."""
        stack = self._id_stack()
        stack.append(ids)
        try:
            yield
        finally:
            stack.pop()

    # -- recording ---------------------------------------------------
    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(ev)

    def _event(self, name: str, cat: str, ph: str, t0_s: float,
               dur_s: Optional[float], ids: Dict[str, Any]) -> Dict[str, Any]:
        args = self._ambient()
        args.update(ids)
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "ts": (t0_s - self._t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        if dur_s is not None:
            ev["dur"] = dur_s * 1e6
        if ph == "i":
            ev["s"] = "t"  # instant scope: thread
        return ev

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "stage", **ids) -> Iterator[None]:
        """Record a complete span around the with-body (closes in finally)."""
        t0 = self._clock()
        with self._lock:
            self._opened += 1
        try:
            yield
        finally:
            t1 = self._clock()
            ev = self._event(name, cat, "X", t0, t1 - t0, ids)
            with self._lock:
                self._closed += 1
                self.events.append(ev)

    def record(self, name: str, t0_s: float, t1_s: float,
               cat: str = "stage", **ids) -> None:
        """Record a span retroactively from caller-measured timestamps.

        ``t0_s``/``t1_s`` must come from the tracer's clock (default
        ``time.perf_counter``) — used for waits measured before the span
        is known to matter, e.g. the prefetch fetch-wait.
        """
        self._append(self._event(name, cat, "X", t0_s,
                                 max(t1_s - t0_s, 0.0), ids))

    def instant(self, name: str, cat: str = "mark", **ids) -> None:
        self._append(self._event(name, cat, "i", self._clock(), None, ids))

    def now(self) -> float:
        return self._clock()

    @property
    def open_spans(self) -> int:
        with self._lock:
            return self._opened - self._closed

    # -- export ------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_json(self) -> str:
        return json.dumps(self.chrome_trace())

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.export_json())
        return path

    def summary(self) -> str:
        """Per-name text table: count, total/mean/max duration in ms."""
        with self._lock:
            events = list(self.events)
        agg: Dict[str, List[float]] = {}
        marks: Dict[str, int] = {}
        for ev in events:
            if ev["ph"] == "X":
                agg.setdefault(ev["name"], []).append(ev["dur"])
            else:
                marks[ev["name"]] = marks.get(ev["name"], 0) + 1
        lines = [f"{'span':<16} {'count':>6} {'total_ms':>10} "
                 f"{'mean_ms':>9} {'max_ms':>9}"]
        for name in sorted(agg, key=lambda n: -sum(agg[n])):
            durs = agg[name]
            lines.append(
                f"{name:<16} {len(durs):>6} {sum(durs) / 1e3:>10.3f} "
                f"{sum(durs) / len(durs) / 1e3:>9.3f} "
                f"{max(durs) / 1e3:>9.3f}")
        for name in sorted(marks):
            lines.append(f"{name:<16} {marks[name]:>6} {'(instant)':>10}")
        return "\n".join(lines)


_CURRENT: Any = NullTracer()
_CURRENT_LOCK = threading.Lock()


def get_tracer() -> Any:
    """Current tracer (a ``Tracer`` or the default ``NullTracer``)."""
    return _CURRENT


def set_tracer(tracer: Any) -> Any:
    """Install ``tracer`` globally; returns the previous tracer."""
    global _CURRENT
    with _CURRENT_LOCK:
        prev, _CURRENT = _CURRENT, tracer
    return prev


@contextlib.contextmanager
def use_tracer(tracer: Any) -> Iterator[Any]:
    """Scoped ``set_tracer``: restores the previous tracer on exit."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
