"""Service metrics: a small counters/gauges/histograms registry.

The port of ``repro.obs.metrics``, plain Python as it is there. The
reference's MR query service feeds one of these live per service instance
(requests/batches counters, queue-depth and qps gauges, latency and
queue-wait histograms; so does the port's, ``serving/mr_service.py``), and
anything else in the runtime can hang numbers on the shared default
registry. Exports as JSON (``to_dict`` /
``to_json``) or a Prometheus-flavoured text page (``render_text``).

Histograms keep a bounded sample window (drop-oldest) so a long-lived
service can't grow without bound; percentiles are computed over the
window, which for a service means "recent" — the operationally useful
reading of p50/p99.
"""
from __future__ import annotations

import collections
import json
import threading
from typing import Deque, Dict, Optional


class Counter:
    """Monotonic count (requests served, batches run, retries)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time level (queue depth, qps, resident bytes)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Sampled distribution with percentiles over a bounded window."""

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self._lock = threading.Lock()
        self._window: Deque[float] = collections.deque(maxlen=max_samples)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._window.append(float(v))
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """q in [0, 100] over the retained window (0.0 when empty)."""
        with self._lock:
            data = sorted(self._window)
        if not data:
            return 0.0
        # nearest-rank on the sorted window; exact at the ends
        idx = min(int(round(q / 100.0 * (len(data) - 1))), len(data) - 1)
        return data[max(idx, 0)]

    def snapshot(self) -> dict:
        with self._lock:
            data = sorted(self._window)
            count, total = self._count, self._sum
        if not data:
            return {"count": count, "sum": total, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p99": 0.0}
        def rank(q):
            return data[min(int(round(q / 100.0 * (len(data) - 1))),
                            len(data) - 1)]
        return {"count": count, "sum": total,
                "mean": sum(data) / len(data),
                "min": data[0], "max": data[-1],
                "p50": rank(50), "p99": rank(99)}


class MetricsRegistry:
    """Named get-or-create home for counters, gauges, and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(
                name, Histogram(name, max_samples))

    def to_dict(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(histograms.items())},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def render_text(self) -> str:
        """Prometheus-flavoured exposition: one ``name value`` per line,
        histograms as ``_count`` / ``_sum`` / ``{quantile=...}``."""
        d = self.to_dict()
        lines = []
        for name, v in d["counters"].items():
            lines.append(f"{name}_total {v:g}")
        for name, v in d["gauges"].items():
            lines.append(f"{name} {v:g}")
        for name, snap in d["histograms"].items():
            lines.append(f"{name}_count {snap['count']:g}")
            lines.append(f"{name}_sum {snap['sum']:g}")
            for q in ("p50", "p99"):
                lines.append(
                    f'{name}{{quantile="{q}"}} {snap[q]:g}')
        return "\n".join(lines)


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def get_metrics() -> MetricsRegistry:
    """Process-wide default registry (created on first use)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT
