"""Observability: structured tracing, energy metering, and service metrics.

The port of ``repro.obs``, three small, dependency-light layers threaded
through the MapReduce runtime (the executor, the per-split engines and the
spill tier):

- ``obs.trace``: a thread-safe ``Tracer`` with nestable spans (map /
  combine / shuffle / reduce / fetch / fetch-wait / spill-write /
  spill-read / lane-exec / retry / clone-race / clone-win / job) on a
  monotonic clock, exportable as Chrome trace-event JSON (load it in
  Perfetto / chrome://tracing) plus a text summary. Disabled by default
  via a no-op ``NullTracer``. A device stage's span reuses the fenced
  ``t0``/``t1`` its ``StageStats`` wall already takes: tracing adds no
  synchronization.
- ``obs.energy``: an ``EnergyMeter`` protocol — ``RaplMeter`` (powercap
  sysfs counter deltas, wraparound-safe), ``NvmlMeter`` (the card's
  total-energy counter through ``ctypes``), and a ``ModeledMeter`` driven
  by ``PowerProfile`` watts (Atom-class host vs blade-class device) —
  attributing joules to ``StageStats`` by active-wall share. Disabled by
  default via ``NullMeter``.
- ``obs.metrics``: a counters/gauges/histograms registry with JSON/text
  export.
"""
from repro_torch.obs.energy import (ATOM_HOST, BLADE_DEVICE, EnergyMeter,
                                    ModeledMeter, NullMeter, NvmlMeter,
                                    PowerProfile, RaplMeter, get_meter,
                                    pick_meter, set_meter, use_meter)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, get_metrics)
from repro_torch.obs.trace import (NullTracer, Tracer, get_tracer, set_tracer,
                                   use_tracer)

__all__ = [
    "ATOM_HOST", "BLADE_DEVICE", "Counter", "EnergyMeter", "Gauge",
    "Histogram", "MetricsRegistry", "ModeledMeter", "NullMeter",
    "NullTracer", "NvmlMeter", "PowerProfile", "RaplMeter", "Tracer",
    "get_meter", "get_metrics", "get_tracer", "pick_meter", "set_meter",
    "set_tracer", "use_meter", "use_tracer",
]
