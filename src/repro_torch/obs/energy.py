"""Energy metering: joules attributed to MapReduce stages.

The port of ``repro.obs.energy``.

The paper's headline is energy, not wall time: Amdahl-balanced blades do
7.7x (data-intensive) / 3.4x (compute-intensive) more work per joule
than a conventional cluster. An ``EnergyMeter`` turns one job run into
per-stage joules on its ``StageStats``:

- ``RaplMeter``: reads Intel RAPL counters from the powercap sysfs
  (``/sys/class/powercap/intel-rapl*/energy_uj``) at run boundaries,
  wraparound-safe via ``max_energy_range_uj``. Skipped (``available`` is
  False) when the hierarchy is missing or unreadable.
- ``NvmlMeter``: NVIDIA total-energy counter, read through ``ctypes``
  from NVIDIA's ``libnvidia-ml.so.1`` when it and a device are
  present.
- ``ModeledMeter``: watts x wall from a ``PowerProfile`` — the fallback
  that always works, reproducible on any machine. Its watts are modeled
  for the paper's node classes (``ATOM_HOST``, ``BLADE_DEVICE``), not
  measured on any chip; its readings are labelled ``modeled:<profile>``.

Measured meters (RAPL/NVML) observe one counter delta per run and
attribute it to stages by active-wall share; the modeled meter charges
each stage its profile's class watts directly. Either way the joules
land in the ``StageStats`` energy fields (``energy_j``, per-stage
``*_energy_j``, ``rows_per_joule``), which ``merge_from`` accumulates
like any other per-stage cost.

The ``PowerProfile`` watt split encodes the paper's observation (its
Table 2): on an unbalanced low-power node the CPU pays for I/O — moving
a byte costs as much CPU time as computing on it — while the
Amdahl-balanced blade moves bytes at a fraction of its compute draw.
So the host-engine profile charges I/O stages *above* its compute draw
and the blade-class device profile charges them well below.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import glob
import os
import threading
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

# StageStats wall/energy field pairs, split by resource class. "Compute"
# stages burn ALU; "io" stages move bytes (shuffle wire, split fetch,
# spill disk) — the axis the paper's balance argument turns on.
COMPUTE_STAGES = ("map", "reduce", "combine")
IO_STAGES = ("shuffle", "fetch", "spill")
ALL_STAGES = COMPUTE_STAGES + IO_STAGES

_NVML_SUCCESS = 0


@dataclasses.dataclass(frozen=True)
class PowerProfile:
    """Modeled node watts by stage class.

    ``compute_w`` draws while map/reduce/combine run; ``io_w`` while
    shuffle/fetch/spill run. Profiles describe the *node class an engine
    stands in for*, not this machine: the host (numpy) engine plays the
    paper's unbalanced low-power CPU node, the device engine its
    Amdahl-balanced blade.
    """

    name: str
    compute_w: float
    io_w: float

    def stage_watts(self, stage: str) -> float:
        return self.io_w if stage in IO_STAGES else self.compute_w


# Atom-class node (the paper's D510/N330 boards): ~8 W TDP CPU, ~28 W at
# the wall under load, and I/O *adds* draw (disk + NIC) on top of a CPU
# that is already saturated shovelling the bytes (paper Table 2: network
# I/O alone eats the core).
ATOM_HOST = PowerProfile("atom-host", compute_w=28.0, io_w=33.0)
# Amdahl-balanced blade (Atom + SSD + matched NIC): similar compute draw,
# but bytes move through hardware sized for the CPU, so I/O phases draw
# far below the compute phases.
BLADE_DEVICE = PowerProfile("amdahl-blade", compute_w=24.0, io_w=8.0)


def _charge(stats: Any, stage: str, joules: float) -> None:
    field = f"{stage}_energy_j"
    setattr(stats, field, getattr(stats, field) + joules)
    stats.energy_j += joules


def _stage_walls(stats: Any) -> Dict[str, float]:
    return {s: getattr(stats, f"{s}_wall_s") for s in ALL_STAGES}


class EnergyMeter:
    """Protocol: ``begin()`` returns a token at run start; ``attribute
    (token, stats)`` charges the run's joules onto its StageStats."""

    name = "null"

    @property
    def available(self) -> bool:
        return True

    def begin(self) -> Any:
        return None

    def attribute(self, token: Any, stats: Any) -> None:
        return None


class NullMeter(EnergyMeter):
    """Disabled metering: the default; both calls are no-ops."""


class ModeledMeter(EnergyMeter):
    """Watts x stage wall from a ``PowerProfile`` per engine.

    Deterministic and machine-independent: the meter every bench and CI
    run can use. Picks the profile by ``stats.engine`` ("host" ->
    ``host`` profile, anything else -> ``device``).
    """

    name = "modeled"

    def __init__(self, host: PowerProfile = ATOM_HOST,
                 device: PowerProfile = BLADE_DEVICE):
        self.host = host
        self.device = device

    def profile_for(self, stats: Any) -> PowerProfile:
        return self.host if stats.engine == "host" else self.device

    def attribute(self, token: Any, stats: Any) -> None:
        prof = self.profile_for(stats)
        for stage, wall in _stage_walls(stats).items():
            if wall > 0.0:
                _charge(stats, stage, wall * prof.stage_watts(stage))
        stats.energy_source = f"modeled:{prof.name}"


class _WallShareMeter(EnergyMeter):
    """Shared logic for measured meters: one joule delta per run,
    attributed to stages by their share of the summed active wall."""

    def read_joules(self, token: Any) -> float:
        raise NotImplementedError

    def attribute(self, token: Any, stats: Any) -> None:
        if not self.available or token is None:
            return
        joules = self.read_joules(token)
        walls = _stage_walls(stats)
        total = sum(walls.values())
        if joules <= 0.0 or total <= 0.0:
            return
        for stage, wall in walls.items():
            if wall > 0.0:
                _charge(stats, stage, joules * wall / total)
        stats.energy_source = self.name


class RaplMeter(_WallShareMeter):
    """Intel RAPL via the powercap sysfs; wraparound-safe deltas.

    Sums the top-level ``intel-rapl:<n>`` package domains. Counters are
    microjoule accumulators that wrap at ``max_energy_range_uj``; a
    negative delta is unwrapped by adding the range. ``available`` is
    False (and ``begin`` returns None) when the hierarchy is missing or
    the counters are unreadable (common unprivileged/container case).
    """

    name = "rapl"

    def __init__(self, root: str = "/sys/class/powercap"):
        self._domains: List[Tuple[str, float]] = []
        for d in sorted(glob.glob(os.path.join(root, "intel-rapl:[0-9]*"))):
            if ":" in os.path.basename(d).replace("intel-rapl:", "", 1):
                continue  # subdomain (core/uncore/dram): avoid double count
            counter = os.path.join(d, "energy_uj")
            try:
                self._read_uj(counter)
                max_uj = float(
                    open(os.path.join(d, "max_energy_range_uj")).read())
            except OSError:
                continue
            self._domains.append((counter, max_uj))

    @staticmethod
    def _read_uj(path: str) -> float:
        with open(path) as f:
            return float(f.read().strip())

    @property
    def available(self) -> bool:
        return bool(self._domains)

    def begin(self) -> Optional[List[float]]:
        if not self.available:
            return None
        try:
            return [self._read_uj(p) for p, _ in self._domains]
        except OSError:
            return None

    def read_joules(self, token: List[float]) -> float:
        total_uj = 0.0
        try:
            for (path, max_uj), start in zip(self._domains, token):
                delta = self._read_uj(path) - start
                if delta < 0.0:  # counter wrapped during the run
                    delta += max_uj
                total_uj += delta
        except OSError:
            return 0.0
        return total_uj * 1e-6


def _nvml_open(index: int):
    """Load ``libnvidia-ml.so.1``, declare the calls this module makes and
    initialise NVML. -> (lib, device handle), whose init the caller releases
    with ``lib.nvmlShutdown()``; None when the library is absent, init fails
    or there is no device ``index``."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    handle_p = ctypes.POINTER(ctypes.c_void_p)
    uint_p = ctypes.POINTER(ctypes.c_uint)
    for fn, args in (
            (lib.nvmlInit_v2, []), (lib.nvmlShutdown, []),
            (lib.nvmlDeviceGetHandleByIndex_v2, [ctypes.c_uint, handle_p]),
            (lib.nvmlDeviceGetTotalEnergyConsumption,
             [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
            (lib.nvmlDeviceGetMaxClockInfo,
             [ctypes.c_void_p, ctypes.c_int, uint_p]),
            (lib.nvmlDeviceGetPowerManagementLimit,
             [ctypes.c_void_p, uint_p])):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    if lib.nvmlInit_v2() != _NVML_SUCCESS:
        return None
    handle = ctypes.c_void_p()
    if lib.nvmlDeviceGetHandleByIndex_v2(
            int(index), ctypes.byref(handle)) != _NVML_SUCCESS:
        lib.nvmlShutdown()
        return None
    return lib, handle


_NVML_CLOCK_SM = 1              # nvmlClockType_t NVML_CLOCK_SM


def nvml_clock_and_power_limit(index: int = 0) -> Tuple[float, float]:
    """The card's maximum SM clock (``nvmlDeviceGetMaxClockInfo``, what
    ``nvidia-smi --query-gpu=clocks.max.sm`` shows) and its power-management
    limit (``nvmlDeviceGetPowerManagementLimit``, ``power.limit``) from NVML
    -> (Hz, W). NVML numbers devices in PCI order, as the CUDA runtime does
    unless ``CUDA_VISIBLE_DEVICES`` reorders them. Raises when NVML or
    either reading is unavailable."""
    opened = _nvml_open(index)
    if opened is None:
        raise RuntimeError(f"NVML has no device {index}: libnvidia-ml.so.1 "
                           "is missing or nvmlInit failed")
    lib, handle = opened
    try:
        mhz, mw = ctypes.c_uint(), ctypes.c_uint()
        if lib.nvmlDeviceGetMaxClockInfo(handle, _NVML_CLOCK_SM,
                                         ctypes.byref(mhz)) != _NVML_SUCCESS:
            raise RuntimeError("nvmlDeviceGetMaxClockInfo(SM) failed")
        if lib.nvmlDeviceGetPowerManagementLimit(
                handle, ctypes.byref(mw)) != _NVML_SUCCESS:
            raise RuntimeError("nvmlDeviceGetPowerManagementLimit failed")
    finally:
        lib.nvmlShutdown()
    return mhz.value * 1e6, mw.value * 1e-3


class NvmlMeter(_WallShareMeter):
    """NVIDIA device energy from NVML's total-energy counter (mJ since the
    kernel module loaded), read through ``ctypes`` from NVIDIA's own
    ``libnvidia-ml.so.1`` (the reference goes through ``pynvml``, which the
    port does not depend on): ``nvmlInit_v2``,
    ``nvmlDeviceGetHandleByIndex_v2``,
    ``nvmlDeviceGetTotalEnergyConsumption`` and, when the meter is
    collected, ``nvmlShutdown``.

    ``available`` is False when the library is absent, init fails, or the
    device does not expose the counter: the common non-GPU case.
    """

    name = "nvml"

    def __init__(self, index: int = 0):
        self._lib = None
        self._handle = None
        opened = _nvml_open(index)
        if opened is None:
            return
        lib, handle = opened
        self._lib, self._handle = lib, handle
        if self._read_mj() is None:         # no energy counter on this part
            self._lib = self._handle = None
            lib.nvmlShutdown()
            return
        # NVML counts inits: this meter's one is released when it is collected
        weakref.finalize(self, lib.nvmlShutdown)

    @property
    def available(self) -> bool:
        return self._handle is not None

    def _read_mj(self) -> Optional[float]:
        mj = ctypes.c_ulonglong()
        if self._lib.nvmlDeviceGetTotalEnergyConsumption(
                self._handle, ctypes.byref(mj)) != _NVML_SUCCESS:
            return None
        return float(mj.value)

    def begin(self) -> Optional[float]:
        if not self.available:
            return None
        return self._read_mj()

    def read_joules(self, token: float) -> float:
        now = self._read_mj()
        if now is None:
            return 0.0
        return max(now - token, 0.0) * 1e-3


def pick_meter(prefer: str = "auto") -> EnergyMeter:
    """Resolve a meter by name: "rapl" / "nvml" / "modeled" / "null", or
    "auto" = first *available* of RAPL, NVML, else the modeled fallback
    (measured-where-readable, modeled-watts-otherwise — the comparison
    methodology of the SBC/ARM64 Hadoop studies)."""
    if prefer == "null":
        return NullMeter()
    if prefer == "modeled":
        return ModeledMeter()
    if prefer == "rapl":
        return RaplMeter()
    if prefer == "nvml":
        return NvmlMeter()
    for meter in (RaplMeter(), NvmlMeter()):
        if meter.available:
            return meter
    return ModeledMeter()


_CURRENT: EnergyMeter = NullMeter()
_CURRENT_LOCK = threading.Lock()


def get_meter() -> EnergyMeter:
    """Current meter (``NullMeter`` unless one was installed)."""
    return _CURRENT


def set_meter(meter: EnergyMeter) -> EnergyMeter:
    """Install ``meter`` globally; returns the previous meter."""
    global _CURRENT
    with _CURRENT_LOCK:
        prev, _CURRENT = _CURRENT, meter
    return prev


@contextlib.contextmanager
def use_meter(meter: EnergyMeter) -> Iterator[EnergyMeter]:
    """Scoped ``set_meter``: restores the previous meter on exit."""
    prev = set_meter(meter)
    try:
        yield meter
    finally:
        set_meter(prev)
