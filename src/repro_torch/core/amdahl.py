"""Amdahl-number / roofline analysis (the paper's Table 4), priced on a card.

The port of ``repro.core.amdahl``. The paper measures, per Hadoop task,
instruction rate against disk and network I/O and derives "Amdahl numbers"
(bits of I/O per instruction), concluding the CPU is the bottleneck and a
balanced node needs four Atom cores. ``RooflineTerms`` derives the same
three-resource balance for a run:

    compute term    = flops       / (chips * spec.peak_flops)
    memory term     = hbm_bytes   / (chips * spec.hbm_bw)
    collective term = coll_bytes  / (chips * spec.n_links * spec.link_bw)

and reports the dominant term, the useful-FLOP ratio, and the "chips to
balance" figure (the paper's four-core estimate: how much compute per chip
the observed I/O pattern could feed).

The reference holds TPU v5e constants at module level; here the rates are a
``DeviceSpec``, a field of ``RooflineTerms``. ``device_spec()`` reads the
card's: its SM count from ``torch.cuda.get_device_properties``, its maximum
SM clock and power limit from NVML (``obs/energy.py``), and its HBM and
NVLink rates from the data sheet, keyed by the device's name. The compute
peak is the FP32 non-fused issue rate, SMs x 128 lanes x clock: the pair
kernels use neither tensor cores nor FMA (their results must match the
reference bit for bit), so that is the rate a MapReduce reduce can reach.
The bf16 dense tensor-core rate sits beside it (``dense_flops``) for the
LM's ``model_flops_*`` counts. There is no CPU spec: a caller pricing a CPU
run passes its own.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.device import resolve_device

FP32_LANES_PER_SM = 128        # Hopper: 4 sub-partitions x 32 FP32 lanes

# Per-card rates no query returns (NVIDIA's H100 SXM and DGX H100 data
# sheets): HBM bandwidth, NVLink 4 (18 links, 900 GB/s in all, both
# directions), the bf16 dense tensor-core rate, and one 400 Gb/s
# ConnectX-7 port a GPU for traffic that leaves the node.
DATA_SHEET = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bw=3.35e12, link_bw=900e9 / 18,
                                  n_links=18, cross_bw=50e9,
                                  dense_flops=989e12),
}


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """The rates one chip of a roofline is priced at."""

    name: str
    peak_flops: float          # compute peak of the roofline's FLOPs
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per link
    n_links: int               # links per chip within the node
    cross_bw: float            # bytes/s per chip for traffic leaving the node
    chip_w: float = 0.0        # power limit per chip, W (0 = unknown)
    dense_flops: float = 0.0   # bf16 dense tensor-core FLOP/s (LM models)
    sm_count: int = 0
    sm_clock_hz: float = 0.0
    source: str = ""           # where each number came from


@functools.lru_cache(maxsize=None)
def cuda_spec(index: int = 0) -> DeviceSpec:
    """The spec of CUDA device ``index``, read from the card once per
    process (``lru_cache``: every later call returns the same frozen
    spec)."""
    from repro_torch.obs.energy import nvml_clock_and_power_limit
    props = torch.cuda.get_device_properties(index)
    sheet = DATA_SHEET.get(props.name)
    if sheet is None:
        raise ValueError(f"no data-sheet rates for {props.name!r} (have "
                         f"{sorted(DATA_SHEET)}); pass a DeviceSpec")
    clock_hz, chip_w = nvml_clock_and_power_limit(index)
    sms = int(props.multi_processor_count)
    return DeviceSpec(
        name=props.name, peak_flops=sms * FP32_LANES_PER_SM * clock_hz,
        chip_w=chip_w, sm_count=sms, sm_clock_hz=clock_hz,
        source="SMs: torch.cuda.get_device_properties; clock and power "
               "limit: NVML; HBM, NVLink, network, bf16: data sheet",
        **sheet)


# What a card would report, as its data sheet states it (H100 SXM: 132
# SMs, 1,980 MHz maximum SM clock, 700 W), for pricing without a card.
SHEET_CHIP = {
    "NVIDIA H100 80GB HBM3": dict(sm_count=132, sm_clock_hz=1.98e9,
                                  chip_w=700.0),
}


def sheet_spec(name: str) -> DeviceSpec:
    """The spec of card ``name`` from its data sheet alone (``DATA_SHEET``,
    ``SHEET_CHIP``): for a dry run priced on a card it does not run on."""
    if name not in DATA_SHEET or name not in SHEET_CHIP:
        raise ValueError(f"no data sheet for {name!r}; have "
                         f"{sorted(DATA_SHEET)}")
    chip = SHEET_CHIP[name]
    return DeviceSpec(
        name=name,
        peak_flops=chip["sm_count"] * FP32_LANES_PER_SM * chip["sm_clock_hz"],
        source="data sheet (SMs, clock, power limit, rates), no card read",
        **chip, **DATA_SHEET[name])


def device_spec(device=None) -> DeviceSpec:
    """The spec of ``device`` (None: the card). Only a CUDA device has one:
    a CPU run's roofline needs a spec from its caller."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no DeviceSpec for {dev}: pass spec=")
    return cuda_spec(torch.cuda.current_device() if dev.index is None
                     else dev.index)


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    coll_bytes_intra: float
    coll_bytes_cross: float
    chips: int
    model_flops: float = 0.0
    chip_w: float = 0.0          # watts per chip (0 = no power accounting)
    spec: DeviceSpec = None      # None: the card's (``device_spec()``)

    def __post_init__(self):
        if self.spec is None:
            self.spec = device_spec()

    @classmethod
    def from_stage_bytes(cls, *, flops: float, hbm_bytes: float,
                         wire_bytes: float, chips: int = 1,
                         model_flops: float = 0.0, chip_w: float = 0.0,
                         spec: DeviceSpec = None) -> "RooflineTerms":
        """Build terms from per-stage MapReduce accounting (StageStats):
        reduce FLOPs -> compute, map+reduce bytes -> memory, shuffle wire
        bytes -> the intra-node collective term (the paper's network I/O).
        ``chip_w`` carries per-chip watts into the balance estimate."""
        return cls(flops=flops, hbm_bytes=hbm_bytes,
                   coll_bytes_intra=wire_bytes, coll_bytes_cross=0.0,
                   chips=chips, model_flops=model_flops or flops,
                   chip_w=chip_w, spec=spec)

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.spec.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.spec.hbm_bw)

    @property
    def t_collective(self) -> float:
        s = self.spec
        t_intra = self.coll_bytes_intra / (self.chips * s.link_bw * s.n_links)
        t_cross = self.coll_bytes_cross / (self.chips * s.cross_bw)
        return t_intra + t_cross

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """No-overlap bound: max of the three terms (perfect overlap ideal)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the ideal-overlap bound:
        MODEL_FLOPS / (chips * peak * step_time)."""
        if not self.model_flops or not self.step_time:
            return 0.0
        return self.model_flops / (self.chips * self.spec.peak_flops
                                   * self.step_time)

    @property
    def mfu_bound(self) -> float:
        return self.roofline_fraction

    def amdahl_numbers(self) -> dict:
        """The paper's AD / ADN analogues: bytes of I/O per FLOP against the
        machine's balance. A workload whose bytes per flop exceed the
        machine's is I/O (memory) bound, the paper's 'Amdahl number > 1'
        test."""
        s = self.spec
        bpf_mem = self.hbm_bytes / self.flops if self.flops else 0.0
        bpf_net = ((self.coll_bytes_intra + self.coll_bytes_cross) / self.flops
                   if self.flops else 0.0)
        machine_mem = s.hbm_bw / s.peak_flops
        machine_net = s.link_bw * s.n_links / s.peak_flops
        return {
            "AD": bpf_mem / machine_mem if machine_mem else 0.0,     # >1 => mem-bound
            "ADN": ((bpf_mem / machine_mem) + (bpf_net / machine_net)
                    if machine_mem else 0.0),
            "bytes_per_flop_mem": bpf_mem,
            "bytes_per_flop_net": bpf_net,
        }

    def chips_to_balance(self) -> float:
        """Chips needed so compute time matches the I/O time at this workload
        shape (the paper's 'four Atom cores' estimate, inverted for chips)."""
        t_io = max(self.t_memory, self.t_collective)
        if t_io <= 0:
            return float(self.chips)
        return self.chips * self.t_compute / t_io

    @property
    def power_w(self) -> float:
        """Provisioned draw of the configured chips (chips x watts/chip)."""
        return self.chips * self.chip_w

    def balance_watts(self) -> float:
        """The balance point priced in watts: the compute draw this
        workload's I/O pattern can keep fed. 0.0 when no ``chip_w`` was
        supplied."""
        return self.chips_to_balance() * self.chip_w

    def to_dict(self) -> dict:
        d = {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes_intra": self.coll_bytes_intra,
            "coll_bytes_cross": self.coll_bytes_cross,
            "chips": self.chips, "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "step_time_s": self.step_time,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
        d.update(self.amdahl_numbers())
        d["chips_to_balance"] = self.chips_to_balance()
        d["chip_w"] = self.chip_w
        d["balance_watts"] = self.balance_watts()
        return d


def model_flops_train(n_params_active: int, tokens: int) -> float:
    """6 N D for a training step (fwd+bwd)."""
    return 6.0 * n_params_active * tokens


def model_flops_prefill(n_params_active: int, tokens: int) -> float:
    return 2.0 * n_params_active * tokens


def model_flops_decode(n_params_active: int, tokens: int) -> float:
    return 2.0 * n_params_active * tokens
