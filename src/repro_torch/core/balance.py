"""Balance report: human-readable rendering of the roofline/Amdahl analysis.

The port of ``repro.core.balance``, word for word."""
from __future__ import annotations

from repro_torch.core.amdahl import RooflineTerms


def balance_report(name: str, t: RooflineTerms) -> str:
    d = t.to_dict()
    lines = [
        f"== {name} ==",
        f"  chips={t.chips}  HLO_FLOPs={t.flops:.3e}  HBM_bytes={t.hbm_bytes:.3e}",
        f"  coll_bytes intra={t.coll_bytes_intra:.3e} cross={t.coll_bytes_cross:.3e}",
        f"  t_compute={t.t_compute*1e3:.3f} ms  t_memory={t.t_memory*1e3:.3f} ms  "
        f"t_collective={t.t_collective*1e3:.3f} ms",
        f"  dominant={t.dominant}  step_time(ideal-overlap)={t.step_time*1e3:.3f} ms",
        f"  MODEL_FLOPS={t.model_flops:.3e}  useful_flop_ratio={t.useful_flop_ratio:.3f}",
        f"  roofline_fraction={t.roofline_fraction:.3f}",
        f"  Amdahl: AD={d['AD']:.3f}  ADN={d['ADN']:.3f}  "
        f"chips_to_balance={d['chips_to_balance']:.1f}",
    ]
    return "\n".join(lines)


def suggest(t: RooflineTerms) -> str:
    """One-sentence 'what would move the dominant term down'."""
    dom = t.dominant
    if dom == "compute":
        if t.useful_flop_ratio < 0.5:
            return ("compute-bound with low useful-FLOP ratio: cut recompute/masked "
                    "FLOPs (selective remat, blocked-causal attention)")
        return "compute-bound at high useful ratio: near roofline; scale chips"
    if dom == "memory":
        return ("memory-bound: increase arithmetic intensity (fuse, larger per-chip "
                "batch, avoid re-materialized activations, bf16 everywhere)")
    return ("collective-bound: shrink or re-route wire bytes (hierarchical sync, "
            "int8-compressed collectives, more FSDP/less pure DP)")
