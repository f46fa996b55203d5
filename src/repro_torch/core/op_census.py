"""Operation census of a stage callable: the cost model's FLOP and byte
counts, and the collectives it issues.

The reference compiles a stage with XLA and parses the optimized HLO text
(``repro.core.hlo_analysis``); PyTorch runs eagerly, so the port counts the
operators a stage dispatches instead. ``stage_census(fn, *args)`` runs
``fn`` once under a ``TorchDispatchMode`` (``census()`` is the same around
a block) and charges each ATen operator:

- ``flops``: 2*M*N*K for the matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``);
- ``ew_flops``: one per output element of every other operator but the
  collectives;
- ``hbm_bytes``: the bytes of its tensor inputs and outputs.

Views (``is_view`` operators) move no data and do no arithmetic, so they
count nothing. These are the three fields ``StageCost.from_analysis``
reads.

Collectives (the ``c10d`` operators ``torch.distributed`` dispatches) are
the census's other half (``parse_collectives``, ``collective_summary``).
Each is charged the reference's per-rank wire bytes, with R the size of
its process group and f = (R - 1) / R: all-reduce 2 in f, all-gather
out f, reduce-scatter and all-to-all in f, anything else in. An operator
is cross-pod when its group's ranks fall in more than one pod of
``pod_size`` ranks (``launch/mesh.py::pod_size``; 0 means one pod). The
while-loop trip counts of the reference's census belong to the dry run,
which the port has not reached.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}
# c10d operator name -> the reference's collective name
_COLLECTIVES = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("alltoall", "all-to-all"))
_OUT_ARGS = ("output", "output_tensor", "output_tensors", "outputs")


@dataclasses.dataclass
class Collective:
    """One collective a stage issued."""

    op: str                     # "all-reduce", ..., or the c10d name
    wire_bytes: float           # per rank, by the formulas above
    payload_bytes: float        # the larger of its inputs and outputs
    group_size: int
    cross_pod: bool
    mult: float                 # times issued (1: eager, no loops to unroll)
    line: str                   # the c10d operator and its tensors' device


@dataclasses.dataclass
class OpCensus:
    """Counts over every operator one call of a stage dispatched."""

    flops: float = 0.0         # matrix-product FLOPs
    ew_flops: float = 0.0      # one per output element of the other ops
    hbm_bytes: float = 0.0     # tensor bytes in + out
    collectives: list = dataclasses.field(default_factory=list)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def _matmul_flops(packet, args) -> float:
    """2*M*N*K for mm/addmm ([M,K] x [K,N]) and bmm/baddbmm (times B)."""
    a, b = (args[0], args[1]) if packet in (_aten.mm, _aten.bmm) \
        else (args[1], args[2])
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _collective(func, args, kwargs, pod_size: int) -> Collective:
    """Charge one c10d operator: its inputs and outputs by argument name,
    its group's size and ranks from its ``process_group`` argument."""
    import torch.distributed as dist
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs or {})
    ranks = dist.get_process_group_ranks(
        dist.ProcessGroup.unbox(named["process_group"]))
    out_b = _nbytes([v for k, v in named.items() if k in _OUT_ARGS])
    in_b = _nbytes([v for k, v in named.items() if k not in _OUT_ARGS])
    name = func._schema.name.split("::")[-1]
    op = next((ref for key, ref in _COLLECTIVES if key in name), name)
    R = max(len(ranks), 1)
    f = (R - 1) / R
    wire = {"all-reduce": 2.0 * in_b * f, "all-gather": out_b * f,
            "reduce-scatter": in_b * f, "all-to-all": in_b * f}.get(op, in_b)
    cross = (len({r // pod_size for r in ranks}) > 1) if pod_size else False
    devices = sorted({t.device.type for t in _tensors(args)})
    return Collective(op, wire, max(in_b, out_b), R, cross, 1.0,
                      f"{name} {','.join(devices)}")


class _Census(TorchDispatchMode):
    def __init__(self, pod_size: int = 0):
        super().__init__()
        self.census = OpCensus()
        self.pod_size = pod_size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        c = self.census
        outs = _tensors(out)
        c.hbm_bytes += sum(t.numel() * t.element_size()
                           for t in _tensors((args, kwargs)) + outs)
        if func.namespace == "c10d":
            c.collectives.append(_collective(func, args, kwargs,
                                             self.pod_size))
        elif func.overloadpacket in _MATMULS:
            c.flops += _matmul_flops(func.overloadpacket, args)
        else:
            c.ew_flops += sum(t.numel() for t in outs)
        return out


@contextlib.contextmanager
def census(*, pod_size: int = 0):
    """Count what the block dispatches on this thread. -> its ``OpCensus``
    (filled when the block ends)."""
    with _Census(pod_size) as mode:
        yield mode.census


def stage_census(fn, *args, pod_size: int = 0) -> OpCensus:
    """Run ``fn(*args)`` once and count what it dispatched."""
    with census(pod_size=pod_size) as c:
        fn(*args)
    return c


def parse_collectives(c: OpCensus) -> list:
    """The collectives of a census, in the order they were issued."""
    return list(c.collectives)


def collective_summary(c: OpCensus) -> dict:
    """The reference's ``collective_summary`` keys: the count, the wire
    bytes in all, inside a pod and across pods, and by operator."""
    by_op: dict[str, float] = defaultdict(float)
    intra = cross = 0.0
    for col in c.collectives:
        by_op[col.op] += col.wire_bytes
        if col.cross_pod:
            cross += col.wire_bytes
        else:
            intra += col.wire_bytes
    return {"count": len(c.collectives), "bytes_total": intra + cross,
            "bytes_intra_pod": intra, "bytes_cross_pod": cross,
            "by_op": dict(by_op)}
