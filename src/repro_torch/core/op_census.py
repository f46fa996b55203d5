"""Operation census of a stage callable: the cost model's FLOP and byte counts.

The reference compiles a stage with XLA and parses the optimized HLO text
(``repro.core.hlo_analysis``); PyTorch runs eagerly, so the port counts the
operators a stage dispatches instead. ``stage_census(fn, *args)`` runs
``fn`` once under a ``TorchDispatchMode`` and charges each ATen operator:

- ``flops``: 2*M*N*K for the matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``);
- ``ew_flops``: one per output element of every other operator;
- ``hbm_bytes``: the bytes of its tensor inputs and outputs.

Views (``is_view`` operators) move no data and do no arithmetic, so they
count nothing. These are the three fields ``StageCost.from_analysis``
reads. The reference's collective census and while-loop trip counts belong
to the multi-device and dry-run slices, which the port has not reached.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}


@dataclasses.dataclass
class OpCensus:
    """Counts over every operator one call of a stage dispatched."""

    flops: float = 0.0         # matrix-product FLOPs
    ew_flops: float = 0.0      # one per output element of the other ops
    hbm_bytes: float = 0.0     # tensor bytes in + out


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _matmul_flops(packet, args) -> float:
    """2*M*N*K for mm/addmm ([M,K] x [K,N]) and bmm/baddbmm (times B)."""
    a, b = (args[0], args[1]) if packet in (_aten.mm, _aten.bmm) \
        else (args[1], args[2])
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


class _Census(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.census = OpCensus()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        c = self.census
        outs = _tensors(out)
        c.hbm_bytes += sum(t.numel() * t.element_size()
                           for t in _tensors((args, kwargs)) + outs)
        if func.overloadpacket in _MATMULS:
            c.flops += _matmul_flops(func.overloadpacket, args)
        else:
            c.ew_flops += sum(t.numel() for t in outs)
        return out


def stage_census(fn, *args) -> OpCensus:
    """Run ``fn(*args)`` once and count what it dispatched."""
    with _Census() as mode:
        fn(*args)
    return mode.census
