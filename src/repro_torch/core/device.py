"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None, mesh=None) -> torch.device:
    """``None`` means the card. Raise when the card is asked for and absent:
    no entry point falls back to the CPU on its own.

    Under a ``mesh`` (``launch/mesh.py``), ``None`` means this rank's card,
    ``cuda:(rank % device_count)``, and a device whose type differs from
    the mesh's raises: a rank's tensors live where its collectives run."""
    if mesh is not None and device is None:
        import torch.distributed as dist
        _require_cuda()
        device = torch.device("cuda",
                              dist.get_rank() % torch.cuda.device_count())
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        _require_cuda()
    if mesh is not None and dev.type != mesh.device_type:
        raise ValueError(f"device {dev} does not match the mesh's device "
                         f"type {mesh.device_type!r}")
    return dev


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless asked otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")


def meta_empty(shape, *, dtype=None) -> torch.Tensor:
    """A tensor of ``shape`` on ``meta`` that stands for a shape only (a
    module skeleton, a plan's template): it holds no bytes on any device,
    so it is made beneath any dispatch mode, where an operation census
    (``core/op_census.py``) neither counts it nor its bytes, on the card
    and in the dry run alike."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return torch.empty(shape, dtype=dtype, device="meta")
