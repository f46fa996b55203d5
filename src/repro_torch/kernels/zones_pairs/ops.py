"""Dispatch for the masked pair kernels: the CUDA kernel for a CUDA tensor,
the plain PyTorch version for a CPU tensor.

``use_kernel=None`` decides from where ``a`` lies; ``True``/``False``
override it, as ``use_pallas=`` does in the JAX package's ``ops.py``.
``use_kernel=True`` on a CPU tensor raises (the kernel needs the card), and
a CUDA tensor goes to the kernel or the call raises: no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.zones_pairs import kernel, ref


def uses_kernel(a, use_kernel: bool | None = None) -> bool:
    return a.is_cuda if use_kernel is None else bool(use_kernel)


def pair_count_masked(a, b, n_a, n_b, cos_min, *,
                      use_kernel: bool | None = None):
    """a: [P,C1,3], b: [P,C2,3] f32, n_a/n_b: [P] int32 real counts ->
    int64 0-d tensor: #{valid (p,i,j): a[p,i] . b[p,j] >= cos_min}."""
    if uses_kernel(a, use_kernel):
        return kernel.pair_count_masked_cuda(a, b, n_a, n_b, cos_min)
    return ref.pair_count_masked_ref(a, b, n_a, n_b, cos_min)


def pair_hist_masked(a, b, n_a, n_b, cos_edges, *,
                     use_kernel: bool | None = None):
    """Cumulative per-edge counts over valid pairs -> int64 [NB], in the
    order of ``cos_edges``."""
    if uses_kernel(a, use_kernel):
        return kernel.pair_hist_masked_cuda(a, b, n_a, n_b, cos_edges)
    return ref.pair_hist_masked_ref(a, b, n_a, n_b, cos_edges)
