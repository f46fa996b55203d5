"""Dispatch for the pair kernels (masked and unmasked): the CUDA kernel for
a CUDA tensor, the plain PyTorch version for a CPU tensor. A CUDA tensor
goes to the kernel or the call raises: no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.zones_pairs import kernel, ref


def pair_count_masked(a, b, n_a, n_b, cos_min):
    """a: [P,C1,3], b: [P,C2,3] f32, n_a/n_b: [P] int32 real counts ->
    int64 0-d tensor: #{valid (p,i,j): a[p,i] . b[p,j] >= cos_min}."""
    if a.is_cuda:
        return kernel.pair_count_masked_cuda(a, b, n_a, n_b, cos_min)
    return ref.pair_count_masked_ref(a, b, n_a, n_b, cos_min)


def pair_hist_masked(a, b, n_a, n_b, cos_edges):
    """Cumulative per-edge counts over valid pairs -> int64 [NB], in the
    order of ``cos_edges``."""
    if a.is_cuda:
        return kernel.pair_hist_masked_cuda(a, b, n_a, n_b, cos_edges)
    return ref.pair_hist_masked_ref(a, b, n_a, n_b, cos_edges)


def pair_count(a, b, cos_min, *, exclude_self: bool = False):
    """a: [M,3], b: [N,3] f32, or a batch [P,M,3], [P,N,3] -> int64 0-d
    tensor: #{(p,i,j): a[p,i] . b[p,j] >= cos_min}, summed over partitions
    (``exclude_self`` drops i == j)."""
    if a.is_cuda:
        return kernel.pair_count_cuda(a, b, cos_min,
                                      exclude_self=exclude_self)
    return ref.pair_count_ref(a, b, cos_min, exclude_self=exclude_self)


def pair_hist(a, b, cos_edges, *, exclude_self: bool = False):
    """Cumulative per-edge counts over every cell, summed over partitions
    -> int64 [NB], in the order of ``cos_edges``."""
    if a.is_cuda:
        return kernel.pair_hist_cuda(a, b, cos_edges,
                                     exclude_self=exclude_self)
    return ref.pair_hist_ref(a, b, cos_edges, exclude_self=exclude_self)
