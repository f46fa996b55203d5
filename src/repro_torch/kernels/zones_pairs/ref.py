"""Plain PyTorch versions of the Zones pair kernels (plain and masked-batched).

Scores use the JAX package's rounded-op formulation (``repro`` ``ref.py``):
three f32 products, each rounded, summed as ``(p0 + p1) + p2``. PyTorch runs
each elementwise op on its own, so nothing is contracted into an FMA and the
scores are bit-identical to the reference's. Thresholds arrive as f32 and
every comparison is made in f32.

The masked variants loop over partitions in chunks so the ``[p, C1, C2]``
score block stays near ``_CHUNK_CELLS`` cells: a real tier on the card is
hundreds of GB as one tensor.
"""
from __future__ import annotations

import torch

_CHUNK_CELLS = 1 << 26          # f32 score cells per chunk (256 MB)


def _dots2d(a, b):
    """[M,d] x [N,d] -> [M,N] f32 scores, rounded after every op."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    return sum(a[:, None, k] * b[None, :, k] for k in range(a.shape[-1]))


def _batched_dots(a, b):
    """[P,M,d] x [P,N,d] -> [P,M,N] f32 scores; same formulation as
    ``_dots2d``."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    return sum(a[:, :, None, k] * b[:, None, :, k]
               for k in range(a.shape[-1]))


def _pair_mask(M, N, n_a, n_b):
    """[P, M, N] validity: row i of partition p is real iff i < n_a[p]."""
    mi = torch.arange(M, device=n_a.device)[None, :] < n_a[:, None]
    mj = torch.arange(N, device=n_b.device)[None, :] < n_b[:, None]
    return mi[:, :, None] & mj[:, None, :]


def _as_f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def pair_count_ref(a, b, cos_min, *, exclude_self: bool = False):
    """a: [M,3], b: [N,3] unit vectors. Count of (i,j) with a_i . b_j >=
    cos_min (int64 0-d tensor). ``exclude_self`` drops the diagonal."""
    ok = _dots2d(a, b) >= _as_f32(cos_min, a.device)
    if exclude_self:
        ok &= ~torch.eye(*ok.shape, dtype=torch.bool, device=a.device)
    return ok.sum()


def pair_hist_ref(a, b, cos_edges, *, exclude_self: bool = False):
    """Cumulative counts per edge: out[k] = #{(i,j): dot >= cos_edges[k]}."""
    dots = _dots2d(a, b)
    if exclude_self:
        dots = torch.where(torch.eye(*dots.shape, dtype=torch.bool,
                                     device=a.device), -2.0, dots)
    edges = _as_f32(cos_edges, a.device)
    return (dots[None] >= edges[:, None, None]).sum(dim=(1, 2))


def _partition_chunks(P, M, N):
    step = max(1, _CHUNK_CELLS // max(M * N, 1))
    return [(p, min(p + step, P)) for p in range(0, P, step)]


def pair_count_masked_ref(a, b, n_a, n_b, cos_min):
    """a: [P,M,3], b: [P,N,3], n_a/n_b: [P] real counts. Total count of
    valid (p,i,j) with a[p,i] . b[p,j] >= cos_min (int64 0-d tensor)."""
    P, M, N = a.shape[0], a.shape[1], b.shape[1]
    cmin = _as_f32(cos_min, a.device)
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    for lo, hi in _partition_chunks(P, M, N):
        ok = _batched_dots(a[lo:hi], b[lo:hi]) >= cmin
        ok &= _pair_mask(M, N, n_a[lo:hi], n_b[lo:hi])
        total += ok.sum()
    return total


def pair_hist_masked_ref(a, b, n_a, n_b, cos_edges):
    """Cumulative counts per edge over all partitions: out[k] = #{valid
    (p,i,j): dot >= cos_edges[k]} (int64 [NB]), in the order of
    ``cos_edges``, which need not be sorted.

    One binning pass: each valid score at or above the loosest edge is
    binned by ``c = #{edges <= score}`` (searchsorted on the ascending
    edges); then #{scores >= asc[j]} is #{c > j}. Scores below the loosest
    edge fall in bin 0, which no edge counts, so they are left out before
    binning."""
    P, M, N = a.shape[0], a.shape[1], b.shape[1]
    edges = _as_f32(cos_edges, a.device)
    asc, order = torch.sort(edges)
    nb = edges.shape[0]
    h = torch.zeros(nb + 1, dtype=torch.int64, device=a.device)
    if nb == 0:
        return h[:0]
    for lo, hi in _partition_chunks(P, M, N):
        dots = _batched_dots(a[lo:hi], b[lo:hi])
        keep = _pair_mask(M, N, n_a[lo:hi], n_b[lo:hi]) & (dots >= asc[0])
        c = torch.searchsorted(asc, dots[keep], right=True)
        h += torch.bincount(c, minlength=nb + 1)
    cum_asc = torch.flip(torch.cumsum(torch.flip(h, (0,)), 0), (0,))[1:]
    out = torch.empty_like(cum_asc)
    out[order] = cum_asc
    return out
