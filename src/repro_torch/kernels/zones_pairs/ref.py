"""Plain PyTorch versions of the Zones pair kernels (unmasked and masked,
both batched over partitions).

Scores use the JAX package's rounded-op formulation (``repro`` ``ref.py``):
three f32 products, each rounded, summed as ``(p0 + p1) + p2``. PyTorch runs
each elementwise op on its own, so nothing is contracted into an FMA and the
scores are bit-identical to the reference's. Thresholds arrive as f32 and
every comparison is made in f32.

Every batched version loops over partitions in chunks so the ``[p, C1, C2]``
score block stays near ``_CHUNK_CELLS`` cells: a real tier on the card is
hundreds of GB as one tensor.
"""
from __future__ import annotations

import torch

_CHUNK_CELLS = 1 << 26          # f32 score cells per chunk (256 MB)


def _batched_dots(a, b):
    """[P,M,d] x [P,N,d] -> [P,M,N] f32 scores, rounded after every op (the
    reference's ``_dots2d`` per partition)."""
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


def _partition_chunks(P, M, N):
    step = max(1, _CHUNK_CELLS // max(M * N, 1))
    return [(p, min(p + step, P)) for p in range(0, P, step)]


def _batch(a, b):
    """[M,d]/[N,d] -> [1,M,d]/[1,N,d]; [P,M,d]/[P,N,d] pass through."""
    return (a[None], b[None]) if a.dim() == 2 else (a, b)


def _cumulative(h, order):
    """Bins -> per-edge counts: #{scores >= asc[j]} is #{c > j}, put back in
    the caller's edge order."""
    cum_asc = torch.flip(torch.cumsum(torch.flip(h, (0,)), 0), (0,))[1:]
    out = torch.empty_like(cum_asc)
    out[order] = cum_asc
    return out


def _full_counts(a, b):
    """[P] int32 counts that mark every row real: the unmasked functions are
    the masked ones over whole capacities."""
    P = a.shape[0]
    return (torch.full((P,), a.shape[1], dtype=torch.int32, device=a.device),
            torch.full((P,), b.shape[1], dtype=torch.int32, device=a.device))


def _eye(M, N, device):
    return torch.eye(M, N, dtype=torch.bool, device=device)


def _count(a, b, n_a, n_b, cos_min, exclude_self):
    """The masked count; an unmasked one passes ``_full_counts``."""
    P, M, N = a.shape[0], a.shape[1], b.shape[1]
    cmin = _as_f32(cos_min, a.device)
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    for lo, hi in _partition_chunks(P, M, N):
        ok = _batched_dots(a[lo:hi], b[lo:hi]) >= cmin
        ok &= _pair_mask(M, N, n_a[lo:hi], n_b[lo:hi])
        if exclude_self:                        # the diagonal is dropped
            ok &= ~_eye(M, N, a.device)
        total += ok.sum()
    return total


def _hist(a, b, n_a, n_b, cos_edges, exclude_self):
    """The masked histogram; an unmasked one passes ``_full_counts``."""
    P, M, N = a.shape[0], a.shape[1], b.shape[1]
    edges = _as_f32(cos_edges, a.device).reshape(-1)
    asc, order = torch.sort(edges)
    h = torch.zeros(edges.shape[0] + 1, dtype=torch.int64, device=a.device)
    if edges.shape[0] == 0:
        return h[:0]
    for lo, hi in _partition_chunks(P, M, N):
        dots = _batched_dots(a[lo:hi], b[lo:hi])
        if exclude_self:                        # the diagonal scores -2
            dots.masked_fill_(_eye(M, N, a.device), -2.0)
        # scores below the loosest edge fall in bin 0, which no edge counts:
        # only valid cells at or above it are binned, c = #{asc <= score}
        keep = (dots >= asc[0]) & _pair_mask(M, N, n_a[lo:hi], n_b[lo:hi])
        h += torch.bincount(torch.searchsorted(asc, dots[keep], right=True),
                            minlength=h.shape[0])
    return _cumulative(h, order)


def pair_count_ref(a, b, cos_min, *, exclude_self: bool = False):
    """a: [M,3], b: [N,3] unit vectors, or a batch a: [P,M,3], b: [P,N,3].
    Count of (p,i,j) with a[p,i] . b[p,j] >= cos_min, summed over
    partitions (int64 0-d tensor): the JAX package's ``lax.map`` of the
    per-partition count plus its sum. ``exclude_self`` drops the cells
    i == j."""
    a, b = _batch(a, b)
    return _count(a, b, *_full_counts(a, b), cos_min, exclude_self)


def pair_hist_ref(a, b, cos_edges, *, exclude_self: bool = False):
    """Cumulative counts per edge, out[k] = #{(p,i,j): dot >= cos_edges[k]}
    (int64 [NB], in the order of ``cos_edges``, which need not be sorted),
    for one block or summed over a batch as in ``pair_count_ref``.
    ``exclude_self`` scores the cells i == j -2, as the reference does."""
    a, b = _batch(a, b)
    return _hist(a, b, *_full_counts(a, b), cos_edges, exclude_self)


def pair_count_masked_ref(a, b, n_a, n_b, cos_min):
    """a: [P,M,3], b: [P,N,3], n_a/n_b: [P] real counts. Total count of
    valid (p,i,j) with a[p,i] . b[p,j] >= cos_min (int64 0-d tensor)."""
    return _count(a, b, n_a, n_b, cos_min, False)


def pair_hist_masked_ref(a, b, n_a, n_b, cos_edges):
    """Cumulative counts per edge over all partitions: out[k] = #{valid
    (p,i,j): dot >= cos_edges[k]} (int64 [NB]), in the order of
    ``cos_edges``, which need not be sorted. One binning pass: each valid
    score is binned by ``c = #{edges <= score}`` (searchsorted on the
    ascending edges); padding cells are left out before binning."""
    return _hist(a, b, n_a, n_b, cos_edges, False)
