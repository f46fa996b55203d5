"""Bind the hand-written CUDA pair kernels (``csrc/zones_pairs.cu``).

The library is built by ``repro_torch.kernels._build`` at first use (nvcc,
``sm_90a``, a plain C interface loaded with ``ctypes``). Nothing here runs
at import: the CPU tests import this module on a machine without ``nvcc``.

Each wrapper checks device, dtype, contiguity and shapes, allocates its
output with ``torch.zeros``, launches on ``torch.cuda.current_stream()``,
raises if the C function reports a CUDA error, and adds one to its launch
count (``LAUNCHES``) where it launches. A call with no cell launches nothing
and counts nothing.

- ``pair_count_masked_cuda`` / ``pair_hist_masked_cuda``: one size tier of
  the device engine, padding masked by the real counts;
- ``pair_count_cuda`` / ``pair_hist_cuda``: the host engine's unmasked
  reduce, one ``[M,3] x [N,3]`` block or a batch ``[P,M,3] x [P,N,3]``
  summed over ``P``, with an optional ``exclude_self``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import NO_FMA, Library, raise_on

CSRC = Path(__file__).resolve().parent / "csrc"
# dynamic shared memory per edge: 12 bytes for both hists (an edge and a
# 64-bit bin; 49,160 bytes at 4096, past the 48 KB default, which the launch
# raises)
MAX_EDGES = 4096


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zp_count_masked.argtypes = [p, p, p, p, i, i, i, f, p, p]
    lib.zp_hist_masked.argtypes = [p, p, p, p, i, i, i, p, i, p, p]
    lib.zp_count.argtypes = [p, p, i, i, i, f, i, p, p]
    lib.zp_hist.argtypes = [p, p, i, i, i, p, i, i, p, p]
    for fn in (lib.zp_count_masked, lib.zp_hist_masked, lib.zp_count,
               lib.zp_hist):
        fn.restype = i


LIBRARY = Library("zones_pairs", (CSRC / "zones_pairs.cu",), _declare,
                  flags=NO_FMA)


def _check(named):
    for name, t, dt in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for _, t, _ in named}) != 1:
        raise ValueError(f"{', '.join(n for n, _, _ in named)} must be on "
                         "one device")


def _check_masked(a, b, n_a, n_b):
    _check((("a", a, torch.float32), ("b", b, torch.float32),
            ("n_a", n_a, torch.int32), ("n_b", n_b, torch.int32)))
    if a.dim() != 3 or b.dim() != 3 or a.shape[2] != 3 or b.shape[2] != 3:
        raise ValueError(f"expected a [P,C1,3] and b [P,C2,3], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    P = a.shape[0]
    if b.shape[0] != P or tuple(n_a.shape) != (P,) or tuple(n_b.shape) != (P,):
        raise ValueError(f"partition counts disagree: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, n_a {tuple(n_a.shape)}, "
                         f"n_b {tuple(n_b.shape)}")
    return P, a.shape[1], b.shape[1]


def _check_batch(a, b):
    """[M,3]/[N,3] or [P,M,3]/[P,N,3] -> (P, M, N)."""
    _check((("a", a, torch.float32), ("b", b, torch.float32)))
    if a.dim() != b.dim() or a.dim() not in (2, 3) or a.shape[-1] != 3 \
            or b.shape[-1] != 3 or (a.dim() == 3 and a.shape[0] != b.shape[0]):
        raise ValueError(f"expected a [M,3] and b [N,3], or a [P,M,3] and "
                         f"b [P,N,3], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    P = a.shape[0] if a.dim() == 3 else 1
    return P, a.shape[-2], b.shape[-2]


def _edges_desc(cos_edges, device):
    """-> (edges sorted descending, the sort's permutation, count)."""
    edges = torch.as_tensor(cos_edges, dtype=torch.float32,
                            device=device).reshape(-1)
    nb = edges.shape[0]
    if not 0 < nb <= MAX_EDGES:
        raise ValueError(f"need 1..{MAX_EDGES} edges, got {nb}")
    desc, order = torch.sort(edges, descending=True)
    return desc.contiguous(), order, nb


def _cumulative(hist, order, nb):
    """hist[c] counts the cells that pass exactly c edges. With the edges
    descending those are the c loosest, so edge k counts the cells with
    c >= nb - k. -> per-edge counts in the order the caller gave."""
    suffix = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    cum_desc = suffix[nb - torch.arange(nb, device=hist.device)]
    out = torch.empty_like(cum_desc)
    out[order] = cum_desc
    return out


def _f32(x) -> float:
    return float(np.float32(float(x)))


def _launch(entry: str, counter: str, device, *args) -> None:
    """Call the C function ``entry`` on the current stream, raise on a CUDA
    error, and add one to ``LAUNCHES[counter]``."""
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    raise_on(err, entry)
    LAUNCHES[counter] += 1


def _count(entry, counter, tensors, shape, cos_min, *flags):
    """One count launch: ``entry(*tensors, *shape, cmin, *flags, out)``."""
    dev = tensors[0].device
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    if math.prod(shape):                    # no cell, no launch
        _launch(entry, counter, dev, *(t.data_ptr() for t in tensors),
                *shape, _f32(cos_min), *flags, out.data_ptr())
    return out[0]


def _hist(entry, counter, tensors, shape, cos_edges, *flags):
    """One hist launch: ``entry(*tensors, *shape, edges, nb, *flags,
    hist)`` -> per-edge counts in the order of ``cos_edges``."""
    dev = tensors[0].device
    desc, order, nb = _edges_desc(cos_edges, dev)
    if not math.prod(shape):                # no cell, no launch
        return torch.zeros(nb, dtype=torch.int64, device=dev)
    hist = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    _launch(entry, counter, dev, *(t.data_ptr() for t in tensors), *shape,
            desc.data_ptr(), nb, *flags, hist.data_ptr())
    return _cumulative(hist, order, nb)


def pair_count_masked_cuda(a, b, n_a, n_b, cos_min) -> torch.Tensor:
    """Masked pair count over a tier -> int64 0-d tensor on the device."""
    shape = _check_masked(a, b, n_a, n_b)
    return _count("zp_count_masked", "pair_count_masked", (a, b, n_a, n_b),
                  shape, cos_min)


def pair_hist_masked_cuda(a, b, n_a, n_b, cos_edges) -> torch.Tensor:
    """Masked cumulative per-edge counts over a tier -> int64 [NB] on the
    device, in the order of ``cos_edges`` (any order)."""
    shape = _check_masked(a, b, n_a, n_b)
    return _hist("zp_hist_masked", "pair_hist_masked", (a, b, n_a, n_b),
                 shape, cos_edges)


def pair_count_cuda(a, b, cos_min, *, exclude_self: bool = False
                    ) -> torch.Tensor:
    """Unmasked pair count of ``[M,3] x [N,3]``, or of ``[P,M,3] x [P,N,3]``
    summed over partitions -> int64 0-d tensor on the device.
    ``exclude_self`` drops the cells ``i == j`` of each partition."""
    shape = _check_batch(a, b)
    return _count("zp_count", "pair_count", (a, b), shape, cos_min,
                  int(bool(exclude_self)))


def pair_hist_cuda(a, b, cos_edges, *, exclude_self: bool = False
                   ) -> torch.Tensor:
    """Unmasked cumulative per-edge counts, ``out[k] = #{cells: score >=
    cos_edges[k]}`` summed over partitions -> int64 [NB] on the device, in
    the order of ``cos_edges`` (any order). ``exclude_self`` scores the
    cells ``i == j`` -2, as the reference does."""
    shape = _check_batch(a, b)
    return _hist("zp_hist", "pair_hist", (a, b), shape, cos_edges,
                 int(bool(exclude_self)))
