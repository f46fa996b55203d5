"""Block-wise int8 quantization with error feedback, and the compressed
all-reduce: the paper's LZO analogue.

The port of ``repro.core.compression``. A payload's last axis is
zero-padded to whole 256-element blocks and each block gets one f32
max-abs scale (``quantize_block``). The work goes through
``kernels/quantize``: the hand-written CUDA kernels for a CUDA tensor, the
plain PyTorch versions for a CPU tensor, bit-identical to the reference's
eager quantizer either way. The same quantizer is the int8 shuffle codec's
wire format and the wire format of ``compressed_psum_1d``.

Error feedback (``ef_compress``) keeps the residual in the system:
``sent + new_err == g + err``.

The collectives run over a mesh axis (``launch/mesh.py``): ``axis_group``
resolves a dim name to its process group. The reference's functions are
``shard_map`` bodies over named axes; the port's take the axis name and
the mesh. Each is one ``torch.distributed`` call on the caller's tensors,
whatever the backend: NCCL, or gloo (ranks that share one card, or the
CPU), which runs all four on CUDA tensors too (torch 2.11 on the H100).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.kernels.quantize.ops import dequantize, quantize

BLOCK = 256


def int8_wire_bytes(n: int, block: int = BLOCK) -> int:
    """Wire bytes for a block-quantized payload of ``n`` scalars: one int8
    code per element plus one fp32 scale per block (zero-padded to a full
    final block)."""
    n_pad = ((max(n, 1) + block - 1) // block) * block
    return n_pad + 4 * (n_pad // block)


def quantize_block(x: torch.Tensor, block: int = BLOCK):
    """x: [..., n] (f32 or bf16; other floats are cast to f32) -> (q int8
    [..., n_pad], scales f32 [..., n_pad/block], n). Per-block symmetric
    max-abs scaling, on ``x``'s device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    n_pad = -(-n // block) * block
    rows = x.reshape(math.prod(lead), n)
    if n_pad != n:
        rows = torch.nn.functional.pad(rows, (0, n_pad - n))
    q, s = quantize(rows.contiguous(), block=block)
    return q.reshape(*lead, n_pad), s.reshape(*lead, n_pad // block), n


def dequantize_block(q, scale, n: int, dtype=torch.float32,
                     block: int = BLOCK):
    """The inverse of ``quantize_block``: [..., n_pad] codes and their
    scales -> [..., n] of ``dtype``."""
    lead, n_pad = tuple(q.shape[:-1]), q.shape[-1]
    R = math.prod(lead)
    x = dequantize(q.reshape(R, n_pad).contiguous(),
                   scale.reshape(R, n_pad // block).contiguous(),
                   block=block)
    return x.reshape(*lead, n_pad)[..., :n].to(dtype)


def compress_roundtrip(x: torch.Tensor, block: int = BLOCK):
    """dequant(quant(x)): what the wire sees after one hop."""
    q, s, n = quantize_block(x.reshape(-1), block)
    return dequantize_block(q, s, n, x.dtype, block).reshape(x.shape)


def ef_compress(g, err, block: int = BLOCK):
    """Error-feedback compression step -> (g_compressed, new_err) with
    ``g_compressed + new_err == g + err`` (up to f32 rounding), so the
    residual never leaves the system."""
    if err is None:
        err = torch.zeros_like(g, dtype=torch.float32)
    corrected = g.to(torch.float32) + err
    sent = compress_roundtrip(corrected, block)
    return sent.to(g.dtype), corrected - sent


# ---------------------------------------------------------------------------
# Collectives over a mesh axis
# ---------------------------------------------------------------------------

def axis_group(axis_name, *, mesh):
    """The process group of mesh axis ``axis_name``: a dim name, or a tuple
    of them, whose ranks the mesh flattens into one group (the reference's
    collective over several named axes at once)."""
    names = ((axis_name,) if isinstance(axis_name, str)
             else tuple(axis_name))
    if len(names) == 1:
        return mesh.get_group(names[0])
    if (set(names) == set(mesh.mesh_dim_names)
            and mesh.mesh.numel() == dist.get_world_size()):
        return dist.group.WORLD
    return mesh[names]._flatten().get_group()


def axis_size(axis_name, *, mesh) -> int:
    """Ranks along mesh axis ``axis_name`` (a tuple multiplies)."""
    names = ((axis_name,) if isinstance(axis_name, str)
             else tuple(axis_name))
    return math.prod(int(mesh.mesh.shape[mesh.mesh_dim_names.index(a)])
                     for a in names)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, in a new tensor."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """[R, ...] -> [R, ...]: row r goes to rank r of ``group``, and row j of
    the result came from rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] -> [R * n, ...]: every rank's ``x`` in rank order."""
    R = dist.get_world_size(group)
    out = x.new_empty((R * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """[R * m, ...] -> [m, ...]: block r of the sum over ``group`` lands on
    rank r."""
    R = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // R,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def compressed_psum_1d(x, axis_name, *, mesh, block: int = BLOCK):
    """All-reduce of a 1-D vector over ``axis_name`` with int8 payloads.

    Quantized reduce-scatter (an all-to-all of int8 codes and their scales,
    then a local f32 sum) followed by a quantized all-gather: about n int8
    bytes in each phase, 2n in all, against 8n for a ring all-reduce of
    f32, plus one f32 scale a block."""
    group = axis_group(axis_name, mesh=mesh)
    R = dist.get_world_size(group)
    if R == 1:
        return x
    n = x.shape[0]
    pad = (-n) % (R * block)
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, pad)).reshape(R, -1)
    q, s, m = quantize_block(xf, block)                  # [R, m], [R, m/256]
    q, s = all_to_all(q, group), all_to_all(s, group)
    chunk = dequantize_block(q, s, m, block=block).sum(dim=0)   # [m] f32
    q2, s2, m2 = quantize_block(chunk, block)
    q2 = all_gather(q2, group).reshape(R, -1)
    s2 = all_gather(s2, group).reshape(R, -1)
    out = dequantize_block(q2, s2, m2, block=block)      # [R, m]
    return out.reshape(-1)[:n].to(x.dtype)


def psum_1d(x, axis_name, *, mesh):
    """Sum of ``x`` over mesh axis ``axis_name``, in a new tensor."""
    return all_reduce(x, axis_group(axis_name, mesh=mesh))
