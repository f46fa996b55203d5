"""Gradient bucketing — the paper's BufferedOutputStream analogue (the port
of ``repro.core.buckets``).

Hadoop paid a high fixed cost (JNI entry) per tiny HDFS write; buffering
output into large batches bought a 2x speedup. The analogue here is the
per-kernel launch and per-collective call: a model with hundreds of
parameter tensors otherwise makes hundreds of small optimizer updates and
all-reduces. Bucketing flattens the gradients into a few large 1-D f32
buffers (capped at ``bucket_bytes`` of the leaves' own dtype), so the
optimizer update and any explicit sync run over a few large tensors.

A plan is made over *leaves*, each one tensor or a run of tensors laid end
to end: the reference stacks a scan group's layers into one leaf, and a new
bucket starts only between leaves, so a plan over the port's per-layer
tensors grouped as the reference's leaves (``models/model.py::
reference_leaves``) puts every element in the reference's bucket at the
reference's offset. ``flatten`` and ``unflatten`` take and give the flat
list of tensors, in the plan's order.

Under FSDP (``parallel/fsdp.py``) each tensor is split into row shards, and
a rank's bucket is its shards of the bucket's tensors laid end to end
(``shard_plan``): the plan's flatten and unflatten then run on the rank's
shards unchanged, and the optimizer's elementwise update on them is the
rank's part of the whole update. ``unshard_bucket`` puts the ranks'
buckets back in the reference's element order (the real elements, without
padding), and ``shard_bucket`` takes a rank's part out of such a bucket.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    shapes: tuple[tuple[int, ...], ...]     # per tensor
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    # per tensor (bucket index, offset)
    assign: tuple[tuple[int, int], ...]
    bucket_sizes: tuple[int, ...]           # padded to mesh divisibility
    pad_multiple: int


def leaf_tensors(x) -> tuple:
    """A leaf's tensors: itself, or its run of tensors."""
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


def make_plan(leaves, bucket_bytes: int = 1 << 28,
              pad_multiple: int = 1) -> BucketPlan:
    """``leaves``: tensors (any device, ``meta`` included), or runs of
    tensors that count as one leaf. A leaf goes whole into the current
    bucket unless it would take it past ``bucket_bytes``, then into a new
    one; each bucket is zero-padded to a multiple of ``pad_multiple``."""
    shapes, dtypes, sizes, assign = [], [], [], []
    bucket_sizes: list[int] = []
    cur, cur_bytes = -1, 0
    for leaf in leaves:
        ts = leaf_tensors(leaf)
        nbytes = sum(t.numel() * t.element_size() for t in ts)
        if cur < 0 or cur_bytes + nbytes > bucket_bytes:
            cur += 1
            bucket_sizes.append(0)
            cur_bytes = 0
        for t in ts:
            shapes.append(tuple(t.shape))
            dtypes.append(t.dtype)
            sizes.append(t.numel())
            assign.append((cur, bucket_sizes[cur]))
            bucket_sizes[cur] += t.numel()
        cur_bytes += nbytes
    padded = tuple(-(-s // pad_multiple) * pad_multiple for s in bucket_sizes)
    return BucketPlan(tuple(shapes), tuple(dtypes), tuple(sizes),
                      tuple(assign), padded, pad_multiple)


def flatten_bucket(plan: BucketPlan, tensors, bi: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Bucket ``bi`` of ``tensors`` (the plan's flat list), cast to
    ``dtype`` and zero-padded."""
    parts = [t.reshape(-1).to(dtype) for (b, _), t in zip(plan.assign, tensors)
             if b == bi]
    v = torch.cat(parts)
    pad = plan.bucket_sizes[bi] - v.shape[0]
    return torch.nn.functional.pad(v, (0, pad)) if pad else v


def flatten(plan: BucketPlan, tensors, dtype=torch.float32) -> list:
    """Pack ``tensors`` (the plan's flat list) into 1-D buckets, cast to
    ``dtype``."""
    tensors = list(tensors)
    if len(tensors) != len(plan.sizes):
        raise ValueError(f"{len(tensors)} tensors for a plan of "
                         f"{len(plan.sizes)}")
    return [flatten_bucket(plan, tensors, bi, dtype)
            for bi in range(len(plan.bucket_sizes))]


def unflatten(plan: BucketPlan, buckets) -> list:
    """Unpack buckets into the plan's tensors (original shapes and dtypes:
    views of the buckets where the dtype is the buckets')."""
    return [buckets[bi][off:off + n].view(shape).to(dt)
            for (bi, off), shape, dt, n in zip(plan.assign, plan.shapes,
                                               plan.dtypes, plan.sizes)]


def zeros_like_buckets(plan: BucketPlan, dtype=torch.float32,
                       device=None) -> list:
    return [torch.zeros((s,), dtype=dtype, device=device)
            for s in plan.bucket_sizes]



def real_sizes(plan: BucketPlan) -> list[int]:
    """Each bucket's elements before padding."""
    out = [0] * len(plan.bucket_sizes)
    for (bi, _), n in zip(plan.assign, plan.sizes):
        out[bi] += n
    return out


def shard_plan(plan: BucketPlan, numels) -> BucketPlan:
    """The plan of one rank's buckets: tensor j, a 1-D shard of
    ``numels[j]`` elements, in the bucket ``plan`` puts it in, right after
    the bucket's earlier shards; no padding."""
    sizes = [0] * len(plan.bucket_sizes)
    assign = []
    for (bi, _), k in zip(plan.assign, numels):
        assign.append((bi, sizes[bi]))
        sizes[bi] += k
    return BucketPlan(tuple((k,) for k in numels), plan.dtypes,
                      tuple(numels), tuple(assign), tuple(sizes), 1)


def unshard_bucket(plan: BucketPlan, splan: BucketPlan, bi: int,
                   gathered: torch.Tensor) -> torch.Tensor:
    """Bucket ``bi`` in the reference's order, its real elements only, from
    every rank's bucket ``gathered`` [ranks, splan.bucket_sizes[bi]] (rank
    i's shard of a tensor holds its elements [i k, (i + 1) k))."""
    parts = []
    for (b, off), n, (_, soff), k in zip(plan.assign, plan.sizes,
                                         splan.assign, splan.sizes):
        if b == bi:
            parts.append((off, gathered[:, soff:soff + k].reshape(-1)[:n]))
    parts.sort(key=lambda x: x[0])
    return torch.cat([p for _, p in parts])


def shard_bucket(plan: BucketPlan, splan: BucketPlan, bi: int,
                 full: torch.Tensor, index: int) -> torch.Tensor:
    """Rank ``index``'s bucket ``bi`` from the reference-order bucket
    ``full`` (its real elements, ``unshard_bucket``'s result)."""
    parts = []
    for (b, off), n, (_, soff), k in zip(plan.assign, plan.sizes,
                                         splan.assign, splan.sizes):
        if b == bi:
            mine = full[off + index * k:off + min((index + 1) * k, n)]
            parts.append((soff, torch.nn.functional.pad(
                mine, (0, k - mine.shape[0]))))
    parts.sort(key=lambda x: x[0])
    return torch.cat([p for _, p in parts])
