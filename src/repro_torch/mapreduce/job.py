"""Composable MapReduce jobs on PyTorch: the device and host engines.

The port of ``repro.mapreduce.job``. A job composes three pluggable stages,

- ``Partitioner``   (map): key assignment + border-replication policy,
- ``ShuffleCodec``  (shuffle): wire format, by registry name (``codecs.py``),
- ``Reducer``       (reduce): batched kernel + host-side finalize,

and one of two engines runs them:

- ``engine="device"`` (the default): map, shuffle and reduce as tensor ops
  on one device.
  1. map: partition keys and the (owned + border copy) bucket-entry stream,
     payload encoded straight to the codec's wire dtype;
  2. shuffle: per-partition counts, ``plan_tiers`` groups partitions into
     at most 3 capacity tiers, and a stable sort by (destination, sort key)
     scatters the wire rows into each tier's padded ``[Pt, C, ...]``
     layout;
  3. reduce: per tier, decode on the device and one masked batched kernel
     launch per reducer (``kernels/zones_pairs``: CUDA kernels on the card,
     plain PyTorch on the CPU);
  4. finalize on the host.
- ``engine="host"``: the JAX package's oracle-parity path. ``shuffle_stage``
  maps and buckets on the host with numpy (one stable argsort of the
  entries by destination), round-trips the whole payload through the
  codec's host transform on the device (int8: the quantize kernels) and
  pads every partition to ONE global capacity (``ShuffledData``, numpy
  arrays identical to the JAX package's); ``reduce_stage`` moves them to
  the device and runs each reducer's ``per_partition_sum``, one batched
  unmasked kernel call over all partitions for the pair reducers (the JAX
  package's ``lax.map`` written out as a batch axis).

Entry points (``run_jobs``, ``run_job``, ``shuffle_once``, ``shuffle_stage``,
``reduce_stage``, ``host_shuffle_reduce``) take ``device=None``, which means
``"cuda"``: with no card and no explicit ``device="cpu"`` they raise instead
of quietly running on the CPU.

``mesh=`` (a ``DeviceMesh`` with a ``"data"`` axis, ``launch/mesh.py``)
shards the reduce. Every rank calls the entry point with the same
arguments, maps and shuffles the whole input (the reference's unsharded
arrays are replicated), and so holds the same tiers, each padded to a
multiple of the data axis size D with phantom partitions. Rank s reduces
tier rows ``[s*Pt/D, (s+1)*Pt/D)`` and the integer partials cross one
all-reduce over ``data`` a tier (the reference's ``psum``): every rank
returns the same results. Under a mesh ``device=None`` means the rank's
card, ``cuda:(rank % device_count)``.

``codec="auto"``, ``tile="auto"`` and ``run_jobs(split_rows="auto")`` ask the
cost model (``core/cost_model.py``); the device engine records the model's
predicted shuffle and reduce walls beside the measured ones.

    part = ZonePartitioner(radius)
    jobs = [neighbor_search_job(radius, partitioner=part),
            neighbor_statistics_job(partitioner=part)]
    results = run_jobs(jobs, xyz)                  # device engine, on the card
    results = run_jobs(jobs, xyz, engine="host")   # host engine, on the card
    results = run_jobs(jobs, xyz, device="cpu")    # plain versions
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.compression import psum_1d
from repro_torch.core.cost_model import (FP32_OPS_PER_CELL, StageCost,
                                         agree_cost_model, get_cost_model)
from repro_torch.core.device import resolve_device
from repro_torch.mapreduce.codecs import ShuffleCodec, get_codec
from repro_torch.mapreduce.instrumentation import StageStats
from repro_torch.obs.energy import get_meter
from repro_torch.obs.trace import get_tracer


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def _data_axis_size(mesh) -> int:
    """1 for ``None`` or a mesh without ``"data"``, else that dim's size."""
    if mesh is None or "data" not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index("data")])


def _entry_device(device, mesh) -> torch.device:
    """``resolve_device`` for an entry point. Under a mesh it also makes
    the mesh's first rank's cost model every rank's (``agree_cost_model``):
    then every auto knob resolves alike on every rank, from the same data.
    Call it on the calling thread before a lane starts."""
    device = resolve_device(device, mesh)
    if mesh is not None:
        agree_cost_model(mesh, device)
    return device


def _fence(device: torch.device) -> None:
    """Wait for the work queued on this thread's current stream, so a host
    clock reads device time. Only that stream: a device-wide synchronize
    would also wait for the prefetch thread's copies and the other lanes'
    stages, and charge them to this stage."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _trace(name: str, t0: float, t1: float, **ids) -> None:
    """Record a stage span from the fenced ``t0``/``t1`` its ``StageStats``
    wall already took: tracing adds no synchronization."""
    tr = get_tracer()
    if tr.enabled:
        tr.record(name, t0, t1, cat="stage", **ids)


# ---------------------------------------------------------------------------
# Pluggable stages
# ---------------------------------------------------------------------------

class Partitioner:
    """Map stage: assigns each item a partition key, and optionally replicates
    items into neighboring partitions (the paper's mappers "copy objects
    within a certain region around each block")."""

    def n_partitions(self, items) -> int:
        raise NotImplementedError

    def assign(self, items: np.ndarray) -> np.ndarray:
        """-> [n] int32 owning-partition ids (host, numpy)."""
        raise NotImplementedError

    def replicas(self, items: np.ndarray, keys: np.ndarray, n_parts: int):
        """Yield (dest_partition, item_index_array) border copies (host).
        Default: none (self-contained partitions, e.g. hash partitioning)."""
        return ()

    # -- device hooks: the map stage as tensor ops ------------------------

    def assign_device(self, items: torch.Tensor) -> torch.Tensor:
        """Tensor version of ``assign`` ([n, d] -> [n] int32). Default:
        round-trips through the host ``assign``."""
        keys = self.assign(items.cpu().numpy())
        return torch.as_tensor(np.asarray(keys, np.int32),
                               device=items.device)

    def sort_key_device(self, items: torch.Tensor):
        """Optional [n] secondary sort key: rows within a partition land in
        this order. Order never affects results (partition reductions are
        commutative sums), so ``None`` (arrival order) is always correct."""
        return None

    def bucket_entries_device(self, items, keys, n_parts: int):
        """-> (dest [m] int32, src [m] int32, valid [m] bool): every
        (partition, item) bucket entry, owned points plus border copies.
        Default: owned entries on the device, replicas (if any) from the
        host ``replicas`` hook."""
        dev = keys.device
        n = keys.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        reps = list(self.replicas(items.cpu().numpy(), keys.cpu().numpy(),
                                  n_parts))
        if reps:
            r_dest = np.concatenate([np.full(len(i), d, np.int32)
                                     for d, i in reps])
            r_src = np.concatenate([np.asarray(i, np.int32) for _, i in reps])
            keys = torch.cat([keys, torch.as_tensor(r_dest, device=dev)])
            idx = torch.cat([idx, torch.as_tensor(r_src, device=dev)])
        return keys, idx, torch.ones(keys.shape[0], dtype=torch.bool,
                                     device=dev)


@dataclasses.dataclass(frozen=True)
class HashPartitioner(Partitioner):
    """Key mod n_parts on the first column — Hadoop's default partitioner."""

    n_parts: int

    def n_partitions(self, items):
        return self.n_parts

    def assign(self, items):
        key = items[:, 0] if items.ndim > 1 else items
        return (np.asarray(key).astype(np.int64) % self.n_parts
                ).astype(np.int32)

    def assign_device(self, items):
        key = items[:, 0] if items.dim() > 1 else items
        return key.to(torch.int32) % self.n_parts


class Reducer:
    """Reduce stage: a per-partition kernel plus a host-side ``finalize``.
    Partition (and tier) results are combined by summation."""

    pad_value: float = 0.0   # fill for capacity padding; part of the shuffle
                             # signature, pick one kernels ignore

    # cost-model basis for tile="auto" planning (class attr, not a field):
    # "pairs" = work quadratic in score cells (cross-row reducers);
    # "rows"  = work linear in owned rows (monoid/bincount reducers), where
    # extra tiers are mostly fixed overhead. Never affects results, only
    # which tile/tier split the planner predicts fastest, and how the
    # device engine's reduce prediction charges the reducer.
    cost_basis = "pairs"

    def per_partition(self, owned_p, bucket_p):
        """[C1, d], [C2, d] -> fixed-shape tensor, summed over partitions."""
        raise NotImplementedError

    def per_partition_sum(self, owned, bucket):
        """The host engine's reduce: [P, C1, d], [P, C2, d] padded with
        ``pad_value`` -> the sum over p of ``per_partition`` (the JAX
        package's ``lax.map`` + sum, written out). Override with one
        batched kernel call for the hot path."""
        outs = [self.per_partition(owned[p], bucket[p])
                for p in range(owned.shape[0])]
        return torch.stack(outs).sum(dim=0)

    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        """The device engine's reduce over a whole size tier: [P, C1, d],
        [P, C2, d] + [P] real counts -> the partition-summed result. Rows
        at index >= count are capacity padding and MUST not contribute.

        Default: re-mask padding to ``pad_value`` and reduce through
        ``per_partition_sum`` (correct for any reducer). Override with a
        masked batched kernel for the hot path."""
        dev = owned.device
        pad = torch.tensor(self.pad_value, dtype=owned.dtype, device=dev)
        mo = torch.arange(owned.shape[1], device=dev) < n_owned[:, None]
        mb = torch.arange(bucket.shape[1], device=dev) < n_bucket[:, None]
        return self.per_partition_sum(torch.where(mo[..., None], owned, pad),
                                      torch.where(mb[..., None], bucket, pad))

    def finalize(self, total, sd: "DeviceShuffledData"):
        """Host-side post-combine (dedup corrections, differencing, ...)."""
        return total.cpu().numpy()

    def flops(self, sd: "DeviceShuffledData") -> float:
        """Estimated reduce-stage FLOPs, for StageStats accounting."""
        return 0.0

    def combiner(self):
        """Map-side combine plugin (an ``executor.Combiner``) for this
        reducer, or None when per-split reduce outputs cannot be merged into
        the whole-catalog answer (any reducer whose kernel couples rows
        ACROSS items, e.g. pair counting: a pair spanning two splits is seen
        by neither split alone). Reducers whose output is a
        commutative-monoid fold over individual owned rows (wordcount's
        token histogram) return one, and the streaming executor then keeps
        only the combined accumulator across splits."""
        return None


@dataclasses.dataclass
class TierData:
    """One capacity size-class of the device shuffle: all partitions whose
    bucket fits in C2 rows, padded to one [Pt, C*, ...] layout."""

    part_ids: np.ndarray       # [Pt] global partition ids (host)
    owned_wire: tuple          # codec wire tensors, leading dims [Pt, C1]
    bucket_wire: tuple         # codec wire tensors, leading dims [Pt, C2]
    n_owned: torch.Tensor      # [Pt] int32 real counts (device)
    n_bucket: torch.Tensor     # [Pt] int32 real counts (device)
    C1: int = 0
    C2: int = 0
    Pt: int = 0

    @property
    def nbytes(self) -> int:
        return sum(w.numel() * w.element_size()
                   for w in (*self.owned_wire, *self.bucket_wire))


class _PaddingAccounting:
    """Padded-vs-real capacity accounting shared by both engines'
    post-shuffle state (reducer ``flops`` estimates read it)."""

    @property
    def pair_cells(self) -> float:
        """Total padded (owned x bucket) cells the reduce kernels cover."""
        raise NotImplementedError

    @property
    def owned_cells(self) -> float:
        """Total padded owned-capacity rows."""
        raise NotImplementedError

    @property
    def real_pair_cells(self) -> float:
        no = np.asarray(self.n_owned, np.float64)
        nb = np.asarray(self.n_bucket, np.float64)
        return float(np.sum(no * nb))

    @property
    def padded_ratio(self) -> float:
        """pair_cells / real_pair_cells: how much compute the capacity
        padding adds (the fig3 ``bigger_blocks`` inversion in one number)."""
        real = self.real_pair_cells
        return self.pair_cells / real if real else 1.0

    def __post_init__(self):
        # one shard unless the producer counted the shards of a mesh
        if self.shard_pad is None:
            self.shard_pad = np.array([self.pair_cells], np.float64)
            self.shard_real = np.array([self.real_pair_cells], np.float64)


@dataclasses.dataclass
class ShuffledData(_PaddingAccounting):
    """The host engine's post-shuffle state: every partition padded to one
    global capacity (numpy arrays, as the JAX package's)."""

    owned: np.ndarray          # [P, C1, d] f32 (pad_value-padded)
    bucket: np.ndarray         # [P, C2, d] owned + replicas (pad_value-padded)
    n_owned: np.ndarray        # [P] int32 real counts
    n_bucket: np.ndarray       # [P] int32 real counts
    shard_pad: np.ndarray = None    # [D] padded pair cells per shard
    shard_real: np.ndarray = None   # [D] real pair cells per shard

    @property
    def pair_cells(self) -> float:
        P, C1, _ = self.owned.shape
        return float(P) * C1 * self.bucket.shape[1]

    @property
    def owned_cells(self) -> float:
        return float(self.owned.shape[0]) * self.owned.shape[1]


@dataclasses.dataclass
class DeviceShuffledData(_PaddingAccounting):
    """Post-shuffle state: wire-dtype payloads grouped into capacity tiers.
    ``n_owned``/``n_bucket`` are the global per-partition real counts
    (host arrays) that reducer ``finalize`` hooks read."""

    tiers: list
    n_owned: np.ndarray        # [P] int64 (host)
    n_bucket: np.ndarray       # [P] int64 (host)
    shard_pad: np.ndarray = None    # [D] padded pair cells per shard
    shard_real: np.ndarray = None   # [D] real pair cells per shard

    @property
    def pair_cells(self) -> float:
        return float(sum(t.Pt * t.C1 * t.C2 for t in self.tiers))

    @property
    def owned_cells(self) -> float:
        return float(sum(t.Pt * t.C1 for t in self.tiers))


@dataclasses.dataclass
class MapReduceJob:
    """A named composition of the three pluggable stages.

    ``codec="auto"`` / ``tile="auto"`` delegate the choice to the cost
    model (``core/cost_model.py``): codec resolves at job entry (exact
    codecs only, so arithmetic never changes), tile at shuffle time when
    the per-partition counts are known. Both default to concrete values:
    auto is opt-in."""

    name: str
    partitioner: Partitioner
    reducer: Reducer
    codec: str | ShuffleCodec = "identity"
    tile: int | str = 256      # capacity quantum (the paper's block size)


def resolve_auto_job(job: MapReduceJob, device=None) -> MapReduceJob:
    """Materialize ``codec="auto"`` through the cost model of ``device``
    (None: the card). Exact codecs only: auto choices change shapes, never
    arithmetic. ``tile="auto"`` stays on the job: it resolves inside
    ``_shuffle_mapped``, where the per-partition counts exist."""
    if _is_auto(job.codec):
        job = dataclasses.replace(job, codec=_concrete_codec("auto", device))
    return job


def _is_auto(knob) -> bool:
    return isinstance(knob, str) and knob == "auto"


def _concrete_codec(codec, device):
    """``"auto"`` -> the cost model's choice (an exact codec), else as
    given."""
    if _is_auto(codec):
        return get_cost_model(device=device).choose_codec()
    return codec


@dataclasses.dataclass
class JobResult:
    output: object
    stats: StageStats


@dataclasses.dataclass
class MappedSplit:
    """Device-resident output of the map stage for one catalog split: the
    codec wire payload plus the bucket-entry index metadata. The streaming
    executor (``executor.py``) reduces each one at once (combine mode) or
    accumulates them with ``concat_mapped`` and reduces once; only
    wire-dtype tensors persist."""

    payloads: tuple            # codec wire tensors, leading axis = n_rows
    keys: torch.Tensor         # [n] int32 owning partition per row
    dest_eff: torch.Tensor     # [m] int32 bucket destinations (invalid -> P)
    src: torch.Tensor          # [m] int32 row index into payloads
    skey: object               # [n] secondary sort key or None
    n_rows: int = 0
    d: int = 0
    nbytes_in: int = 0         # raw input bytes (map_bytes accounting)


# ---------------------------------------------------------------------------
# Tier planning (numpy; the reference's search)
# ---------------------------------------------------------------------------

def plan_tiers(n_owned, n_bucket, tile: int, max_tiers: int = 3,
               pad_partitions_to: int = 1, tier_cost=None):
    """Group partitions into <= ``max_tiers`` capacity size classes.

    One global capacity (the host engine's choice) is sized by the most
    skewed partition, so every partition pays the worst partition's padding
    — the fig3 ``bigger_blocks`` inversion. Tiers bound that: partitions are
    grouped by bucket capacity (rounded to the ``tile`` quantum) and each
    tier is padded only to ITS max. The split points are chosen by exact
    search over distinct capacities, minimizing total tier cost.

    ``tier_cost``: optional vectorized callable ``f(Pt, C1, C2) -> cost``
    over float64 numpy arrays (``Pt`` = phantom-padded partition count),
    e.g. the cost model's predicted tier wall (``CostModel.tier_cost_fn()``).
    Default: padded pair cells ``Pt * C1 * C2``.

    ``pad_partitions_to``: each tier's partition count is rounded up to a
    multiple of it with phantom all-padding partitions (the reference's mesh
    ``data`` axis size); the cost search charges those phantom rows. The
    device engine runs on one card and passes 1.

    The search is a vectorized scan over the O(U^2) segment-cost table of
    unique capacities, with an early-exit bound: any prefix tier already
    costing >= the incumbent best prunes every deeper split under it; past
    3 tiers an exact depth-first search with the same bound.

    -> list of (part_ids ascending, C1, C2) per tier (part_ids are REAL
    partitions only; phantoms are the caller's).
    """
    n_owned = np.asarray(n_owned, np.int64)
    n_bucket = np.asarray(n_bucket, np.int64)
    pad = pad_partitions_to
    caps = np.array([_round_up(int(c), tile) for c in n_bucket], np.int64)
    uniq = np.unique(caps)
    U = len(uniq)

    def build(cut_ids):
        tiers, lo = [], -1
        for th in (int(uniq[i]) for i in cut_ids):
            sel = np.flatnonzero((caps > lo) & (caps <= th))
            lo = th
            if len(sel):
                tiers.append((sel, _round_up(int(n_owned[sel].max()), tile),
                              th))
        return tiers

    # Segment-cost table: S[i, j] = cost of one tier covering uniq[i..j]
    # (inclusive; +inf below the diagonal). Costs are exact in float64 —
    # padded-cell counts are integers far below 2**53 — so argmin over S
    # reproduces the python accumulation bit-for-bit.
    ui = np.searchsorted(uniq, caps)
    maxo = np.zeros(U, np.int64)
    np.maximum.at(maxo, ui, n_owned)
    pc = np.concatenate([[0], np.cumsum(np.bincount(ui, minlength=U))])
    row = np.arange(U)[:, None]
    col = np.arange(U)[None, :]
    seg_max = np.maximum.accumulate(
        np.where(col >= row, maxo[None, :], 0), axis=1)
    cnt = pc[1:][None, :] - pc[:-1][:, None]
    Pt = np.maximum(pad, -(-cnt // pad) * pad).astype(np.float64)
    C1 = np.maximum(tile, -(-seg_max // tile) * tile).astype(np.float64)
    C2 = np.broadcast_to(uniq.astype(np.float64)[None, :], (U, U))
    if tier_cost is None:
        S = Pt * C1 * C2
    else:
        S = np.asarray(tier_cost(Pt, C1, C2), np.float64)
    S = np.where(col >= row, S, np.inf)

    best_cost = float(S[0, U - 1])
    best_cuts = (U - 1,)
    if max_tiers >= 2 and U >= 2:
        two = S[0, :U - 1] + S[1:, U - 1]
        c = int(np.argmin(two))          # first occurrence = lexicographic
        if two[c] < best_cost:
            best_cost, best_cuts = float(two[c]), (c, U - 1)
    if max_tiers >= 3 and U >= 3:
        a = S[0, :U - 2]                 # prefix tier ending at cut c1
        keep = a < best_cost             # early-exit bound: prefix alone
        if keep.any():                   # >= incumbent prunes the row
            T = ((a[:, None] + S[1:U - 1, 1:U - 1])
                 + S[2:, U - 1][None, :])
            r2 = np.arange(U - 2)
            T = np.where((r2[:, None] <= r2[None, :]) & keep[:, None],
                         T, np.inf)
            flat = int(np.argmin(T))
            c1, c2 = divmod(flat, U - 2)
            if T[c1, c2] < best_cost:
                best_cost = float(T[c1, c2])
                best_cuts = (c1, c2 + 1, U - 1)
    if max_tiers > 3 and U > 3:
        # deeper splits are rare; exact DFS with the same early-exit bound
        kmax = min(max_tiers, U)

        def dfs(i0, cuts, prefix):
            nonlocal best_cost, best_cuts
            if prefix >= best_cost:
                return
            close = prefix + S[i0, U - 1]
            if close < best_cost:
                best_cost, best_cuts = float(close), tuple(cuts) + (U - 1,)
            if len(cuts) + 2 <= kmax:
                for c in range(i0, U - 1):
                    dfs(c + 1, cuts + [c], prefix + S[i0, c])

        dfs(0, [], 0.0)
    return build(best_cuts)


# ---------------------------------------------------------------------------
# Map, shuffle, reduce
# ---------------------------------------------------------------------------

def map_split_device(partitioner: Partitioner, codec: ShuffleCodec, items,
                     P: int, device) -> MappedSplit:
    """Map stage: partition assignment + border replication as tensor ops,
    payload encoded straight to the codec's wire dtype. Asynchronous on the
    card: nothing here waits for the device."""
    if isinstance(items, torch.Tensor):
        nbytes_in = items.numel() * items.element_size()
        x = items.to(device=device, dtype=torch.float32)
    else:
        arr = np.asarray(items)
        nbytes_in = int(arr.nbytes)
        x = torch.as_tensor(np.asarray(arr, np.float32), device=device)
    if x.dim() == 1:
        x = x[:, None]
    keys = partitioner.assign_device(x)
    dest, src, valid = partitioner.bucket_entries_device(x, keys, P)
    dest_eff = torch.where(valid, dest, P).to(torch.int32)
    return MappedSplit(codec.encode_device(x), keys, dest_eff,
                       src.to(torch.int32), partitioner.sort_key_device(x),
                       n_rows=int(x.shape[0]), d=int(x.shape[1]),
                       nbytes_in=nbytes_in)


def map_timed(partitioner: Partitioner, codec: ShuffleCodec, items, P: int,
              device, stats: StageStats) -> MappedSplit:
    """``map_split_device`` fenced on the current stream, its wall added
    (``+=``) to ``stats.map_wall_s`` and traced as the ``map`` span."""
    t0 = time.perf_counter()
    m = map_split_device(partitioner, codec, items, P, device)
    _fence(device)
    t1 = time.perf_counter()
    stats.map_wall_s += t1 - t0
    _trace("map", t0, t1, engine="device")
    return m


def concat_mapped(splits: "list[MappedSplit]") -> MappedSplit:
    """Merge per-split map outputs into one stream (``torch.cat``; source row
    indices are offset by the rows of the splits before). Entry ORDER
    differs from a monolithic map over the concatenated catalog; bucket
    contents are identical as multisets, and partition reductions are
    commutative sums, so results are bit-identical."""
    if len(splits) == 1:
        return splits[0]
    offs = np.cumsum([0] + [s.n_rows for s in splits[:-1]])
    skeys = [s.skey for s in splits]
    return MappedSplit(
        payloads=tuple(torch.cat(ps)
                       for ps in zip(*(s.payloads for s in splits))),
        keys=torch.cat([s.keys for s in splits]),
        dest_eff=torch.cat([s.dest_eff for s in splits]),
        src=torch.cat([s.src + int(o) for s, o in zip(splits, offs)]),
        skey=(None if any(sk is None for sk in skeys) else torch.cat(skeys)),
        n_rows=int(sum(s.n_rows for s in splits)),
        d=splits[0].d,
        nbytes_in=int(sum(s.nbytes_in for s in splits)))


@dataclasses.dataclass
class StreamSummary:
    """Aggregate post-shuffle state of a streaming run with a combiner: what
    ``Reducer.finalize`` sees instead of one shuffle's data.
    ``n_owned``/``n_bucket`` are per-partition counts SUMMED over splits, so
    count-based corrections (self-pair removal) work unchanged."""

    n_owned: np.ndarray        # [P] int64
    n_bucket: np.ndarray       # [P] int64
    pair_cells: float = 0.0
    owned_cells: float = 0.0
    real_pair_cells: float = 0.0
    shard_pad: np.ndarray = None    # [D] padded pair cells per shard
    shard_real: np.ndarray = None   # [D] real pair cells per shard

    @property
    def padded_ratio(self) -> float:
        return (self.pair_cells / self.real_pair_cells
                if self.real_pair_cells else 1.0)

    def __post_init__(self):
        if self.shard_pad is None:
            self.shard_pad = np.array([self.pair_cells], np.float64)
            self.shard_real = np.array([self.real_pair_cells], np.float64)


def _stable_order(primary, secondary=None):
    """Permutation sorting by (primary, secondary), ties in arrival order:
    ``np.lexsort((secondary, primary))`` as two stable sorts."""
    if secondary is None:
        return torch.sort(primary, stable=True).indices
    by2 = torch.sort(secondary, stable=True).indices
    return by2[torch.sort(primary[by2], stable=True).indices]


def _scatter_tiers(payloads, keys, dest, src, skey, o_starts, b_starts,
                   part_tier, part_local, specs):
    """Argsort bucketing: sort owned rows by (partition, sort key) and bucket
    entries by (destination, sort key of the source row), rank each within
    its partition from the exclusive-cumsum starts, and scatter the
    wire-dtype rows into every tier's zero-padded [Pt, C, ...] layout.
    -> tuple over tiers of (owned wire tuple, bucket wire tuple)."""
    dev = keys.device
    ko = _stable_order(keys, skey)
    bo = _stable_order(dest, None if skey is None else skey[src.long()])
    sk = keys[ko].long()
    orank = torch.arange(sk.shape[0], device=dev) - o_starts[sk]
    sd = dest[bo].long()
    brank = torch.arange(sd.shape[0], device=dev) - b_starts[sd]
    bsrc = src[bo].long()

    def scatter(part, rank, rows, t, Pt, C):
        sel = part_tier[part] == t
        pos = part_local[part[sel]] * C + rank[sel]
        rows = rows[sel]
        out = []
        for p in payloads:
            buf = torch.zeros((Pt * C,) + tuple(p.shape[1:]), dtype=p.dtype,
                              device=dev)
            buf[pos] = p[rows]
            out.append(buf.reshape((Pt, C) + tuple(p.shape[1:])))
        return tuple(out)

    return tuple((scatter(sk, orank, ko, t, Pt, C1),
                  scatter(sd, brank, bsrc, t, Pt, C2))
                 for t, (Pt, C1, C2) in enumerate(specs))


def _shard_ratios(shard_pad, shard_real) -> tuple:
    """Per-shard padded over real pair cells (a shard with no real cell
    shows its padded count)."""
    return tuple(float(p / max(r, 1.0)) for p, r in zip(shard_pad, shard_real))


def _shard_rows(Pt: int, mesh) -> slice:
    """This rank's rows of a [Pt, ...] tier: ``[s*Pt/D, (s+1)*Pt/D)`` for
    its coordinate s on the data axis."""
    q = Pt // _data_axis_size(mesh)
    s = mesh.get_local_rank("data")
    return slice(s * q, (s + 1) * q)


def _psum_partials(partials, mesh, device, stats: StageStats):
    """All-reduce each reducer's partial over ``data`` (the reference's
    ``psum``), fenced on both sides so ``stats.collective_wall_s`` holds
    the collectives alone."""
    _fence(device)
    t0 = time.perf_counter()
    out = tuple(psum_1d(x, "data", mesh=mesh) for x in partials)
    _fence(device)
    stats.collective_wall_s += time.perf_counter() - t0
    return out


def _reduce_tier_sharded(reducers, codec, tier: TierData, mesh, stats,
                         device, psum: bool = True):
    """Reduce this rank's rows of one tier and all-reduce the partials over
    the mesh's ``data`` axis. The rows are slices (views) of the tier's
    wire tensors and counts; the masked kernels walk only real cells, so a
    phantom partition costs a launch block and nothing more. With
    ``psum=False`` the partials stay this rank's (the caller sums them
    first and all-reduces once). -> tuple of per-reducer totals."""
    sl = _shard_rows(tier.Pt, mesh)
    owned = codec.decode_device(*(w[sl] for w in tier.owned_wire))
    bucket = codec.decode_device(*(w[sl] for w in tier.bucket_wire))
    outs = tuple(r.reduce_partitions(owned, bucket, tier.n_owned[sl],
                                     tier.n_bucket[sl]) for r in reducers)
    return _psum_partials(outs, mesh, device, stats) if psum else outs


@dataclasses.dataclass
class ResidentCatalog:
    """Device-resident post-shuffle handle: a catalog mapped and shuffled
    ONCE into tiered wire-dtype partitions, plus the shuffle signature
    (partitioner / codec / tile / pad_value) that defines which jobs may
    reduce against it. ``run(jobs)`` serves any batch of compatible jobs as
    one fused reduce on the catalog's device, sharded over the ``data``
    axis of ``mesh`` when there is one."""

    partitioner: Partitioner
    codec: ShuffleCodec
    tile: int | str                    # as the jobs name it ("auto" too)
    pad_value: float
    sd: DeviceShuffledData
    P: int
    device: torch.device
    n_rows: int = 0
    d: int = 0
    load_stats: StageStats = None      # the shuffle-once cost
    tile_resolved: int = 0             # the concrete tile the tiers used
    mesh: object = None                # the reduce shards over its "data"

    @property
    def nbytes(self) -> int:
        """Resident wire bytes held on the device across requests."""
        return sum(t.nbytes for t in self.sd.tiers)

    @property
    def shard_pad(self) -> np.ndarray:
        """[D] padded pair cells per shard."""
        return self.sd.shard_pad

    @property
    def shard_real(self) -> np.ndarray:
        """[D] real pair cells per shard."""
        return self.sd.shard_real

    def validate(self, jobs) -> None:
        """Jobs must share this catalog's shuffle signature."""
        for j in jobs:
            diffs = [k for k, a, b in [
                ("partitioner", j.partitioner, self.partitioner),
                ("codec", get_codec(j.codec).name, self.codec.name),
                ("tile", j.tile, self.tile),
                ("pad_value", j.reducer.pad_value, self.pad_value),
            ] if a != b]
            if diffs:
                raise ValueError(
                    f"job {j.name!r} cannot reduce against this resident "
                    f"catalog: differs in {', '.join(diffs)}")

    def reduce_totals(self, reducers, stats: StageStats, psum: bool = True):
        """Tiered masked reduce of ``reducers`` over the resident tiers:
        decode each tier on the device, one batched kernel call per reducer,
        sum over tiers. Under a data-axis mesh each tier reduces this rank's
        rows and all-reduces the partials (``_reduce_tier_sharded``; with
        ``psum=False`` the totals stay this rank's). Accumulates (``+=``)
        into ``stats``. -> tuple of per-reducer totals (tensors on the
        device)."""
        sharded = _data_axis_size(self.mesh) > 1
        t0 = time.perf_counter()
        totals = None
        for tier in self.sd.tiers:
            if sharded:
                outs = _reduce_tier_sharded(reducers, self.codec, tier,
                                            self.mesh, stats, self.device,
                                            psum)
            else:
                owned = self.codec.decode_device(*tier.owned_wire)
                bucket = self.codec.decode_device(*tier.bucket_wire)
                outs = tuple(r.reduce_partitions(owned, bucket, tier.n_owned,
                                                 tier.n_bucket)
                             for r in reducers)
            totals = outs if totals is None else tuple(
                a + b for a, b in zip(totals, outs))
        _fence(self.device)
        t1 = time.perf_counter()
        stats.reduce_wall_s += t1 - t0
        _trace("reduce", t0, t1, engine="device", tiers=len(self.sd.tiers))
        stats.reduce_bytes += self.nbytes
        stats.reduce_flops += float(sum(r.flops(self.sd) for r in reducers))
        stats.predicted_reduce_wall_s += get_cost_model(
            device=self.device).predict_wall(self.reduce_cost(reducers))
        return totals

    def reduce_cost(self, reducers) -> StageCost:
        """What one fused reduce pass of ``reducers`` costs the kernels.
        A pair reducer's masked kernel walks the real cells only
        (``real_pair_cells``: ``zones_pairs.cu`` stops each partition at its
        real bucket rows) at ``FP32_OPS_PER_CELL``; its ``flops()`` charge
        the padded cells, as the reference's do, and stay what
        ``reduce_flops`` reports. A rows reducer is charged its ``flops()``.
        Bytes: the wire tiers read and decoded to f32 once, the f32 tiers
        read once by each reducer. Launches: per tier, two decodes and one a
        reducer."""
        f32 = 4.0 * self.d * sum(t.Pt * (t.C1 + t.C2) for t in self.sd.tiers)
        cells = self.sd.real_pair_cells
        flops = sum(FP32_OPS_PER_CELL * cells if r.cost_basis == "pairs"
                    else r.flops(self.sd) for r in reducers)
        return StageCost(flops=float(flops),
                         hbm_bytes=self.nbytes + f32 * (1 + len(reducers)),
                         n_dispatch=len(self.sd.tiers) * (len(reducers) + 2))

    def run(self, jobs, stats: StageStats = None) -> "list[JobResult]":
        """Serve ``jobs`` (one or a batch) against the resident tiers with a
        single fused reduce pass: no map, no shuffle. -> one JobResult per
        job, sharing one StageStats whose map/shuffle walls are zero."""
        jobs = [jobs] if isinstance(jobs, MapReduceJob) else list(jobs)
        totals, stats = self._reduce(jobs, stats, psum=True)
        return [JobResult(j.reducer.finalize(t, self.sd), stats)
                for j, t in zip(jobs, totals)]

    def partials(self, jobs, stats: StageStats = None):
        """``run``'s fused reduce without its all-reduce and its finalize:
        under a data-axis mesh, this rank's per-job partial totals (the
        ``reduce_totals(psum=False)`` of ``_reduce_tier_sharded``), which
        the caller sums over ``data`` and finalizes. Issues no collective.
        -> (per-job totals on the device, StageStats)."""
        return self._reduce(list(jobs), stats, psum=False)

    def _reduce(self, jobs, stats, psum: bool):
        self.validate(jobs)
        if stats is None:
            stats = StageStats(job="+".join(j.name for j in jobs))
        stats.engine = "device"
        stats.device = str(self.device)
        stats.codec = self.codec.name
        stats.n_items = self.n_rows
        stats.n_partitions = self.P
        stats.n_shards = _data_axis_size(self.mesh)
        stats.reduce_padded_ratio = self.sd.padded_ratio
        stats.shard_padded_ratio = _shard_ratios(self.shard_pad,
                                                 self.shard_real)
        meter = get_meter()
        mtok = meter.begin()
        totals = self.reduce_totals(tuple(j.reducer for j in jobs), stats,
                                    psum)
        meter.attribute(mtok, stats)
        return totals, stats


def _shuffle_mapped(partitioner: Partitioner, codec: ShuffleCodec, tile,
                    pad_value: float, m: MappedSplit, P: int,
                    stats: StageStats, device,
                    cost_basis: str = "pairs", mesh=None) -> ResidentCatalog:
    """Shuffle one mapped stream into device-resident tiers: count on the
    device (only the [P] counts reach the host), plan tiers, sort, scatter
    in wire dtype. Accumulates (``+=``) into ``stats``. Tier partition
    counts are padded to a multiple of the mesh's data axis size D with
    phantom (zero-count) partitions, so every tier splits evenly across
    shards; ``shard_pad``/``shard_real`` count each shard's padded and real
    pair cells.

    ``tile="auto"`` asks the cost model for the tile quantum AND the tier
    split minimizing the predicted reduce wall (``plan_shuffle``, with the
    reducers' ``cost_basis``) in place of the padded-cell count; the
    resolved tile lands in ``stats.auto_tile`` and
    ``ResidentCatalog.tile_resolved``. Under a mesh every rank plans
    alike: each holds the same counts and the mesh's one model
    (``agree_cost_model``, which the entry points call). Either way the
    predicted shuffle wall is recorded, so model error is observable per
    stage.

    ``keys == P`` marks a payload-only row: a border row carried only for
    the bucket entries of other partitions (a spilled range's read-back
    holds them, ``spill.py``). Like ``dest == P`` it is left out of the
    owned counts, and ``part_tier[P] == -1`` keeps it out of the scatter."""
    t0 = time.perf_counter()
    live = m.dest_eff < P            # drop border slots that replicate nowhere
    dest, src = m.dest_eff[live], m.src[live]
    n_owned = torch.bincount(m.keys.long(), minlength=P + 1)[:P].cpu().numpy()
    n_bucket = torch.bincount(dest.long(), minlength=P + 1)[:P].cpu().numpy()
    D = _data_axis_size(mesh)
    model = get_cost_model(device=device)
    tile_req = tile
    if _is_auto(tile):
        tile, plan, _ = model.plan_shuffle(n_owned, n_bucket, D, d=m.d,
                                           basis=cost_basis)
        stats.auto_tile = int(tile)
    else:
        plan = plan_tiers(n_owned, n_bucket, tile, pad_partitions_to=D)
    part_tier = np.full(P + 1, -1, np.int64)
    part_local = np.zeros(P + 1, np.int64)
    specs = []
    for t, (ids, C1, C2) in enumerate(plan):
        part_tier[ids] = t
        part_local[ids] = np.arange(len(ids))
        specs.append((_round_up(len(ids), D), C1, C2))
    o_starts = np.zeros(P + 1, np.int64)
    np.cumsum(n_owned, out=o_starts[1:])
    b_starts = np.zeros(P + 1, np.int64)
    np.cumsum(n_bucket, out=b_starts[1:])

    def dev(a):
        return torch.as_tensor(a, device=device)

    scattered = _scatter_tiers(m.payloads, m.keys, dest, src, m.skey,
                               dev(o_starts), dev(b_starts), dev(part_tier),
                               dev(part_local), specs)
    tiers = []
    shard_pad = np.zeros(D, np.float64)
    shard_real = np.zeros(D, np.float64)
    for ((ids, C1, C2), (Pt, _, _), (own, bkt)) in zip(plan, specs,
                                                       scattered):
        no_t = np.zeros(Pt, np.int64)
        nb_t = np.zeros(Pt, np.int64)
        no_t[:len(ids)] = n_owned[ids]
        nb_t[:len(ids)] = n_bucket[ids]
        tiers.append(TierData(ids, own, bkt, dev(no_t.astype(np.int32)),
                              dev(nb_t.astype(np.int32)), C1=C1, C2=C2,
                              Pt=Pt))
        shard_real += (no_t * nb_t).reshape(D, Pt // D).sum(axis=1)
        shard_pad += float(Pt // D) * C1 * C2
    sd = DeviceShuffledData(tiers, n_owned.astype(np.int64),
                            n_bucket.astype(np.int64), shard_pad, shard_real)
    _fence(device)
    t1 = time.perf_counter()
    stats.shuffle_wall_s += t1 - t0
    _trace("shuffle", t0, t1, engine="device")
    n_shuffled = int(n_bucket.sum())
    wire = n_shuffled * codec.device_bytes_per_item(m.d)
    stats.shuffle_wire_bytes += wire
    stats.shuffle_raw_bytes += 4 * n_shuffled * m.d
    # the reference's shuffle prediction: byte-bound, payload rows make ~3
    # passes and the index stream ~16 B a shuffled row
    stats.predicted_shuffle_wall_s += model.predict_wall(
        StageCost(flops=0.0, hbm_bytes=3.0 * wire + 16.0 * n_shuffled,
                  n_dispatch=len(plan) + 2))
    stats.n_items += m.n_rows
    stats.n_partitions = P
    stats.tiers = tuple((Pt, C1, C2) for Pt, C1, C2 in specs)
    stats.codec = codec.name
    stats.engine = "device"
    stats.device = str(device)
    stats.shuffle_index_impl = "torch"
    stats.n_shards = D
    return ResidentCatalog(partitioner, codec, tile_req, pad_value, sd, P,
                           device, n_rows=m.n_rows, d=m.d,
                           tile_resolved=int(tile), mesh=mesh)


def shuffle_once(partitioner: Partitioner, items, *, codec="identity",
                 tile: int | str = 256, pad_value: float = 0.0, device=None,
                 mesh=None, stats: StageStats = None) -> ResidentCatalog:
    """Map + shuffle a catalog ONCE into device-resident tiered wire-dtype
    partitions. The returned handle's ``run(jobs)`` serves any batch of
    signature-compatible jobs as a pure fused reduce (sharded over the
    ``data`` axis of ``mesh``, when given). The shuffle cost lands in
    ``stats`` (also kept as ``ResidentCatalog.load_stats``).
    ``codec="auto"`` and ``tile="auto"`` resolve through the cost model."""
    device = _entry_device(device, mesh)
    codec = get_codec(_concrete_codec(codec, device))
    if stats is None:
        stats = StageStats(job="shuffle_once")
    P = int(partitioner.n_partitions(items))
    meter = get_meter()
    mtok = meter.begin()
    m = map_timed(partitioner, codec, items, P, device, stats)
    stats.map_bytes += m.nbytes_in
    cat = _shuffle_mapped(partitioner, codec, tile, pad_value, m, P, stats,
                          device, mesh=mesh)
    meter.attribute(mtok, stats)
    cat.load_stats = stats
    return cat


def shuffle_reduce_device(jobs, m: MappedSplit, P: int, stats: StageStats,
                          device, mesh=None, psum: bool = True):
    """Shuffle + reduce one mapped stream: ``_shuffle_mapped`` followed by
    ``ResidentCatalog.reduce_totals`` (sharded over the ``data`` axis of
    ``mesh``, when given; ``psum=False`` leaves this rank's partials).
    Wall/byte stats accumulate (``+=``).
    -> (per-job totals, DeviceShuffledData)."""
    device = _entry_device(device, mesh)
    j0 = jobs[0]
    cat = _shuffle_mapped(j0.partitioner, get_codec(j0.codec), j0.tile,
                          j0.reducer.pad_value, m, P, stats, device,
                          cost_basis=j0.reducer.cost_basis, mesh=mesh)
    totals = cat.reduce_totals(tuple(j.reducer for j in jobs), stats, psum)
    return totals, cat.sd


def shuffle_reduce_device_streamed(jobs, ranges, P: int, stats: StageStats,
                                   device, mesh=None):
    """Shuffle + reduce an ENTRY STREAM of partition ranges: the external
    shuffle's read-back path. ``ranges`` yields ``(lo, hi, m)`` records
    covering disjoint ``[lo, hi)`` slices of the global partition space,
    where ``m`` is a ``MappedSplit`` whose ids are RANGE-LOCAL: keys in
    ``[0, hi-lo)`` for rows the range owns (``hi-lo`` marks payload-only
    border rows carried for bucket entries), ``dest_eff`` in ``[0, hi-lo]``.

    Each range runs the ordinary ``shuffle_reduce_device`` with
    ``P = hi - lo`` (peak resident wire bytes are one range's, not the
    catalog's) and per-job totals add across ranges (disjoint owned
    partitions + commutative integer sums, the contract that makes
    ``concat_mapped`` order-independent). Per-partition counts stitch into
    global ``[P]`` vectors so finalize corrections see the monolithic
    view; ``stats.tiers`` lists every range's tiers, one masked launch per
    reducer each.

    -> (per-job totals, StreamSummary over all ranges): the
    ``shuffle_reduce_device`` return shape with the summary standing in
    for ``DeviceShuffledData``."""
    totals = None
    n_owned = np.zeros(P, np.int64)
    n_bucket = np.zeros(P, np.int64)
    D = _data_axis_size(mesh)
    shard_pad = np.zeros(D, np.float64)
    shard_real = np.zeros(D, np.float64)
    pair_pad = pair_real = owned_cells = 0.0
    tiers = []
    for lo, hi, m in ranges:
        t, sd = shuffle_reduce_device(jobs, m, hi - lo, stats, device, mesh)
        totals = t if totals is None else tuple(
            a + b for a, b in zip(totals, t))
        n_owned[lo:hi] += sd.n_owned
        n_bucket[lo:hi] += sd.n_bucket
        pair_pad += sd.pair_cells
        pair_real += sd.real_pair_cells
        owned_cells += sd.owned_cells
        shard_pad += sd.shard_pad
        shard_real += sd.shard_real
        tiers.extend(stats.tiers)
    if totals is None:
        raise ValueError("shuffle_reduce_device_streamed: empty range "
                         "stream — the caller must supply at least one "
                         "range (an all-empty spill still reads one)")
    stats.n_partitions = P
    stats.tiers = tuple(tiers)
    summary = StreamSummary(n_owned, n_bucket, pair_cells=pair_pad,
                            owned_cells=owned_cells,
                            real_pair_cells=pair_real, shard_pad=shard_pad,
                            shard_real=shard_real)
    return totals, summary


# ---------------------------------------------------------------------------
# Host engine (oracle parity): numpy shuffle, one global capacity
# ---------------------------------------------------------------------------

def _host_items(items) -> np.ndarray:
    if isinstance(items, torch.Tensor):
        items = items.cpu().numpy()
    items = np.asarray(items)
    return items[:, None] if items.ndim == 1 else items


def stable_argsort(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """Stable argsort of keys in [0, n_keys). Below 2^16 keys they sort as
    uint16, which numpy sorts by radix in place of a merge sort."""
    if n_keys <= 1 << 16:
        keys = keys.astype(np.uint16)
    return np.argsort(keys, kind="stable")


def _records(x: np.ndarray) -> np.ndarray:
    """A C-contiguous [..., d] array as a flat array of d-value records,
    which numpy scatters as single items rather than rows of scalars."""
    d = x.shape[-1]
    return x.reshape(-1, d).view(np.dtype((np.void, x.itemsize * d))).ravel()


def _bucket_entries(partitioner: Partitioner, items, keys, P: int):
    """Every (destination, item) bucket entry: the owned items in index
    order, then the border copies in the order ``replicas`` yields them.
    Owned keys outside [0, P) own nothing (the JAX package drops them).
    -> (dest int64 [m], src int64 [m], number of owned entries)."""
    own = np.flatnonzero((keys >= 0) & (keys < P))
    copies = [(d, np.asarray(idx, np.int64))
              for d, idx in partitioner.replicas(items, keys, P)]
    to = np.array([d for d, _ in copies], np.int64)
    bad = (to < 0) | (to >= P)
    if bad.any():
        raise ValueError(f"replica destination {to[bad][0]} outside "
                         f"0..{P - 1}")
    dest = np.concatenate([keys[own].astype(np.int64),
                           np.repeat(to, [len(idx) for _, idx in copies])])
    src = np.concatenate([own, *(idx for _, idx in copies)])
    return dest, src, len(own)


def shuffle_stage(items, partitioner: Partitioner, codec="identity", *,
                  tile: int = 256, pad_partitions_to: int = 1,
                  pad_value: float = 0.0, stats: StageStats | None = None,
                  device=None) -> ShuffledData:
    """Map (assign + replicate) then shuffle (codec wire trip, pad, stack)
    -> ``ShuffledData``, the JAX package's arrays exactly, rows in the same
    order: partition k's bucket holds its owned items in index order, then
    its border copies in the order ``partitioner.replicas`` yields them.

    Buckets come from one stable argsort of the entries by destination
    (O(m log m), where the reference tests ``keys == k`` per partition).
    The codec round-trips the whole payload on ``device`` (int8: the
    quantize kernels on the card); exact codecs skip the trip.
    ``shuffle_wire_bytes`` comes from the static ``codec.nbytes``.

    ``codec="auto"`` resolves through the cost model; ``tile="auto"`` takes
    256 (the host engine's results do not depend on the tile: padding is
    masked, so there is nothing to plan)."""
    device = resolve_device(device)
    codec = get_codec(_concrete_codec(codec, device))
    if _is_auto(tile):
        tile = 256
    items = _host_items(items)
    stats = stats if stats is not None else StageStats()

    t0 = time.perf_counter()
    P = int(partitioner.n_partitions(items))
    keys = np.asarray(partitioner.assign(items))
    dest, src, n_own = _bucket_entries(partitioner, items, keys, P)
    t1 = time.perf_counter()
    stats.map_wall_s = t1 - t0
    stats.map_bytes = items.nbytes
    _trace("map", t0, t1, engine="host")

    t0 = time.perf_counter()
    x = torch.as_tensor(np.asarray(items, np.float32), device=device)
    decoded = codec.roundtrip(x).cpu().numpy()
    P_pad = _round_up(P, pad_partitions_to)
    d = items.shape[1]
    n_owned = np.bincount(dest[:n_own], minlength=P_pad)
    n_bucket = np.bincount(dest, minlength=P_pad)
    C1 = _round_up(int(n_owned.max()), tile)
    C2 = _round_up(int(n_bucket.max()), tile)
    order = stable_argsort(dest, P_pad)
    part = dest[order]
    starts = np.concatenate([[0], np.cumsum(n_bucket)])
    rank = np.arange(len(order)) - starts[part]
    rows = _records(np.take(decoded, src[order], axis=0))
    bucket = np.full((P_pad, C2, d), pad_value, np.float32)
    _records(bucket)[part * C2 + rank] = rows
    owned = np.full((P_pad, C1, d), pad_value, np.float32)
    first = rank < n_owned[part]        # a bucket starts with its owned rows
    _records(owned)[part[first] * C1 + rank[first]] = rows[first]
    sd = ShuffledData(owned=owned, bucket=bucket,
                      n_owned=n_owned.astype(np.int32),
                      n_bucket=n_bucket.astype(np.int32))
    t1 = time.perf_counter()
    stats.shuffle_wall_s = t1 - t0
    _trace("shuffle", t0, t1, engine="host")
    n_shuffled = int(sd.n_bucket.sum())
    stats.shuffle_wire_bytes = codec.nbytes(n_shuffled * d)
    stats.shuffle_raw_bytes = 4 * n_shuffled * d
    stats.n_items = len(items)
    stats.n_partitions = P_pad
    stats.codec = codec.name
    stats.engine = "host"
    stats.device = str(device)
    stats.shuffle_index_impl = "numpy"     # the host shuffle is all numpy
    return sd


def _reduce_rows(reducers, sd: ShuffledData, device, mesh):
    """This rank's share of the host engine's reduce: every reducer's
    ``per_partition_sum`` over all partitions, or under a data-axis mesh
    over its rows ``[s*P/D, (s+1)*P/D)``, the only ones moved to the
    device. -> tuple of per-reducer partials."""
    rows = slice(None)
    if _data_axis_size(mesh) > 1:
        if sd.owned.shape[0] % _data_axis_size(mesh):
            raise ValueError(f"{sd.owned.shape[0]} partitions do not split "
                             f"over {_data_axis_size(mesh)} shards: shuffle "
                             "with pad_partitions_to set to the data axis "
                             "size")
        rows = _shard_rows(sd.owned.shape[0], mesh)
    owned = torch.as_tensor(sd.owned[rows], device=device)
    bucket = torch.as_tensor(sd.bucket[rows], device=device)
    return tuple(r.per_partition_sum(owned, bucket) for r in reducers)


def reduce_stage(reducers, sd: ShuffledData, device=None, mesh=None):
    """Every reducer's ``per_partition_sum`` over the buckets, in ONE pass
    on ``device`` (multi-job batching), sharded over the ``data`` axis of
    ``mesh`` with an all-reduce of the partials when one is given.
    -> tuple of per-reducer totals (tensors on the device)."""
    device = resolve_device(device, mesh)
    outs = _reduce_rows(reducers, sd, device, mesh)
    if _data_axis_size(mesh) == 1:
        return outs
    return tuple(psum_1d(x, "data", mesh=mesh) for x in outs)


def host_shuffle_reduce(jobs, items, stats: StageStats, device=None,
                        mesh=None, psum: bool = True):
    """The host engine's shuffle + reduce for one item stream, the twin of
    ``shuffle_reduce_device``: walls and bytes accumulate (``+=``) into
    ``stats``. Under a data-axis mesh the partitions are padded to a
    multiple of its size and each rank reduces its rows (``psum=False``
    leaves this rank's partials). -> (per-job totals, ShuffledData)."""
    device = _entry_device(device, mesh)
    D = _data_axis_size(mesh)
    j0 = jobs[0]
    local = StageStats()
    sd = shuffle_stage(items, j0.partitioner, j0.codec, tile=j0.tile,
                       pad_partitions_to=D, pad_value=j0.reducer.pad_value,
                       stats=local, device=device)
    stats.map_wall_s += local.map_wall_s
    stats.map_bytes += local.map_bytes
    stats.shuffle_wall_s += local.shuffle_wall_s
    stats.shuffle_wire_bytes += local.shuffle_wire_bytes
    stats.shuffle_raw_bytes += local.shuffle_raw_bytes
    stats.n_items += local.n_items
    stats.n_partitions = local.n_partitions
    stats.codec = local.codec
    stats.engine = "host"
    stats.device = str(device)
    stats.shuffle_index_impl = local.shuffle_index_impl
    stats.tiers = ((sd.owned.shape[0], sd.owned.shape[1],
                    sd.bucket.shape[1]),)          # one global capacity
    stats.n_shards = D
    q = sd.owned.shape[0] // D
    sd.shard_real = (sd.n_owned.astype(np.float64)
                     * sd.n_bucket).reshape(D, q).sum(axis=1)
    sd.shard_pad = np.full(D, float(q) * sd.owned.shape[1]
                           * sd.bucket.shape[1])
    t0 = time.perf_counter()
    totals = _reduce_rows([j.reducer for j in jobs], sd, device, mesh)
    if D > 1 and psum:
        totals = _psum_partials(totals, mesh, device, stats)
    _fence(device)
    t1 = time.perf_counter()
    stats.reduce_wall_s += t1 - t0
    _trace("reduce", t0, t1, engine="host")
    stats.reduce_bytes += sd.owned.nbytes + sd.bucket.nbytes
    stats.reduce_flops += float(sum(j.reducer.flops(sd) for j in jobs))
    return totals, sd


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def shuffle_signature(job: MapReduceJob) -> tuple:
    """The (partitioner, codec name, tile, pad_value) key of a job's
    map+shuffle stages. Jobs sharing it can batch over ONE shuffle
    (``run_jobs``) or reduce against one ``ResidentCatalog``."""
    return (job.partitioner, get_codec(job.codec).name, job.tile,
            job.reducer.pad_value)


def group_batch_compatible(jobs) -> "list[list[MapReduceJob]]":
    """Partition ``jobs`` into the fewest groups that each share one shuffle
    signature (order preserved within a group): how the MR query service
    coalesces an admission window's requests into fused reduce passes."""
    groups: list[list[MapReduceJob]] = []
    sigs: list[tuple] = []
    for j in jobs:
        sig = shuffle_signature(j)
        for g, s in zip(groups, sigs):
            if s == sig:
                g.append(j)
                break
        else:
            groups.append([j])
            sigs.append(sig)
    return groups


def validate_batch(jobs) -> None:
    """Batched jobs must share one shuffle (partitioner/codec/tile/pad)."""
    j0 = jobs[0]
    c0 = get_codec(j0.codec)
    for j in jobs[1:]:
        diffs = [k for k, a, b in [
            ("partitioner", j.partitioner, j0.partitioner),
            ("codec", get_codec(j.codec).name, c0.name),
            ("tile", j.tile, j0.tile),
            ("pad_value", j.reducer.pad_value, j0.reducer.pad_value),
        ] if a != b]
        if diffs:
            raise ValueError(
                f"batched jobs must share one shuffle: {j.name!r} differs "
                f"from {j0.name!r} in {', '.join(diffs)}")


def run_jobs(jobs, items, *, mesh=None, engine: str = "auto", device=None,
             split_rows=None) -> list[JobResult]:
    """Execute several jobs that share partitioner/codec/tile through ONE
    map+shuffle and one fused reduce pass (e.g. Neighbor Searching and
    Neighbor Statistics over the same catalog cost a single data pass).

    This is the ONE-SPLIT case of the streaming executor
    (``mapreduce/executor.py``): the whole catalog is a single
    ``ArraySplits`` split, no combiner, no prefetch: the identical
    map/shuffle/reduce code path the executor runs per split, so streaming
    over N splits is bit-identical to this for exact codecs. ``engine`` is
    ``"device"`` (tiered masked reduce), ``"host"`` (numpy shuffle to one
    global capacity, unmasked reduce over every partition) or ``"auto"``
    (device); ``device=None`` means the card. Under a data-axis ``mesh``
    both engines shard the reduce over ``data`` (every rank calls this with
    the same arguments and gets the same results).
    -> one JobResult per job, sharing a single StageStats.

    ``split_rows``: ``None`` (default) runs the whole catalog as one split;
    an int streams it in row chunks of that size; ``"auto"`` asks the cost
    model for a chunk size that amortizes per-split dispatch overhead while
    bounding the working set. Streaming is bit-identical to monolithic for
    exact codecs, so this only changes shapes, never results."""
    from repro_torch.data.pipeline import ArraySplits
    from repro_torch.mapreduce.executor import run_jobs_streaming
    shape = np.shape(items)
    n_rows = shape[0]
    if _is_auto(split_rows):
        d = shape[1] if len(shape) > 1 else 1
        split_rows = get_cost_model(device=_entry_device(
            device, mesh)).choose_split_rows(n_rows, d=d)
    n_splits = (1 if split_rows is None
                else max(1, -(-n_rows // int(split_rows))))
    return run_jobs_streaming(jobs, ArraySplits(items, n_splits=n_splits),
                              mesh=mesh, engine=engine, combiner=None,
                              prefetch=0, device=device)


def run_job(job: MapReduceJob, items, *, mesh=None, engine: str = "auto",
            device=None, split_rows=None) -> JobResult:
    """Execute one job end-to-end. -> JobResult(output, stats)."""
    return run_jobs([job], items, mesh=mesh, engine=engine, device=device,
                    split_rows=split_rows)[0]
