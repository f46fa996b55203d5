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

from repro_torch.core.device import resolve_device
from repro_torch.mapreduce.codecs import ShuffleCodec, get_codec
from repro_torch.mapreduce.instrumentation import StageStats


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def _fence(device: torch.device) -> None:
    """Wait for the work queued on this thread's current stream, so a host
    clock reads device time. Only that stream: a device-wide synchronize
    would also wait for the prefetch thread's copies and the other lanes'
    stages, and charge them to this stage."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


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


@dataclasses.dataclass
class ShuffledData(_PaddingAccounting):
    """The host engine's post-shuffle state: every partition padded to one
    global capacity (numpy arrays, as the JAX package's)."""

    owned: np.ndarray          # [P, C1, d] f32 (pad_value-padded)
    bucket: np.ndarray         # [P, C2, d] owned + replicas (pad_value-padded)
    n_owned: np.ndarray        # [P] int32 real counts
    n_bucket: np.ndarray       # [P] int32 real counts

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

    @property
    def pair_cells(self) -> float:
        return float(sum(t.Pt * t.C1 * t.C2 for t in self.tiers))

    @property
    def owned_cells(self) -> float:
        return float(sum(t.Pt * t.C1 for t in self.tiers))


@dataclasses.dataclass
class MapReduceJob:
    """A named composition of the three pluggable stages."""

    name: str
    partitioner: Partitioner
    reducer: Reducer
    codec: str | ShuffleCodec = "identity"
    tile: int = 256            # capacity quantum (the paper's block size)


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
# Tier planning (numpy; the JAX package's default-cost search)
# ---------------------------------------------------------------------------

def plan_tiers(n_owned, n_bucket, tile: int):
    """Group partitions into <= 3 capacity size classes.

    One global capacity (the host engine's choice) is sized by the most
    skewed partition, so every partition pays the worst partition's padding
    — the fig3 ``bigger_blocks`` inversion. Tiers bound that: partitions are
    grouped by bucket capacity (rounded to the ``tile`` quantum) and each
    tier is padded only to ITS max. The <=2 split points are chosen by
    exact search over distinct capacities, minimizing total padded pair
    cells ``Pt * C1 * C2``.

    The search is a vectorized scan over the O(U^2) segment-cost table of
    unique capacities, with an early-exit bound: any prefix tier already
    costing >= the incumbent best prunes every deeper split under it.

    -> list of (part_ids ascending, C1, C2) per tier.
    """
    n_owned = np.asarray(n_owned, np.int64)
    n_bucket = np.asarray(n_bucket, np.int64)
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
    Pt = (pc[1:][None, :] - pc[:-1][:, None]).astype(np.float64)
    C1 = np.maximum(tile, -(-seg_max // tile) * tile).astype(np.float64)
    C2 = uniq.astype(np.float64)[None, :]
    S = np.where(col >= row, Pt * C1 * C2, np.inf)

    best_cost = float(S[0, U - 1])
    best_cuts = (U - 1,)
    if U >= 2:
        two = S[0, :U - 1] + S[1:, U - 1]
        c = int(np.argmin(two))          # first occurrence = lexicographic
        if two[c] < best_cost:
            best_cost, best_cuts = float(two[c]), (c, U - 1)
    if U >= 3:
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
                best_cuts = (c1, c2 + 1, U - 1)
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

    @property
    def padded_ratio(self) -> float:
        return (self.pair_cells / self.real_pair_cells
                if self.real_pair_cells else 1.0)


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


@dataclasses.dataclass
class ResidentCatalog:
    """Device-resident post-shuffle handle: a catalog mapped and shuffled
    ONCE into tiered wire-dtype partitions, plus the shuffle signature
    (partitioner / codec / tile / pad_value) that defines which jobs may
    reduce against it. ``run(jobs)`` serves any batch of compatible jobs as
    one fused reduce on the catalog's device."""

    partitioner: Partitioner
    codec: ShuffleCodec
    tile: int
    pad_value: float
    sd: DeviceShuffledData
    P: int
    device: torch.device
    n_rows: int = 0
    d: int = 0
    load_stats: StageStats = None      # the shuffle-once cost

    @property
    def nbytes(self) -> int:
        """Resident wire bytes held on the device across requests."""
        return sum(t.nbytes for t in self.sd.tiers)

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

    def reduce_totals(self, reducers, stats: StageStats):
        """Tiered masked reduce of ``reducers`` over the resident tiers:
        decode each tier on the device, one batched kernel call per reducer,
        sum over tiers. Accumulates (``+=``) into ``stats``. -> tuple of
        per-reducer totals (tensors on the device)."""
        t0 = time.perf_counter()
        totals = None
        for tier in self.sd.tiers:
            owned = self.codec.decode_device(*tier.owned_wire)
            bucket = self.codec.decode_device(*tier.bucket_wire)
            outs = tuple(r.reduce_partitions(owned, bucket, tier.n_owned,
                                             tier.n_bucket)
                         for r in reducers)
            totals = outs if totals is None else tuple(
                a + b for a, b in zip(totals, outs))
        _fence(self.device)
        stats.reduce_wall_s += time.perf_counter() - t0
        stats.reduce_bytes += self.nbytes
        stats.reduce_flops += float(sum(r.flops(self.sd) for r in reducers))
        return totals

    def run(self, jobs, stats: StageStats = None) -> "list[JobResult]":
        """Serve ``jobs`` (one or a batch) against the resident tiers with a
        single fused reduce pass: no map, no shuffle. -> one JobResult per
        job, sharing one StageStats whose map/shuffle walls are zero."""
        jobs = [jobs] if isinstance(jobs, MapReduceJob) else list(jobs)
        self.validate(jobs)
        if stats is None:
            stats = StageStats(job="+".join(j.name for j in jobs))
        stats.engine = "device"
        stats.device = str(self.device)
        stats.codec = self.codec.name
        stats.n_items = self.n_rows
        stats.n_partitions = self.P
        stats.reduce_padded_ratio = self.sd.padded_ratio
        totals = self.reduce_totals(tuple(j.reducer for j in jobs), stats)
        return [JobResult(j.reducer.finalize(t, self.sd), stats)
                for j, t in zip(jobs, totals)]


def _shuffle_mapped(partitioner: Partitioner, codec: ShuffleCodec, tile: int,
                    pad_value: float, m: MappedSplit, P: int,
                    stats: StageStats, device) -> ResidentCatalog:
    """Shuffle one mapped stream into device-resident tiers: count on the
    device (only the [P] counts reach the host), plan tiers, sort, scatter
    in wire dtype. Accumulates (``+=``) into ``stats``."""
    t0 = time.perf_counter()
    live = m.dest_eff < P            # drop border slots that replicate nowhere
    dest, src = m.dest_eff[live], m.src[live]
    n_owned = torch.bincount(m.keys.long(), minlength=P).cpu().numpy()
    n_bucket = torch.bincount(dest.long(), minlength=P).cpu().numpy()
    plan = plan_tiers(n_owned, n_bucket, tile)
    part_tier = np.full(P + 1, -1, np.int64)
    part_local = np.zeros(P + 1, np.int64)
    specs = []
    for t, (ids, C1, C2) in enumerate(plan):
        part_tier[ids] = t
        part_local[ids] = np.arange(len(ids))
        specs.append((len(ids), C1, C2))
    o_starts = np.zeros(P + 1, np.int64)
    np.cumsum(n_owned, out=o_starts[1:])
    b_starts = np.zeros(P + 1, np.int64)
    np.cumsum(n_bucket, out=b_starts[1:])

    def dev(a):
        return torch.as_tensor(a, device=device)

    scattered = _scatter_tiers(m.payloads, m.keys, dest, src, m.skey,
                               dev(o_starts), dev(b_starts), dev(part_tier),
                               dev(part_local), specs)
    tiers = [TierData(ids, own, bkt,
                      dev(n_owned[ids].astype(np.int32)),
                      dev(n_bucket[ids].astype(np.int32)),
                      C1=C1, C2=C2, Pt=len(ids))
             for (ids, C1, C2), (own, bkt) in zip(plan, scattered)]
    sd = DeviceShuffledData(tiers, n_owned.astype(np.int64),
                            n_bucket.astype(np.int64))
    _fence(device)
    stats.shuffle_wall_s += time.perf_counter() - t0
    n_shuffled = int(n_bucket.sum())
    stats.shuffle_wire_bytes += n_shuffled * codec.device_bytes_per_item(m.d)
    stats.shuffle_raw_bytes += 4 * n_shuffled * m.d
    stats.n_items += m.n_rows
    stats.n_partitions = P
    stats.tiers = tuple((Pt, C1, C2) for Pt, C1, C2 in specs)
    stats.codec = codec.name
    stats.engine = "device"
    stats.device = str(device)
    stats.shuffle_index_impl = "torch"
    return ResidentCatalog(partitioner, codec, tile, pad_value, sd, P,
                           device, n_rows=m.n_rows, d=m.d)


def _require_concrete(codec, tile) -> None:
    """Refuse what this engine does not run yet, naming the ROADMAP item
    that brings it."""
    if isinstance(codec, str) and codec == "auto":
        raise NotImplementedError(
            "codec='auto' needs the cost model (ROADMAP queue 1 item 7, "
            "observability and planning); name a codec")
    if tile == "auto":
        raise NotImplementedError(
            "tile='auto' needs the cost model (ROADMAP queue 1 item 7, "
            "observability and planning); give an integer tile")


def shuffle_once(partitioner: Partitioner, items, *, codec="identity",
                 tile: int = 256, pad_value: float = 0.0, device=None,
                 stats: StageStats = None) -> ResidentCatalog:
    """Map + shuffle a catalog ONCE into device-resident tiered wire-dtype
    partitions. The returned handle's ``run(jobs)`` serves any batch of
    signature-compatible jobs as a pure fused reduce. The shuffle cost lands
    in ``stats`` (also kept as ``ResidentCatalog.load_stats``)."""
    _require_concrete(codec, tile)
    device = resolve_device(device)
    codec = get_codec(codec)
    if stats is None:
        stats = StageStats(job="shuffle_once")
    P = int(partitioner.n_partitions(items))
    t0 = time.perf_counter()
    m = map_split_device(partitioner, codec, items, P, device)
    _fence(device)
    stats.map_wall_s += time.perf_counter() - t0
    stats.map_bytes += m.nbytes_in
    cat = _shuffle_mapped(partitioner, codec, tile, pad_value, m, P, stats,
                          device)
    cat.load_stats = stats
    return cat


def shuffle_reduce_device(jobs, m: MappedSplit, P: int, stats: StageStats,
                          device):
    """Shuffle + reduce one mapped stream: ``_shuffle_mapped`` followed by
    ``ResidentCatalog.reduce_totals``. Wall/byte stats accumulate (``+=``).
    -> (per-job totals, DeviceShuffledData)."""
    j0 = jobs[0]
    cat = _shuffle_mapped(j0.partitioner, get_codec(j0.codec), j0.tile,
                          j0.reducer.pad_value, m, P, stats, device)
    totals = cat.reduce_totals(tuple(j.reducer for j in jobs), stats)
    return totals, cat.sd


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
    ``shuffle_wire_bytes`` comes from the static ``codec.nbytes``."""
    _require_concrete(codec, tile)
    device = resolve_device(device)
    codec = get_codec(codec)
    items = _host_items(items)
    stats = stats if stats is not None else StageStats()

    t0 = time.perf_counter()
    P = int(partitioner.n_partitions(items))
    keys = np.asarray(partitioner.assign(items))
    dest, src, n_own = _bucket_entries(partitioner, items, keys, P)
    stats.map_wall_s = time.perf_counter() - t0
    stats.map_bytes = items.nbytes

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
    stats.shuffle_wall_s = time.perf_counter() - t0
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


def reduce_stage(reducers, sd: ShuffledData, device=None):
    """Every reducer's ``per_partition_sum`` over the buckets, in ONE pass
    on ``device`` (multi-job batching). -> tuple of per-reducer totals
    (tensors on the device)."""
    device = resolve_device(device)
    owned = torch.as_tensor(sd.owned, device=device)
    bucket = torch.as_tensor(sd.bucket, device=device)
    return tuple(r.per_partition_sum(owned, bucket) for r in reducers)


def host_shuffle_reduce(jobs, items, stats: StageStats, device=None):
    """The host engine's shuffle + reduce for one item stream, the twin of
    ``shuffle_reduce_device``: walls and bytes accumulate (``+=``) into
    ``stats``. -> (per-job totals, ShuffledData)."""
    device = resolve_device(device)
    j0 = jobs[0]
    local = StageStats()
    sd = shuffle_stage(items, j0.partitioner, j0.codec, tile=j0.tile,
                       pad_value=j0.reducer.pad_value, stats=local,
                       device=device)
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
    t0 = time.perf_counter()
    totals = reduce_stage([j.reducer for j in jobs], sd, device)
    _fence(device)
    stats.reduce_wall_s += time.perf_counter() - t0
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


def run_jobs(jobs, items, *, engine: str = "auto",
             device=None) -> list[JobResult]:
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
    (device); ``device=None`` means the card.
    -> one JobResult per job, sharing a single StageStats."""
    from repro_torch.data.pipeline import ArraySplits
    from repro_torch.mapreduce.executor import run_jobs_streaming
    return run_jobs_streaming(jobs, ArraySplits(items, n_splits=1),
                              engine=engine, combiner=None, prefetch=0,
                              device=device)


def run_job(job: MapReduceJob, items, *, engine: str = "auto",
            device=None) -> JobResult:
    """Execute one job end-to-end. -> JobResult(output, stats)."""
    return run_jobs([job], items, engine=engine, device=device)[0]
