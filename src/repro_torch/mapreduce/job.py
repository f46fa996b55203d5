"""Composable MapReduce jobs on PyTorch: the device engine.

The port of the device half of ``repro.mapreduce.job``. A job composes
three pluggable stages,

- ``Partitioner``   (map): key assignment + border-replication policy,
- ``ShuffleCodec``  (shuffle): wire format, by registry name (``codecs.py``),
- ``Reducer``       (reduce): masked batched kernel + host-side finalize,

and the engine runs them as tensor ops on one device:

1. map: partition keys and the (owned + border copy) bucket-entry stream,
   payload encoded straight to the codec's wire dtype;
2. shuffle: per-partition counts, ``plan_tiers`` groups partitions into at
   most 3 capacity tiers, and a stable sort by (destination, sort key)
   scatters the wire rows into each tier's padded ``[Pt, C, ...]`` layout;
3. reduce: per tier, decode on the device and one masked batched kernel
   launch per reducer (``kernels/zones_pairs``: CUDA kernels on the card,
   plain PyTorch on the CPU);
4. finalize on the host.

Entry points (``run_jobs``, ``run_job``, ``shuffle_once``) take
``device=None``, which means ``"cuda"``: with no card and no explicit
``device="cpu"`` they raise instead of quietly running on the CPU.

    part = ZonePartitioner(radius)
    jobs = [neighbor_search_job(radius, partitioner=part),
            neighbor_statistics_job(partitioner=part)]
    results = run_jobs(jobs, xyz)                  # on the card
    results = run_jobs(jobs, xyz, device="cpu")    # plain versions
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.mapreduce.codecs import ShuffleCodec, get_codec
from repro_torch.mapreduce.instrumentation import StageStats


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raise when the card is asked for and absent:
    the engine never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless asked otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


def _fence(device: torch.device) -> None:
    """Wait for the device, so a host clock reads device time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
        """Yield (dest_partition, item_index_array) border copies (host)."""
        raise NotImplementedError

    # -- device hooks: the map stage as tensor ops ------------------------

    def assign_device(self, items: torch.Tensor) -> torch.Tensor:
        """Tensor version of ``assign`` ([n, d] -> [n] int32)."""
        raise NotImplementedError

    def sort_key_device(self, items: torch.Tensor):
        """Optional [n] secondary sort key: rows within a partition land in
        this order. Order never affects results (partition reductions are
        commutative sums), so ``None`` (arrival order) is always correct."""
        return None

    def bucket_entries_device(self, items, keys, n_parts: int):
        """-> (dest [m] int32, src [m] int32, valid [m] bool): every
        (partition, item) bucket entry, owned points plus border copies."""
        raise NotImplementedError


class Reducer:
    """Reduce stage: a masked batched kernel over a size tier plus a
    host-side ``finalize``. Tier results are combined by summation."""

    pad_value: float = 0.0   # part of the shuffle signature

    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        """Batched reduce over a whole size tier: [P, C1, d], [P, C2, d] +
        [P] real counts -> the partition-summed result. Rows at index >=
        count are capacity padding and MUST not contribute."""
        raise NotImplementedError

    def finalize(self, total, sd: "DeviceShuffledData"):
        """Host-side post-combine (dedup corrections, differencing, ...)."""
        return total.cpu().numpy()

    def flops(self, sd: "DeviceShuffledData") -> float:
        """Estimated reduce-stage FLOPs, for StageStats accounting."""
        return 0.0


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


@dataclasses.dataclass
class DeviceShuffledData:
    """Post-shuffle state: wire-dtype payloads grouped into capacity tiers.
    ``n_owned``/``n_bucket`` are the global per-partition real counts
    (host arrays) that reducer ``finalize`` hooks read."""

    tiers: list
    n_owned: np.ndarray        # [P] int64 (host)
    n_bucket: np.ndarray       # [P] int64 (host)

    @property
    def pair_cells(self) -> float:
        """Total padded (owned x bucket) cells the reduce kernels cover."""
        return float(sum(t.Pt * t.C1 * t.C2 for t in self.tiers))

    @property
    def real_pair_cells(self) -> float:
        no = np.asarray(self.n_owned, np.float64)
        nb = np.asarray(self.n_bucket, np.float64)
        return float(np.sum(no * nb))

    @property
    def padded_ratio(self) -> float:
        real = self.real_pair_cells
        return self.pair_cells / real if real else 1.0


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
    """Device-resident output of the map stage: the codec wire payload plus
    the bucket-entry index metadata."""

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

    The one-split case of the JAX package's streaming executor: map,
    shuffle and reduce once, then ``finalize``. ``engine`` is ``"auto"`` or
    ``"device"``; ``device=None`` means the card.
    -> one JobResult per job, sharing a single StageStats."""
    if not jobs:
        return []
    if engine == "host":
        raise NotImplementedError(
            "engine='host' is not ported yet (ROADMAP queue 1 item 3, "
            "wordcount and the host engine)")
    if engine not in ("auto", "device"):
        raise ValueError(f"unknown engine {engine!r}; expected 'auto' or "
                         "'device'")
    for j in jobs:
        _require_concrete(j.codec, j.tile)
    validate_batch(jobs)
    device = resolve_device(device)
    j0 = jobs[0]
    codec = get_codec(j0.codec)
    stats = StageStats(job="+".join(j.name for j in jobs), engine="device",
                       codec=codec.name, device=str(device))
    P = int(j0.partitioner.n_partitions(items))
    t0 = time.perf_counter()
    m = map_split_device(j0.partitioner, codec, items, P, device)
    _fence(device)
    stats.map_wall_s += time.perf_counter() - t0
    stats.map_bytes += m.nbytes_in
    totals, sd = shuffle_reduce_device(jobs, m, P, stats, device)
    stats.reduce_padded_ratio = sd.padded_ratio
    return [JobResult(j.reducer.finalize(t, sd), stats)
            for j, t in zip(jobs, totals)]


def run_job(job: MapReduceJob, items, *, engine: str = "auto",
            device=None) -> JobResult:
    """Execute one job end-to-end. -> JobResult(output, stats)."""
    return run_jobs([job], items, engine=engine, device=device)[0]
