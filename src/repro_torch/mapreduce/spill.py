"""External shuffle spill tier: disk-backed wire-dtype segment store.

The port of ``repro.mapreduce.spill``. Segments are written from numpy
arrays (``mapped_to_host`` brings a mapped split off the card), in the
reference's format byte for byte, so a segment either package writes loads
in the other.

Hadoop's map tasks spill sorted partition runs to local disk and the reduce
side merges the runs per partition — that external shuffle is what lets the
paper's low-power nodes trade scarce memory for cheap sequential disk I/O.
This module is that tier for the device engine's accumulate mode: when the
streaming executor's accumulated ``MappedSplit`` wire streams exceed the
spill budget, it hands them here.

Layout — **partitioned at write time**. A flushed chunk (one or more mapped
splits) is cut into one segment file per partition RANGE ``[lo, hi)`` (the
store's ``bounds``). A range's segment carries exactly the sub-stream the
final reduce of those partitions needs:

- the payload wire rows referenced by the range: rows OWNED by a partition
  in ``[lo, hi)`` plus border rows referenced only by bucket entries
  destined there. Per-row local keys are ``key - lo`` for owned rows and
  the sentinel ``hi - lo`` for payload-only border rows (the shuffle's
  existing ``dest == P`` invalid-marker convention, applied to keys);
- the bucket entries destined to the range (``dest - lo``, source indices
  remapped into the segment's local row space).

Read-back (``read_range``) merges every committed chunk's segment for one
range into a single range-local entry stream — the ``concat_mapped`` source
offset trick on disk — which ``shuffle_reduce_device_streamed`` reduces with
``P = hi - lo``. Peak resident wire bytes are one range's, not the catalog's.

Crash safety — **finalize-rename**. Segments are staged as
``*.staged-<tag>`` and atomically ``os.replace``d to their final
``chunk<k>-range<z>.seg`` names only at commit (under the caller's commit
lock in lane mode, so a clone that loses the commit race leaves only staged
litter, swept later). A writer killed mid-stage leaves a truncated staged
file that can never be read as valid data: reads validate the byte length
against the header and raise ``ValueError`` naming the path and remainder —
the same refusal ``MemmapCatalogSplits`` applies to truncated catalogs.

Segment format: ``b"SPL1"`` magic, little-endian uint32 header length, a
JSON header (``lo``/``hi``/``d``/``rows``/``entries`` plus per-field name/
dtype/shape), then the raw field bytes concatenated in header order.

The async write path (``submit_chunk``) runs staging+commit on a
``Prefetcher`` worker thread so spill I/O hides under map compute; its
shutdown uses the prefetcher's drain-before-stop path, so a finalized chunk
handed to the writer is never dropped by a racing ``stop()``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import queue
import shutil
import struct
import threading
import time

import numpy as np

from repro_torch.data.pipeline import Prefetcher
from repro_torch.mapreduce.job import MappedSplit
from repro_torch.obs.trace import get_tracer

_MAGIC = b"SPL1"


@dataclasses.dataclass
class SpillConfig:
    """Executor-facing spill knobs.

    ``budget_bytes``: resident wire-byte budget for accumulated mapped
    streams. ``None`` or ``inf`` disables spilling (today's behavior);
    ``0`` spills every split. ``dir``: spill root (a fresh temp dir when
    None; always reclaimed on close). ``n_ranges``: read-back partition
    range count (None = sized so a range's wire bytes fit well inside the
    budget, capped at ``max_ranges``; ``"auto"`` = the cost model's
    ``choose_spill_ranges``). ``write_fault``:
    chaos hook ``f(path)`` invoked mid-segment-write (fault injection)."""

    budget_bytes: float | None = None
    dir: str | None = None
    n_ranges: int | str | None = None
    max_ranges: int = 256
    write_fault: object = None

    @property
    def enabled(self) -> bool:
        return (self.budget_bytes is not None
                and math.isfinite(self.budget_bytes))


@dataclasses.dataclass
class SpilledChunk:
    """A staged (not yet committed) chunk: one ``*.staged-<tag>`` segment
    file per partition range. Commit renames all of them atomically-enough
    (per-file ``os.replace`` under the store lock); discard unlinks them."""

    tag: str
    paths: list                 # [(z, staged_path)] for every range z
    nbytes: int                 # field bytes across all segments
    n_splits: int               # mapped splits folded into this chunk


def _to_numpy(x) -> np.ndarray:
    # Tensor.cpu() of a CUDA tensor copies on the CURRENT stream and waits
    # for that stream only, so a lane waits for its own work, not others'
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def mapped_to_host(m: MappedSplit) -> MappedSplit:
    """``MappedSplit`` of tensors -> host numpy twin (blocks until the
    current stream's work on them is done; the device buffers become
    reclaimable once the caller drops its reference)."""
    return MappedSplit(
        payloads=tuple(_to_numpy(p) for p in m.payloads),
        keys=_to_numpy(m.keys),
        dest_eff=_to_numpy(m.dest_eff),
        src=_to_numpy(m.src),
        skey=None if m.skey is None else _to_numpy(m.skey),
        n_rows=m.n_rows, d=m.d, nbytes_in=m.nbytes_in)


def mapped_wire_nbytes(m: MappedSplit) -> int:
    """Resident wire bytes of one mapped stream (payload + index metadata;
    numpy arrays or tensors) — the quantity the spill budget bounds."""
    n = sum(int(p.nbytes) for p in m.payloads)
    n += int(m.keys.nbytes) + int(m.dest_eff.nbytes) + int(m.src.nbytes)
    if m.skey is not None:
        n += int(m.skey.nbytes)
    return n


def plan_bounds(weights, n_ranges: int) -> np.ndarray:
    """Byte-weighted partition-range boundaries: cut ``[0, P)`` into up to
    ``n_ranges`` contiguous ranges of near-equal total weight (per-partition
    bucket bytes/counts), so each read-back range costs about the same
    resident memory. -> strictly increasing int64 bounds, ``[0, ..., P]``."""
    w = np.clip(np.asarray(weights, np.float64), 0, None)
    P = len(w)
    Z = max(1, min(int(n_ranges), P))
    if Z == 1 or w.sum() <= 0:
        cuts = np.linspace(0, P, Z + 1).round().astype(np.int64)
    else:
        cum = np.cumsum(w)
        targets = cum[-1] * np.arange(1, Z, dtype=np.float64) / Z
        inner = np.searchsorted(cum, targets, side="left") + 1
        cuts = np.concatenate([[0], np.clip(inner, 1, P), [P]])
    return np.unique(cuts).astype(np.int64)


class _WriterShutdown(Exception):
    """Internal: terminates the async writer's produce loop."""


class SpillStore:
    """Partition-range-bucketed spill segment store for one streaming run.

    Write side: ``stage_chunk`` (synchronous; lanes call it from their own
    thread) + ``commit_chunk`` / ``discard_chunk`` (the lane-safe
    finalize-rename), or ``submit_chunk`` + ``wait_writes`` (the sequential
    executor's async double-buffered path). Read side: ``read_range(z)``
    merges every committed chunk's segment for range ``z``. ``close()``
    shuts the writer down via the prefetcher drain path and reclaims the
    spill directory — call it success or failure (the executor wraps the
    run in try/finally).
    """

    def __init__(self, root: str, P: int, *, write_fault=None,
                 on_written=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.P = int(P)
        self.write_fault = write_fault
        self.on_written = on_written      # f(SpilledChunk) after async commit
        self._bounds: np.ndarray | None = None
        self._lock = threading.Lock()
        self._n_committed = 0
        self._n_tagged = 0
        self.bytes_written = 0
        self.write_wall_s = 0.0
        self.max_chunk_bytes = 0
        self._wq: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._write_error: BaseException | None = None
        self._writer: Prefetcher | None = None
        self._n_submitted = 0
        self._n_collected = 0

    # -- bounds ------------------------------------------------------------

    def set_bounds(self, bounds) -> None:
        b = np.asarray(bounds, np.int64)
        if (len(b) < 2 or b[0] != 0 or b[-1] != self.P
                or not (np.diff(b) > 0).all()):
            raise ValueError(f"invalid range bounds {b.tolist()!r} for "
                             f"P={self.P}: need strictly increasing "
                             f"[0, ..., P]")
        if self._bounds is not None:
            raise RuntimeError("range bounds already set — segments on disk "
                               "are partitioned by them")
        self._bounds = b

    @property
    def bounds(self) -> np.ndarray:
        if self._bounds is None:
            raise RuntimeError("SpillStore bounds not set — call "
                               "set_bounds/plan_bounds before staging")
        return self._bounds

    @property
    def n_ranges(self) -> int:
        return len(self.bounds) - 1

    @property
    def n_chunks(self) -> int:
        return self._n_committed

    def next_tag(self) -> str:
        with self._lock:
            t = self._n_tagged
            self._n_tagged += 1
        return f"t{t}"

    # -- write side --------------------------------------------------------

    def _seg_path(self, cid: int, z: int) -> str:
        return os.path.join(self.root, f"chunk{cid:05d}-range{z:04d}.seg")

    def stage_chunk(self, recs, tag: str) -> SpilledChunk:
        """Cut host mapped splits ``recs`` into one staged segment per
        partition range. Every range gets a segment (possibly zero-row) so
        read-back always finds dtype/shape metadata. Crash mid-call leaves
        only ``*.staged-<tag>`` litter — nothing committed."""
        recs = list(recs)
        if not recs:
            raise ValueError("stage_chunk needs at least one mapped split")
        bounds = self.bounds
        paths, nbytes = [], 0
        # one spill-write span per staged chunk, on whichever thread writes
        # (a lane staging its own split, or the store's async writer)
        with get_tracer().span("spill-write", cat="io", tag=tag,
                               n_splits=len(recs)):
            for z in range(len(bounds) - 1):
                lo, hi = int(bounds[z]), int(bounds[z + 1])
                path = self._seg_path(0, z) + f".staged-{tag}"
                nbytes += _write_segment(path, recs, lo, hi,
                                         write_fault=self.write_fault)
                paths.append((z, path))
        return SpilledChunk(tag=tag, paths=paths, nbytes=nbytes,
                            n_splits=len(recs))

    def commit_chunk(self, chunk: SpilledChunk) -> int:
        """Finalize-rename a staged chunk under the store lock (lane commit
        runs this inside the pool's commit section: first finisher renames,
        the loser's staged files stay staged and are swept). -> chunk id."""
        with self._lock:
            cid = self._n_committed
            for z, staged in chunk.paths:
                os.replace(staged, self._seg_path(cid, z))
            self._n_committed += 1
            self.bytes_written += chunk.nbytes
            self.max_chunk_bytes = max(self.max_chunk_bytes, chunk.nbytes)
        return cid

    def discard_chunk(self, chunk: SpilledChunk) -> None:
        for _, staged in chunk.paths:
            with contextlib.suppress(OSError):
                os.unlink(staged)

    def sweep_staged(self) -> int:
        """Unlink every leftover staged segment (cancelled clones, faulted
        writers). -> count removed."""
        n = 0
        for name in os.listdir(self.root):
            if ".staged-" in name:
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(self.root, name))
                    n += 1
        return n

    # -- async writer (sequential executor's double buffer) ----------------

    def submit_chunk(self, recs) -> None:
        """Queue host mapped splits for background stage+commit. At most
        one submission should be in flight (callers ``wait_writes`` before
        the next) — that is what bounds peak resident bytes."""
        if self._writer is None:
            self._writer = Prefetcher(self._write_next, depth=8).start()
        self._n_submitted += 1
        self._wq.put(list(recs))

    def _write_next(self, k: int):
        while True:
            try:
                req = self._wq.get(timeout=0.1)
                break
            except queue.Empty:
                if self._closed.is_set():
                    raise _WriterShutdown()
        if req is None:                    # close() sentinel
            self._wq.task_done()
            raise _WriterShutdown()
        t0 = time.perf_counter()
        try:
            chunk = self.stage_chunk(req, f"async{k}")
            self.commit_chunk(chunk)
            if self.on_written is not None:
                self.on_written(chunk)
            return chunk
        except BaseException as e:         # surfaced by wait_writes
            self._write_error = e
            return None
        finally:
            self.write_wall_s += time.perf_counter() - t0
            self._wq.task_done()

    def wait_writes(self) -> None:
        """Block until every submitted chunk is staged+committed; re-raise
        the first writer error (the chunk that failed stays uncommitted).

        Each write leaves one record in the writer's ``Prefetcher`` queue;
        they are taken here. Left there, the ninth would fill the queue
        (depth 8), the worker would block handing it off, and the next
        ``join`` would wait forever."""
        self._wq.join()
        while self._n_collected < self._n_submitted:
            self._writer.get()
            self._n_collected += 1
        if self._write_error is not None:
            e, self._write_error = self._write_error, None
            raise e

    # -- read side ---------------------------------------------------------

    def range_bounds(self, z: int) -> tuple:
        b = self.bounds
        return int(b[z]), int(b[z + 1])

    def range_segment_paths(self, z: int) -> list:
        return [self._seg_path(cid, z) for cid in range(self._n_committed)]

    def read_range(self, z: int) -> dict:
        """Merge every committed chunk's segment for range ``z`` into one
        range-local entry stream (source indices offset per segment, the
        ``concat_mapped`` trick). Validates each segment's byte length and
        refuses truncated files. -> record dict with ``lo``/``hi``, host
        wire ``payloads``, local ``keys``/``dest_eff``/``src``, ``skey``,
        ``d`` and ``n_rows``."""
        lo, hi = self.range_bounds(z)
        if self._n_committed == 0:
            raise ValueError("read_range on a store with no committed "
                             "chunks")
        segs = [_read_segment(p, expect_lo=lo, expect_hi=hi)
                for p in self.range_segment_paths(z)]
        pnames = [f[0] for f in segs[0]["fields"] if f[0].startswith("p")]
        has_skey = any(f[0] == "skey" for f in segs[0]["fields"])
        pls = [[] for _ in pnames]
        keys, dest, src, skeys = [], [], [], []
        row_off = 0
        for s in segs:
            for i, name in enumerate(pnames):
                pls[i].append(s["data"][name])
            keys.append(s["data"]["keys"])
            dest.append(s["data"]["dest"])
            src.append(s["data"]["src"] + np.int32(row_off))
            if has_skey:
                skeys.append(s["data"]["skey"])
            row_off += int(s["rows"])
        return {
            "lo": lo, "hi": hi,
            "payloads": tuple(np.concatenate(p) for p in pls),
            "keys": np.concatenate(keys),
            "dest_eff": np.concatenate(dest),
            "src": np.concatenate(src),
            "skey": np.concatenate(skeys) if has_skey else None,
            "d": int(segs[0]["d"]),
            "n_rows": row_off,
        }

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Drain-stop the async writer and reclaim the spill directory.
        Safe to call multiple times and after failures."""
        try:
            if self._writer is not None:
                with contextlib.suppress(BaseException):
                    self._wq.join()
                self._closed.set()
                self._wq.put(None)
                self._writer.stop(drain=True)
                self._writer = None
        finally:
            shutil.rmtree(self.root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Segment file I/O
# ---------------------------------------------------------------------------

def _range_selections(recs, lo: int, hi: int):
    """Per-rec selection metadata for one partition range: selected payload
    row indices, range-local keys (``hi-lo`` marks payload-only border
    rows), and the range's bucket entries remapped into the chunk's local
    row space (offsets accumulate across recs)."""
    span = hi - lo
    outs, row_off = [], 0
    for m in recs:
        keys, dest, src = m.keys, m.dest_eff, m.src
        own = (keys >= lo) & (keys < hi)
        ent = (dest >= lo) & (dest < hi)       # dest == P never lands here
        need = own.copy()
        if ent.any():
            need[src[ent]] = True
        sel = np.flatnonzero(need)
        remap = np.full(keys.shape[0], -1, np.int32)
        remap[sel] = np.arange(len(sel), dtype=np.int32)
        keys_local = np.where(own[sel], keys[sel] - lo,
                              span).astype(np.int32)
        dest_local = (dest[ent] - lo).astype(np.int32)
        src_local = (remap[src[ent]] + row_off).astype(np.int32)
        outs.append((sel, keys_local, dest_local, src_local))
        row_off += len(sel)
    return outs


def _write_segment(path: str, recs, lo: int, hi: int,
                   write_fault=None) -> int:
    """Write one range segment for a chunk of mapped splits. Returns field
    bytes written. ``write_fault(path)`` fires mid-write (after the header
    and payload, before the index fields) so injected faults leave a
    length-invalid file, exactly what a real crash leaves."""
    sels = _range_selections(recs, lo, hi)
    n_rows = sum(len(s[0]) for s in sels)
    n_entries = sum(len(s[2]) for s in sels)
    p0 = recs[0].payloads
    has_skey = recs[0].skey is not None
    fields = [(f"p{i}", np.dtype(p.dtype).str,
               (n_rows,) + tuple(p.shape[1:])) for i, p in enumerate(p0)]
    fields += [("keys", "<i4", (n_rows,)), ("dest", "<i4", (n_entries,)),
               ("src", "<i4", (n_entries,))]
    if has_skey:
        fields.append(("skey", np.dtype(recs[0].skey.dtype).str, (n_rows,)))
    header = {"lo": int(lo), "hi": int(hi), "d": int(recs[0].d),
              "rows": int(n_rows), "entries": int(n_entries),
              "fields": [[n, dt, list(sh)] for n, dt, sh in fields]}
    hb = json.dumps(header).encode()
    nbytes = 0
    with open(path, "wb") as f:
        f.write(_MAGIC + struct.pack("<I", len(hb)) + hb)

        def emit(arr):
            nonlocal nbytes
            a = np.ascontiguousarray(arr)
            f.write(a.tobytes())
            nbytes += a.nbytes

        for i in range(len(p0)):
            for m, (sel, _, _, _) in zip(recs, sels):
                emit(np.asarray(m.payloads[i])[sel])
        for _, kl, _, _ in sels:
            emit(kl)
        if write_fault is not None:
            write_fault(path)
        for _, _, dl, _ in sels:
            emit(dl)
        for _, _, _, sl in sels:
            emit(sl)
        if has_skey:
            for m, (sel, _, _, _) in zip(recs, sels):
                emit(np.asarray(m.skey)[sel])
    return nbytes


def _read_segment(path: str, expect_lo: int | None = None,
                  expect_hi: int | None = None) -> dict:
    """Parse + validate one segment file. The byte length must match the
    header exactly; a crash-truncated segment raises ``ValueError`` naming
    the path and remainder instead of silently reading short."""
    with open(path, "rb") as f:
        buf = f.read()
    size = len(buf)
    if size < 8 or buf[:4] != _MAGIC:
        raise ValueError(f"spilled segment {path!r}: missing/invalid magic "
                         f"({size} bytes) — truncated or corrupt")
    (hlen,) = struct.unpack("<I", buf[4:8])
    if size < 8 + hlen:
        raise ValueError(f"spilled segment {path!r}: header truncated "
                         f"({size} bytes, header claims {hlen})")
    header = json.loads(buf[8:8 + hlen])
    fields = header["fields"]
    expected = sum(int(np.dtype(dt).itemsize) * int(np.prod(sh))
                   for _, dt, sh in fields)
    rem = size - 8 - hlen - expected
    if rem != 0:
        raise ValueError(
            f"spilled segment {path!r} is {size} bytes, expected "
            f"{8 + hlen + expected} ({rem:+d} byte remainder) — truncated "
            f"or corrupt; refusing to silently read a shorter stream")
    if expect_lo is not None and (header["lo"] != expect_lo
                                  or header["hi"] != expect_hi):
        raise ValueError(f"spilled segment {path!r} covers partitions "
                         f"[{header['lo']}, {header['hi']}), expected "
                         f"[{expect_lo}, {expect_hi})")
    data, off = {}, 8 + hlen
    for name, dt, sh in fields:
        nb = int(np.dtype(dt).itemsize) * int(np.prod(sh))
        data[name] = np.frombuffer(
            buf[off:off + nb], dtype=np.dtype(dt)).reshape(sh)
        off += nb
    return {"lo": header["lo"], "hi": header["hi"], "d": header["d"],
            "rows": header["rows"], "entries": header["entries"],
            "fields": fields, "data": data}
