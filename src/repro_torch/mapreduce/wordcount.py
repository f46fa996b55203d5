"""Token histogram (wordcount): a non-astronomy job on the same engines.

Hadoop's canonical first job: map hashes each token to a partition
(``HashPartitioner``), the shuffle moves the (optionally codec-compressed)
token payload, and the reduce counts each partition's owned tokens with an
exact integer scatter-add (``index_add_`` in int64). It has no pair kernel:
it shows the Job API carries any reducer through both engines, codecs and
``StageStats``.

Wordcount is also the textbook map-side-combine job: its reduce is a
commutative-monoid fold over individual owned rows, so
``TokenHistogramReducer.combiner()`` returns a ``TokenCountCombiner`` and
the streaming executor (``executor.py``) pre-aggregates each split to
``(token, count)`` rows BEFORE the shuffle: the wire then carries at most
``min(split_rows, vocab)`` weighted entries instead of every token, and
only the combined [vocab] accumulator persists across splits. The reducer
treats a second item column as an integer weight, so combined and raw
streams reduce through the same code and agree exactly. Tokens ride the wire as float32 scalars: ``identity`` is exact, and
``Int16Codec(max_abs=vocab)`` is lossless for integer tokens whenever
``vocab < 32767`` (quantization error < 0.5, removed by the reducer's
round), at half the shuffle bytes. (The combiner's count column is NOT
generally in that domain, a count can exceed ``vocab``, which is why the
executor derives combiners for exact codecs only.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.mapreduce.codecs import Int16Codec
from repro_torch.mapreduce.executor import Combiner
from repro_torch.mapreduce.job import (HashPartitioner, JobResult,
                                       MapReduceJob, Reducer, run_job)


@dataclasses.dataclass(frozen=True)
class TokenCountCombiner(Combiner):
    """Map-side combine for the token histogram: rewrite a raw ``[n, 1]``
    token split into ``[m, 2]`` (token, count) rows (``m`` = distinct
    in-range tokens present) before map/shuffle; per-split histogram
    partials then sum across splits (the base ``combine``)."""

    vocab: int
    name: str = "token_count"

    def precombine(self, items: np.ndarray) -> np.ndarray:
        tok = np.rint(np.asarray(items, np.float64).reshape(-1)
                      ).astype(np.int64)
        tok = tok[(tok >= 0) & (tok < self.vocab)]
        counts = np.bincount(tok, minlength=self.vocab)
        nz = np.flatnonzero(counts)
        return np.stack([nz, counts[nz]], axis=1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class TokenHistogramReducer(Reducer):
    """Per-partition count of owned tokens (padding rides as -1 on the host
    engine; masked by real counts on the device engine). Rows may carry a
    second column as an integer weight."""

    vocab: int
    pad_value: float = -1.0

    def _count(self, owned, valid):
        """Scatter-add of the valid rows' weights at their tokens ->
        int64 [vocab]. ``owned``: [..., d] rows, ``valid``: [...] bool."""
        tok = torch.round(owned[..., 0]).to(torch.int64)
        valid = valid & (tok >= 0) & (tok < self.vocab)
        w = valid.to(torch.int64)
        if owned.shape[-1] > 1:
            w = w * torch.round(owned[..., 1]).to(torch.int64)
        idx = torch.clamp(tok, 0, self.vocab - 1)
        out = torch.zeros(self.vocab, dtype=torch.int64, device=owned.device)
        return out.index_add_(0, idx.reshape(-1), w.reshape(-1))

    def per_partition(self, owned_p, bucket_p):
        return self._count(owned_p, torch.ones(owned_p.shape[:-1],
                                               dtype=torch.bool,
                                               device=owned_p.device))

    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        rows = torch.arange(owned.shape[1], device=owned.device)
        return self._count(owned, rows[None, :] < n_owned[:, None])

    def finalize(self, total, sd):
        return total.cpu().numpy().astype(np.int64)

    def flops(self, sd):
        return sd.owned_cells * 4.0

    def combiner(self):
        return TokenCountCombiner(self.vocab)


def token_histogram_job(vocab: int, *, n_partitions: int = 8,
                        codec="identity", tile: int = 256) -> MapReduceJob:
    """Wordcount as a composable job. ``codec="int16"`` halves shuffle bytes
    losslessly for ``vocab < 32767`` (see module docstring)."""
    if codec == "int16":
        codec = Int16Codec(max_abs=float(vocab))
    return MapReduceJob("token_histogram", HashPartitioner(n_partitions),
                        TokenHistogramReducer(vocab), codec=codec, tile=tile)


def token_histogram(tokens, vocab: int, *, n_partitions: int = 8,
                    codec="identity", tile: int = 256, engine: str = "auto",
                    device=None) -> JobResult:
    """Count token occurrences of any token block. -> JobResult whose output
    is a [vocab] int64 count vector. ``device=None`` means the card."""
    items = np.asarray(tokens).reshape(-1).astype(np.float32)
    job = token_histogram_job(vocab, n_partitions=n_partitions, codec=codec,
                              tile=tile)
    return run_job(job, items, engine=engine, device=device)
