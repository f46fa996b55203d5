"""Composable MapReduce on PyTorch: the device and host engines, streamed.

Stage plugins (``Partitioner`` / ``ShuffleCodec`` / ``Reducer``) compose
into a ``MapReduceJob``; ``run_jobs`` maps, shuffles and reduces once (the
one-split case of the streaming executor, ``run_jobs_streaming``, which
pulls splits from a ``SplitSource`` with prefetch, map-side combine and
concurrent lanes), on the card unless the caller passes ``device="cpu"``. ``engine="device"``
(the default) shuffles into capacity tiers and reduces through the masked
pair kernels; ``engine="host"`` is the oracle-parity path (numpy shuffle to
one global capacity, ``shuffle_stage``/``reduce_stage``, unmasked kernels).
``shuffle_once`` keeps the device engine's tiers resident for many
``ResidentCatalog.run`` calls, and ``convert`` carries them across
frameworks as numpy arrays. The Zones apps (``zones.py``, ``stats.py``)
and wordcount (``wordcount.py``) are thin definitions on this API;
``api.py`` keeps the legacy surface.
"""
from repro_torch.mapreduce.codecs import (EncodedShuffle, IdentityCodec,
                                          Int8BlockCodec, Int16Codec,
                                          ShuffleCodec, available_codecs,
                                          get_codec, register_codec)
from repro_torch.mapreduce.instrumentation import StageStats
from repro_torch.mapreduce.job import (DeviceShuffledData, HashPartitioner,
                                       JobResult, MappedSplit, MapReduceJob,
                                       Partitioner, Reducer, ResidentCatalog,
                                       ShuffledData, StreamSummary, TierData,
                                       concat_mapped, host_shuffle_reduce,
                                       map_split_device, plan_tiers,
                                       reduce_stage, resolve_device, run_job,
                                       run_jobs, shuffle_once,
                                       shuffle_reduce_device,
                                       shuffle_signature, shuffle_stage,
                                       validate_batch)
from repro_torch.mapreduce.executor import (Combiner, JobDeadlineExceeded,
                                            LaneCancelled, LanePool,
                                            run_job_streaming,
                                            run_jobs_streaming)
from repro_torch.mapreduce.zones import (PairCountReducer, ZonePartitioner,
                                         neighbor_pairs_dense,
                                         neighbor_search_job)
from repro_torch.mapreduce.stats import (DEFAULT_EDGES_ARCSEC,
                                         PairHistReducer,
                                         neighbor_statistics_job)
from repro_torch.mapreduce.wordcount import (TokenCountCombiner,
                                             TokenHistogramReducer,
                                             token_histogram,
                                             token_histogram_job)
from repro_torch.mapreduce.convert import catalog_from_numpy, catalog_to_numpy

# Legacy surface (deprecated wrappers; kept for compatibility)
from repro_torch.mapreduce.api import ZonedData, bucket_by_zone, sharded_zone_reduce
from repro_torch.mapreduce.zones import neighbor_search_count
from repro_torch.mapreduce.stats import neighbor_statistics
