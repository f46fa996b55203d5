"""Composable MapReduce on PyTorch: the device engine, one split.

Stage plugins (``Partitioner`` / ``ShuffleCodec`` / ``Reducer``) compose
into a ``MapReduceJob``; ``run_jobs`` maps, shuffles into capacity tiers and
reduces through the masked pair kernels once, on the card unless the caller
passes ``device="cpu"``. ``shuffle_once`` keeps the shuffled tiers resident
for many ``ResidentCatalog.run`` calls, and ``convert`` carries them across
frameworks as numpy arrays.
"""
from repro_torch.mapreduce.codecs import (IdentityCodec, Int8BlockCodec,
                                          Int16Codec, ShuffleCodec,
                                          available_codecs, get_codec,
                                          register_codec)
from repro_torch.mapreduce.instrumentation import StageStats
from repro_torch.mapreduce.job import (DeviceShuffledData, JobResult,
                                       MappedSplit, MapReduceJob, Partitioner,
                                       Reducer, ResidentCatalog, TierData,
                                       map_split_device, plan_tiers,
                                       resolve_device, run_job, run_jobs,
                                       shuffle_once, shuffle_reduce_device,
                                       shuffle_signature, validate_batch)
from repro_torch.mapreduce.zones import (PairCountReducer, ZonePartitioner,
                                         neighbor_search_job)
from repro_torch.mapreduce.stats import (DEFAULT_EDGES_ARCSEC,
                                         PairHistReducer,
                                         neighbor_statistics_job)
from repro_torch.mapreduce.convert import catalog_from_numpy, catalog_to_numpy
