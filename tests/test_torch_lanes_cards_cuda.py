"""Lanes across cards on the card: with no mesh, more than one card and a
device with no index, ``run_jobs_streaming``'s lanes pin lane i to card
i % D, as the reference pins lanes over every device it sees
(``tests/md_check.py::check_mapreduce_lanes_sharded``), and hand their
outputs to the first card before the merge.

The ``cuda`` tests run on a machine with 2 or more cards and skip below
that; ``test_torch_lanes_cards.py`` drives the same runs on the CPU against
the JAX package. Nothing here imports JAX, so on such a machine::

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_lanes_cards_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import ArraySplits, sky  # noqa: E402
from repro_torch.ft import FaultySplitSource, SpeculativeConfig  # noqa: E402
from repro_torch.mapreduce import (ZonePartitioner,  # noqa: E402
                                   neighbor_search_job,
                                   neighbor_statistics_job, run_jobs,
                                   run_jobs_streaming, token_histogram_job)

RADIUS = 0.09
VOCAB = 300
N, SEED = 900, 5


def edges_arcsec():
    return np.linspace(0.03, RADIUS, 4) / sky.ARCSEC


def zone_jobs(codec="int16"):
    part = ZonePartitioner(RADIUS)
    return [neighbor_search_job(RADIUS, partitioner=part, codec=codec,
                                tile=64),
            neighbor_statistics_job(edges_arcsec(), partitioner=part,
                                    codec=codec, tile=64)]


def catalog():
    return sky.make_catalog(N, SEED)


def tokens():
    return np.random.default_rng(2).integers(0, VOCAB, 6000)


def outputs(res):
    return [np.asarray(r.output).tolist() for r in res]


def _chaos(xyz):
    """``md_check.py``'s chaos: seeded delays and transient faults."""
    return FaultySplitSource(ArraySplits(xyz, 8), seed=0, delay_p=0.4,
                             fault_p=0.4, delay_s=0.05, max_faults=2)


def three_runs(device, n_lanes):
    """``md_check.py``'s three lane runs on ``device``: the zone jobs plain
    but slow, the zone jobs under chaos with speculation, and wordcount in
    combine mode. -> [(outputs, StageStats)]."""
    xyz = catalog()
    jobs = zone_jobs()
    kw = dict(device=device, n_lanes=n_lanes)
    runs = []
    # every split's fetch takes 50 ms, so every lane takes splits
    slow = FaultySplitSource(ArraySplits(xyz, 8),
                             delays=dict.fromkeys(range(8), 0.05))
    res = run_jobs_streaming(jobs, slow, **kw)
    runs.append((outputs(res), res[0].stats))
    res = run_jobs_streaming(
        jobs, _chaos(xyz), max_retries=2, retry_backoff_s=0.01,
        speculate=SpeculativeConfig(slowdown=2.0, min_finished=2), **kw)
    runs.append((outputs(res), res[0].stats))
    res = run_jobs_streaming([token_histogram_job(VOCAB, n_partitions=16,
                                                  tile=64)],
                             ArraySplits(tokens().astype(np.float32)
                                         .reshape(-1, 1), 8), **kw)
    runs.append((outputs(res), res[0].stats))
    return runs


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs: one card has no lanes "
                    "across cards")


@pytest.mark.cuda
def test_lanes_across_cards_equal_run_jobs():
    """On 2 or more cards: lanes on distinct cards, results equal to the
    monolithic run on the first card and to ``np.bincount``."""
    _two_cards()
    D = torch.cuda.device_count()
    want = outputs(run_jobs(zone_jobs(), catalog()))
    counts = [np.bincount(tokens(), minlength=VOCAB).tolist()]
    runs = three_runs(None, 2 * D)
    for (got, st), w in zip(runs, [want, want, counts]):
        assert got == w
        for rec in st.splits:
            assert rec["device"] == f"cuda:{rec['lane'] % D}", rec
    cards = {rec["device"] for rec in runs[0][1].splits}
    assert cards == {f"cuda:{i}" for i in range(D)}, cards


@pytest.mark.cuda
def test_explicit_card_keeps_its_lanes():
    _two_cards()
    xyz = catalog()
    res = run_jobs_streaming(zone_jobs(), ArraySplits(xyz, 4), n_lanes=2,
                             device="cuda:1")
    assert {rec["device"] for rec in res[0].stats.splits} == {"cuda:1"}
    assert outputs(res) == outputs(run_jobs(zone_jobs(), xyz,
                                            device="cuda:1"))
