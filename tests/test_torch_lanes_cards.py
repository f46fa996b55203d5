"""Lanes across cards on the CPU: with no mesh, more than one card and a
device with no index, ``run_jobs_streaming``'s lanes pin lane i to card
i % D, as the reference pins lanes over every device it sees
(``tests/md_check.py::check_mapreduce_lanes_sharded``), and hand their
outputs to the first card before the merge.

Here: the device rule with ``torch.cuda.device_count`` patched, and the
per-lane device plumbing driven over a list of two CPU devices (``cpu``
and ``cpu:0``, which allocate alike and print apart), with chaos and
speculation, held to the JAX package's ``run_jobs`` (its device engine
through the plain refs of its Pallas kernels, as ``test_torch_mesh.py``
runs it) and, for wordcount, its ``token_histogram`` and ``np.bincount``.
The same runs on 2 or more cards are ``test_torch_lanes_cards_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.mapreduce as R  # noqa: E402
from repro_torch.mapreduce import executor  # noqa: E402
from test_torch_lanes_cards_cuda import (RADIUS, VOCAB, catalog,  # noqa: E402
                                         edges_arcsec, three_runs, tokens)
from test_torch_mapreduce import _jobs  # noqa: E402


@pytest.fixture(scope="module")
def jax_wants():
    """The JAX package's outputs of the three runs' jobs: the zone jobs on
    the catalog (twice: plain and chaos) and wordcount on the tokens."""
    jobs = _jobs((RADIUS,), edges_arcsec(), "int16", 64, jax_side=True)
    want = [np.asarray(r.output).tolist()
            for r in R.run_jobs(jobs, catalog(), engine="device")]
    toks = tokens()
    counts = np.asarray(R.token_histogram(toks, VOCAB, tile=64).output)
    np.testing.assert_array_equal(counts, np.bincount(toks, minlength=VOCAB))
    return [want, want, [counts.tolist()]]


def test_lane_devices_rule(monkeypatch):
    """Every card for the device engine with no mesh and no index; one card
    for an explicit index, under a mesh, for the host engine, on one card
    and off the card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    every = [torch.device("cuda", i) for i in range(4)]
    assert executor.lane_devices(cuda, mesh=None, on_device=True) == every
    k = torch.device("cuda", 2)
    assert executor.lane_devices(k, mesh=None, on_device=True) == [k]
    assert executor.lane_devices(cuda, mesh=object(),
                                 on_device=True) == [cuda]
    assert executor.lane_devices(cuda, mesh=None, on_device=False) == [cuda]
    cpu = torch.device("cpu")
    assert executor.lane_devices(cpu, mesh=None, on_device=True) == [cpu]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert executor.lane_devices(cuda, mesh=None, on_device=True) == [cuda]


def test_lanes_over_a_device_list_equal_run_jobs(monkeypatch, jax_wants):
    """The per-lane plumbing over two CPU devices: each split ran on its
    lane's device (lane i on device i % 2), a clone included, and every
    run equals the JAX package's."""
    devices = [torch.device("cpu"), torch.device("cpu", 0)]
    seen = []

    def rule(device, *, mesh, on_device):
        seen.append((device, mesh, on_device))
        return devices if on_device and mesh is None else [device]

    monkeypatch.setattr(executor, "lane_devices", rule)
    runs = three_runs("cpu", 3)
    assert len(seen) == 3 and all(s[2] for s in seen)
    for (got, st), want in zip(runs, jax_wants):
        assert got == want
        assert len(st.splits) == 8
        for rec in st.splits:
            assert rec["device"] == str(devices[rec["lane"] % 2]), rec
    assert {rec["device"] for rec in runs[0][1].splits} == {"cpu", "cpu:0"}
    assert runs[1][1].retries > 0          # the chaos fired


def test_one_device_keeps_every_lane_there(jax_wants):
    """With no device list to spread over, every split runs where the
    caller asked."""
    for (got, st), want in zip(three_runs("cpu", 3), jax_wants):
        assert got == want
        assert {rec["device"] for rec in st.splits} == {"cpu"}
