"""The port's CUDA kernels and its main path on the card, against the
plain PyTorch versions. Every test needs an NVIDIA GPU (the kernels have no
CPU mode) and skips without one. Nothing here imports JAX, so on a machine
without it run::

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.zones_pairs import kernel, ops, ref  # noqa: E402
from repro_torch.mapreduce import (ZonePartitioner,  # noqa: E402
                                   neighbor_search_job,
                                   neighbor_statistics_job, run_jobs)
from test_torch_cases import (ARCSEC, MASKED_CASES, close_pairs_case,  # noqa: E402
                         masked_case)
from repro_torch.data.sky import make_catalog  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, arrs):
    return tuple(torch.as_tensor(x).to(dev) for x in arrs)


@pytest.mark.parametrize("case", [*MASKED_CASES, "close"])
def test_kernels_equal_plain(cuda_device, case):
    a, b, no, nb = _on(cuda_device, close_pairs_case() if case == "close"
                       else masked_case(*case))
    for arcsec in (15, 30, 60, 0.05 / ARCSEC, 0.3 / ARCSEC):
        cmin = float(np.cos(arcsec * ARCSEC))
        got = kernel.pair_count_masked_cuda(a, b, no, nb, cmin)
        want = ref.pair_count_masked_ref(a, b, no, nb, cmin)
        assert int(got) == int(want), arcsec
    for e in (np.cos(np.arange(1, 61) * ARCSEC),
              np.cos(np.linspace(0.02, 0.4, 17))[::-1],
              np.cos(np.linspace(0.02, 0.4, 5))[[3, 0, 4, 1, 2]]):
        e = torch.as_tensor(e.astype(np.float32)).to(cuda_device)
        got = kernel.pair_hist_masked_cuda(a, b, no, nb, e)
        want = ref.pair_hist_masked_ref(a, b, no, nb, e)
        assert torch.equal(got, want)


def test_dispatch_counts_launches_and_checks_inputs(cuda_device):
    a, b, no, nb = _on(cuda_device, masked_case(*MASKED_CASES[0]))
    kernel.reset_launch_counts()
    assert ops.uses_kernel(a)
    ops.pair_count_masked(a, b, no, nb, np.cos(0.3))
    ops.pair_hist_masked(a, b, no, nb, torch.ones(3, device=cuda_device))
    assert kernel.LAUNCHES == {"pair_count_masked": 1, "pair_hist_masked": 1}
    with pytest.raises(TypeError, match="int32"):
        kernel.pair_count_masked_cuda(a, b, no.long(), nb, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.pair_count_masked_cuda(a.transpose(0, 1), b, no, nb, 0.5)
    with pytest.raises(ValueError, match="edges"):
        kernel.pair_hist_masked_cuda(a, b, no, nb,
                                     torch.ones(0, device=cuda_device))
    assert kernel.LAUNCHES == {"pair_count_masked": 1, "pair_hist_masked": 1}
    # a tier with no cell launches nothing and counts nothing
    empty = a[:0].contiguous(), b[:0].contiguous(), no[:0], nb[:0]
    assert int(kernel.pair_count_masked_cuda(*empty, 0.5)) == 0
    assert kernel.pair_hist_masked_cuda(
        *empty, torch.ones(3, device=cuda_device)).tolist() == [0, 0, 0]
    assert kernel.LAUNCHES == {"pair_count_masked": 1, "pair_hist_masked": 1}
    # the plain path is still reachable on the card when asked for
    assert int(ops.pair_count_masked(a, b, no, nb, np.cos(0.3),
                                     use_kernel=False)) == \
        int(kernel.pair_count_masked_cuda(a, b, no, nb, np.cos(0.3)))


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_run_jobs_card_equals_cpu(cuda_device, codec):
    xyz = make_catalog(20_000, 5)
    part = ZonePartitioner(0.03)
    jobs = [neighbor_search_job(0.03, partitioner=part, codec=codec),
            neighbor_statistics_job(np.linspace(0.01, 0.03, 5) / ARCSEC,
                                    partitioner=part, codec=codec)]
    kernel.reset_launch_counts()
    card = run_jobs(jobs, xyz)
    n_tiers = len(card[0].stats.tiers)
    assert kernel.LAUNCHES == {"pair_count_masked": n_tiers,
                               "pair_hist_masked": n_tiers}
    assert card[0].stats.device.startswith("cuda")
    host = run_jobs(jobs, xyz, device="cpu")
    assert card[0].output == host[0].output
    np.testing.assert_array_equal(card[1].output, host[1].output)
