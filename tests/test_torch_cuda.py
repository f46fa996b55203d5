"""The port's CUDA kernels and its main path on the card, against the
plain PyTorch versions. Every test needs an NVIDIA GPU (the kernels have no
CPU mode) and skips without one. Nothing here imports JAX, so on a machine
without it run::

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import compression  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launch_counts  # noqa: E402
from repro_torch.kernels.quantize import kernel as qkernel  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402
from repro_torch.kernels.zones_pairs import kernel, ops, ref  # noqa: E402
from repro_torch.mapreduce import (ZonePartitioner,  # noqa: E402
                                   neighbor_search_job,
                                   neighbor_statistics_job, run_jobs,
                                   token_histogram)
from test_torch_cases import (ARCSEC, MASKED_CASES, close_pairs_case,  # noqa: E402
                         masked_case, quantize_case)
from repro_torch.data.sky import make_catalog  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, arrs):
    return tuple(torch.as_tensor(x).to(dev) for x in arrs)


def _counts(**launched):
    """The whole launch-count dict: ``launched`` and 0 for every other."""
    return {k: launched.get(k, 0) for k in LAUNCHES}


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
    reset_launch_counts()
    ops.pair_count_masked(a, b, no, nb, np.cos(0.3))
    ops.pair_hist_masked(a, b, no, nb, torch.ones(3, device=cuda_device))
    assert kernel.LAUNCHES == _counts(pair_count_masked=1, pair_hist_masked=1)
    with pytest.raises(TypeError, match="int32"):
        kernel.pair_count_masked_cuda(a, b, no.long(), nb, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.pair_count_masked_cuda(a.transpose(0, 1), b, no, nb, 0.5)
    with pytest.raises(ValueError, match="edges"):
        kernel.pair_hist_masked_cuda(a, b, no, nb,
                                     torch.ones(0, device=cuda_device))
    assert kernel.LAUNCHES == _counts(pair_count_masked=1, pair_hist_masked=1)
    # a tier with no cell launches nothing and counts nothing
    empty = a[:0].contiguous(), b[:0].contiguous(), no[:0], nb[:0]
    assert int(kernel.pair_count_masked_cuda(*empty, 0.5)) == 0
    assert kernel.pair_hist_masked_cuda(
        *empty, torch.ones(3, device=cuda_device)).tolist() == [0, 0, 0]
    assert kernel.LAUNCHES == _counts(pair_count_masked=1, pair_hist_masked=1)
    # the plain version runs on card tensors too (no launch) and agrees
    assert int(ref.pair_count_masked_ref(a, b, no, nb, np.cos(0.3))) == \
        int(kernel.pair_count_masked_cuda(a, b, no, nb, np.cos(0.3)))


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_run_jobs_card_equals_cpu(cuda_device, codec):
    xyz = make_catalog(20_000, 5)
    part = ZonePartitioner(0.03)
    jobs = [neighbor_search_job(0.03, partitioner=part, codec=codec),
            neighbor_statistics_job(np.linspace(0.01, 0.03, 5) / ARCSEC,
                                    partitioner=part, codec=codec)]
    reset_launch_counts()
    card = run_jobs(jobs, xyz)
    n_tiers = len(card[0].stats.tiers)
    assert kernel.LAUNCHES == _counts(pair_count_masked=n_tiers,
                                      pair_hist_masked=n_tiers)
    assert card[0].stats.device.startswith("cuda")
    host = run_jobs(jobs, xyz, device="cpu")
    assert card[0].output == host[0].output
    np.testing.assert_array_equal(card[1].output, host[1].output)


# ---------------------------------------------------------------------------
# the host engine's kernels: unmasked pairs and the block quantizer
# ---------------------------------------------------------------------------

def _host_padded(case):
    """A masked case with zero rows past the real counts, as the host
    engine pads, and some exact self pairs."""
    a, b, no, nb = close_pairs_case() if case == "close" else \
        masked_case(*case)
    for x, n in ((a, no), (b, nb)):
        for p in range(x.shape[0]):
            x[p, n[p]:] = 0.0
    k = min(a.shape[1], b.shape[1]) // 2
    b[:, :k] = a[:, :k]
    return a, b


@pytest.mark.parametrize("case", [*MASKED_CASES, "close"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_unmasked_kernels_equal_plain(cuda_device, case, exclude_self):
    a, b = _on(cuda_device, _host_padded(case))
    blocks = [(a, b), (a[0].contiguous(), b[0].contiguous())]
    for x, y in blocks:
        for arcsec in (15, 60, 0.05 / ARCSEC, 0.3 / ARCSEC):
            cmin = float(np.cos(arcsec * ARCSEC))
            got = kernel.pair_count_cuda(x, y, cmin, exclude_self=exclude_self)
            want = ref.pair_count_ref(x, y, cmin, exclude_self=exclude_self)
            assert int(got) == int(want), arcsec
        for e in (np.cos(np.arange(1, 61) * ARCSEC),
                  np.cos(np.linspace(0.02, 0.4, 5))[[3, 0, 4, 1, 2]]):
            e = torch.as_tensor(e.astype(np.float32)).to(cuda_device)
            got = kernel.pair_hist_cuda(x, y, e, exclude_self=exclude_self)
            want = ref.pair_hist_ref(x, y, e, exclude_self=exclude_self)
            assert torch.equal(got, want)


def test_unmasked_dispatch_counts_launches_and_checks_inputs(cuda_device):
    a, b = _on(cuda_device, _host_padded(MASKED_CASES[0]))
    reset_launch_counts()
    ops.pair_count(a, b, np.cos(0.3), exclude_self=True)
    ops.pair_hist(a, b, torch.ones(3, device=cuda_device))
    assert LAUNCHES == _counts(pair_count=1, pair_hist=1)
    with pytest.raises(ValueError, match="expected a"):
        kernel.pair_count_cuda(a, b[0], 0.5)
    with pytest.raises(ValueError, match="expected a"):
        kernel.pair_count_cuda(a, b[:2], 0.5)
    with pytest.raises(TypeError, match="float32"):
        kernel.pair_count_cuda(a.double(), b, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.pair_hist_cuda(a.transpose(0, 1), b,
                              torch.ones(3, device=cuda_device))
    with pytest.raises(ValueError, match="edges"):
        kernel.pair_hist_cuda(a, b, torch.ones(0, device=cuda_device))
    # an empty input launches nothing and counts nothing
    empty = a[:, :0].contiguous(), b
    assert int(kernel.pair_count_cuda(*empty, 0.5)) == 0
    assert kernel.pair_hist_cuda(
        *empty, torch.ones(3, device=cuda_device)).tolist() == [0, 0, 0]
    assert LAUNCHES == _counts(pair_count=1, pair_hist=1)


@pytest.mark.parametrize("rows,cols", [(8, 256), (16, 1024), (8, 2048),
                                       (1, 1 << 20), (3, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernels_equal_plain(cuda_device, rows, cols, dtype):
    x = torch.as_tensor(quantize_case(rows, cols, rows + cols,
                                      bf16_valued=dtype == torch.bfloat16))
    x = x.to(dtype).to(cuda_device)
    x[0, :256] = 0.0                                  # the 1e-12 floor
    if cols >= 512:
        x[0, 256:261] = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5])  # ties
    q, s = qkernel.quantize_cuda(x)
    wq, ws = qref.quantize_ref(x)
    assert torch.equal(q, wq)
    assert torch.equal(s.view(torch.int32), ws.view(torch.int32))
    got = qkernel.dequantize_cuda(q, s)
    want = qref.dequantize_ref(q, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if cols >= 512:
        assert q[0, 256:261].tolist() == [127, 0, 2, 2, -2]
    assert s[0, 0].item() == np.float32(1e-12) and not q[0, :256].any()


def test_quantize_dispatch_counts_launches_and_checks_inputs(cuda_device):
    x = torch.as_tensor(quantize_case(4, 512, 0)).to(cuda_device)
    reset_launch_counts()
    q, s = qops.quantize(x)
    qops.dequantize(q, s)
    assert LAUNCHES == _counts(quantize=1, dequantize=1)
    with pytest.raises(ValueError, match="C %"):
        qkernel.quantize_cuda(x[:, :300].contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        qkernel.quantize_cuda(x, block=48)
    with pytest.raises(TypeError, match="float32"):
        qkernel.quantize_cuda(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        qkernel.quantize_cuda(x.t())
    with pytest.raises(ValueError, match="scales"):
        qkernel.dequantize_cuda(q, s[:, :1].contiguous())
    # custom blocks, and an empty payload launches nothing
    for block in (64, 128, 512):
        gq, gs = qkernel.quantize_cuda(x, block=block)
        wq, ws = qref.quantize_ref(x, block=block)
        assert torch.equal(gq, wq) and torch.equal(gs, ws)
    reset_launch_counts()
    q0, s0 = qkernel.quantize_cuda(x[:0])
    assert q0.shape == (0, 512) and s0.shape == (0, 2)
    assert qkernel.dequantize_cuda(q0, s0).shape == (0, 512)
    assert LAUNCHES == _counts()
    # the compression module runs the kernels on a CUDA tensor
    flat = torch.as_tensor(quantize_case(1, 3001, 5)[0]).to(cuda_device)
    rt = compression.compress_roundtrip(flat)
    assert torch.equal(rt.cpu(), compression.compress_roundtrip(flat.cpu()))
    assert LAUNCHES == _counts(quantize=1, dequantize=1)


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_host_engine_card_equals_cpu(cuda_device, codec):
    xyz = make_catalog(20_000, 5)
    part = ZonePartitioner(0.03)
    jobs = [neighbor_search_job(0.015, partitioner=part, codec=codec),
            neighbor_search_job(0.03, partitioner=part, codec=codec),
            neighbor_statistics_job(np.linspace(0.01, 0.03, 5) / ARCSEC,
                                    partitioner=part, codec=codec)]
    reset_launch_counts()
    card = run_jobs(jobs, xyz, engine="host")
    q = int(codec == "int8")
    assert LAUNCHES == _counts(pair_count=2, pair_hist=1, quantize=q,
                               dequantize=q)
    st = card[0].stats
    assert st.engine == "host" and st.device.startswith("cuda")
    host = run_jobs(jobs, xyz, engine="host", device="cpu")
    assert [np.asarray(r.output).tolist() for r in card] == \
        [np.asarray(r.output).tolist() for r in host]
    if codec != "int8":
        dev = run_jobs(jobs, xyz)
        assert [np.asarray(r.output).tolist() for r in card] == \
            [np.asarray(r.output).tolist() for r in dev]


@pytest.mark.parametrize("codec", ["identity", "int16"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_token_histogram_on_the_card(cuda_device, codec, engine):
    toks = np.random.default_rng(2).integers(0, 5000, 200_000)
    got = token_histogram(toks, 5000, codec=codec, engine=engine)
    np.testing.assert_array_equal(got.output,
                                  np.bincount(toks, minlength=5000))
    assert got.stats.device.startswith("cuda")
