"""The port's CUDA kernels and its main path on the card, against the
plain PyTorch versions. Every test needs an NVIDIA GPU (the kernels have no
CPU mode) and skips without one. Nothing here imports JAX, so on a machine
without it run::

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import compression  # noqa: E402
from repro_torch.kernels import (LAUNCHES, VARIANT_LAUNCHES,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.quantize import kernel as qkernel  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402
from repro_torch.kernels.zones_pairs import kernel, ops, ref  # noqa: E402
from repro_torch.mapreduce import (ZonePartitioner,  # noqa: E402
                                   neighbor_search_job,
                                   neighbor_statistics_job, run_jobs,
                                   token_histogram)
from test_torch_cases import (ARCSEC, COS60, FLASH_CASES,  # noqa: E402
                              FLASH_EDGE_CASES, FLASH_FAMILY_CASES,
                              HIST_EDGE_SETS, MASKED_CASES,
                              close_pairs_case, flash_case, masked_case,
                              plain_moe, quantize_case)
from repro_torch.data.sky import make_catalog  # noqa: E402
from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.models import model as mdl  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.data.pipeline import ArraySplits, Prefetcher  # noqa: E402
from repro_torch.mapreduce import (LanePool, run_job_streaming,  # noqa: E402
                                   run_jobs_streaming, token_histogram_job)
from repro_torch.mapreduce.executor import _PinnedCopier  # noqa: E402
from repro_torch.mapreduce.job import _fence  # noqa: E402

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


# (P, C1, C2, n_owned, n_bucket) for the register-tiled masked count: owned
# rows that are not a multiple of its 32-row warp slices or its 1,024-row
# block, bucket rows that are not a multiple of its 256-row tiles nor of 4
# (odd C2 leaves most partitions' slabs off 16-byte alignment), and
# partitions with no owned or no bucket row
COUNT_CASES = [
    (3, 520, 300, (0, 517, 1), (300, 0, 299)),
    (2, 1100, 777, (1100, 1030), (777, 5)),
    (4, 33, 257, (33, 0, 7, 32), (0, 257, 256, 1)),
]


def _shifted(b, offset):
    """``b`` copied to start ``offset`` floats past a 16-byte boundary."""
    if not offset:
        return b
    buf = torch.zeros(b.numel() + offset, device=b.device)
    buf[offset:] = b.reshape(-1)
    b = buf[offset:].view(b.shape)
    assert b.is_contiguous() and b.data_ptr() % 16 == 4 * offset
    return b


def _ragged(case, dev):
    """A ``COUNT_CASES`` case or ``close_pairs_case``, with zero rows past
    the real counts (a row the mask lets through would then score 0)."""
    a, b, no, nb = close_pairs_case() if case == "close" else \
        masked_case(*case)
    for x, n in ((a, no), (b, nb)):
        for p in range(x.shape[0]):
            x[p, n[p]:] = 0.0
    return _on(dev, (a, b, no, nb))


@pytest.mark.parametrize("case", [*COUNT_CASES, "close"])
@pytest.mark.parametrize("offset", [0, 1])
def test_masked_count_equals_plain_on_ragged_tiles(cuda_device, case, offset):
    """``offset`` 1 starts ``b`` one float past a 16-byte boundary, so no
    slab takes the 16-byte staging path."""
    a, b, no, nb = _on(cuda_device, close_pairs_case() if case == "close"
                       else masked_case(*case))
    b = _shifted(b, offset)
    for cmin in (COS60, np.cos(15 * ARCSEC), np.cos(0.05), np.cos(0.3)):
        got = kernel.pair_count_masked_cuda(a, b, no, nb, cmin)
        want = ref.pair_count_masked_ref(a, b, no, nb, cmin)
        assert int(got) == int(want), cmin



# the edge sets of the CPU tests, and as many edges as the kernel takes (its
# dynamic shared memory then passes the 48 KB default)
CARD_EDGE_SETS = {**HIST_EDGE_SETS, "most": np.cos(
    np.linspace(0.0, 0.4, kernel.MAX_EDGES)).astype(np.float32)}


@pytest.mark.parametrize("case", [*COUNT_CASES, "close"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("edges", list(CARD_EDGE_SETS))
def test_masked_hist_equals_plain_on_ragged_tiles(cuda_device, case, offset,
                                                  edges):
    """The histogram's walk on the count's ragged cases, exactly. With the
    edge below 0 the zero rows past ``n_a`` and ``n_b`` would be binned if
    the kernel let them through."""
    a, b, no, nb = _ragged(case, cuda_device)
    b = _shifted(b, offset)
    e = torch.as_tensor(CARD_EDGE_SETS[edges]).to(cuda_device)
    got = kernel.pair_hist_masked_cuda(a, b, no, nb, e)
    want = ref.pair_hist_masked_ref(a, b, no, nb, e)
    assert torch.equal(got, want), (got.tolist()[:8], want.tolist()[:8])


@pytest.mark.parametrize("case", [*COUNT_CASES, "close"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_unmasked_count_equals_plain_on_ragged_tiles(cuda_device, case,
                                                     exclude_self):
    """The unmasked count on the count's walk: every cell of the capacity,
    padding included (it scores 0 and counts for a threshold <= 0), with
    M != N in both orders, one block of a batch, and b off 16-byte
    alignment."""
    a, b = _on(cuda_device, _host_padded(case))
    blocks = [(a, b), (b, a), (a[0].contiguous(), b[0].contiguous()),
              (a[:, 1:].contiguous(), _shifted(b, 1))]
    for x, y in blocks:
        for cmin in (COS60, np.cos(15 * ARCSEC), np.cos(0.05), np.cos(0.3),
                     0.0, np.cos(np.radians(100.0)), -1.0):
            got = kernel.pair_count_cuda(x, y, cmin, exclude_self=exclude_self)
            want = ref.pair_count_ref(x, y, cmin, exclude_self=exclude_self)
            assert int(got) == int(want), (tuple(x.shape), tuple(y.shape),
                                           cmin)


@pytest.mark.parametrize("case", [*COUNT_CASES, "close"])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("edges", list(CARD_EDGE_SETS))
def test_unmasked_hist_equals_plain_on_ragged_tiles(cuda_device, case,
                                                    exclude_self, edges):
    """The unmasked histogram on the walk, exactly, on the unmasked count's
    blocks: zero padding rows score 0 and are binned where an edge is <= 0,
    and under ``exclude_self`` the diagonal scores -2 (binned by the edges
    at and below -2)."""
    a, b = _on(cuda_device, _host_padded(case))
    e = torch.as_tensor(CARD_EDGE_SETS[edges]).to(cuda_device)
    blocks = [(a, b), (b, a), (a[0].contiguous(), b[0].contiguous()),
              (a[:, 1:].contiguous(), _shifted(b, 1))]
    for x, y in blocks:
        got = kernel.pair_hist_cuda(x, y, e, exclude_self=exclude_self)
        want = ref.pair_hist_ref(x, y, e, exclude_self=exclude_self)
        assert torch.equal(got, want), (tuple(x.shape), tuple(y.shape),
                                        got.tolist()[:8], want.tolist()[:8])


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


FLASH_ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("case", [*FLASH_CASES, *FLASH_EDGE_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_equals_plain(cuda_device, case, dtype):
    S, H, Kv, dh, window, cap = case
    q, k, v = (torch.as_tensor(x).to(dtype).to(cuda_device)
               for x in flash_case(S, H, Kv, dh))
    for causal in (True, False):
        got = fkernel.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, softcap=cap)
        want = fref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=cap)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=FLASH_ATOL[dtype], rtol=0)


# (S, H, Kv, dh, window, cap, B) for the bf16 tensor-core kernel: TinyLlama's
# head layout (32 query heads on 4 kv heads, dh 64) at a small S, and dh 128
# and 256 (two and four 64-column chunks a row) with and without a window
# and a softcap, none of S a multiple of its 128-row query or 64-key tiles
FLASH_TC_CASES = [
    (300, 32, 4, 64, 0, 0.0, 1),
    (300, 32, 4, 64, 0, 30.0, 1),
    (130, 4, 1, 128, 0, 30.0, 2),
    (130, 4, 2, 128, 70, 0.0, 2),
    (100, 2, 1, 256, 70, 0.0, 2),
    (100, 4, 2, 256, 70, 30.0, 1),
]


@pytest.mark.parametrize("case", list(FLASH_FAMILY_CASES))
def test_flash_family_instances_equal_plain(cuda_device, case):
    dtype, S, H, Kv, dh, window, cap, scale, B = FLASH_FAMILY_CASES[case]
    q, k, v = (torch.as_tensor(x).to(dtype).to(cuda_device)
               for x in flash_case(S, H, Kv, dh, seed=S + H, B=B))
    for causal in (True, False):
        kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
        got = fkernel.flash_attention_cuda(q, k, v, **kw)
        want = fref.attention_ref(q, k, v, **kw)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("case", FLASH_TC_CASES)
def test_flash_tensor_core_kernel_equals_plain(cuda_device, case):
    S, H, Kv, dh, window, cap, B = case
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16).to(cuda_device)
               for x in flash_case(S, H, Kv, dh, seed=S + dh, B=B))
    for causal in (True, False):
        got = fkernel.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, softcap=cap)
        want = fref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=cap)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=FLASH_ATOL[torch.bfloat16], rtol=0)


def test_flash_refuses_unaligned_input(cuda_device):
    """TMA reads from 16-byte aligned addresses: a contiguous view that
    starts one element in is refused before any launch."""
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16).to(cuda_device)
               for x in flash_case(64, 2, 1, 64, B=1))
    buf = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        fkernel.flash_attention_cuda(shifted, k, v)
    assert LAUNCHES == _counts()


def test_flash_dispatch_counts_launches_and_checks_inputs(cuda_device):
    q, k, v = (torch.as_tensor(x).to(cuda_device)
               for x in flash_case(*FLASH_CASES[1][:4]))
    reset_launch_counts()
    fops.flash_attention(q, k, v)
    fops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                         k, v, True, 0, 0.0, 0.1)   # made contiguous first
    assert LAUNCHES == _counts(flash_attention=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fkernel.flash_attention_cuda(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        fkernel.flash_attention_cuda(q.transpose(1, 2).contiguous()
                                     .transpose(1, 2), k, v)
    with pytest.raises(TypeError, match="float32"):
        fkernel.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="head dim"):
        fkernel.flash_attention_cuda(q[..., :48].contiguous(),
                                     k[..., :48].contiguous(),
                                     v[..., :48].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        fkernel.flash_attention_cuda(q[:, :, :3].contiguous(), k, v)
    assert fkernel.flash_attention_cuda(q[:0], k[:0], v[:0]).shape[0] == 0
    assert LAUNCHES == _counts(flash_attention=2)
    assert VARIANT_LAUNCHES == {"flash_attention_f32": 2,
                                "flash_attention_bf16": 0}


def _attend_case(S, H, Kv, dh, dv=None, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=(2, S, n, d)) * 0.5,
                                 dtype=torch.float32)
                 for n, d in ((H, dh), (Kv, dh), (Kv, dv or dh)))


@pytest.mark.parametrize("dh,dv", [(48, 48), (64, 32)])
def test_attend_computes_what_flash_cannot_take(cuda_device, dh, dv):
    """A head dim without a kernel instance, or dv != dh: causal self
    attention on the card runs the masked formula there, equal to the CPU
    to the flash tolerance, and never launches the kernel."""
    from repro_torch.models import attention
    q, k, v = _attend_case(40, 4, 2, dh, dv)
    assert not fkernel.supports(q, k, v)
    reset_launch_counts()
    got = attention.attend(*(t.to(cuda_device) for t in (q, k, v)),
                           causal=True)
    assert LAUNCHES == _counts()
    want = attention.attend(q, k, v, causal=True)
    torch.testing.assert_close(got.cpu(), want,
                               atol=FLASH_ATOL[torch.float32], rtol=0)


def test_attend_blocked_causal_past_a_chunk_runs_flash(cuda_device):
    """``blocked_causal`` with S > chunk, which raises on the CPU, runs the
    flash kernel on the card (``RunConfig.attention_impl_for``'s contract),
    once, equal to the masked formula on the CPU; so does a q that starts
    off 16-byte alignment (the dispatch copies it)."""
    from repro_torch.models import attention
    q, k, v = _attend_case(40, 4, 2, 64, seed=1)
    want = attention.attend(q, k, v, causal=True)
    qc, kc, vc = (t.to(cuda_device) for t in (q, k, v))
    buf = torch.zeros(qc.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(qc.shape)
    shifted.copy_(qc)
    for x in (qc, shifted):
        reset_launch_counts()
        got = attention.attend(x, kc, vc, causal=True, impl="blocked_causal",
                               chunk=16)
        assert LAUNCHES == _counts(flash_attention=1)
        torch.testing.assert_close(got.cpu(), want,
                                   atol=FLASH_ATOL[torch.float32], rtol=0)


@pytest.mark.parametrize("window", [0, 100])
def test_attend_blocked_causal_equals_chunked_without_flash(cuda_device,
                                                             window):
    """A call flash does not take (MLA's q/k head dim 192 against v's 128)
    with ``blocked_causal`` past one chunk: the static block schedule on
    the card, equal to the chunked loop there (which computes every block)
    to 1e-5 of max |o| and to the CPU's blocked schedule, with no launch."""
    from repro_torch.models import attention
    q, k, v = _attend_case(300, 4, 4, 192, 128, seed=2)
    qc, kc, vc = (t.to(cuda_device) for t in (q, k, v))
    kw = dict(causal=True, window=window, chunk=64)
    reset_launch_counts()
    got = attention.attend(qc, kc, vc, impl="blocked_causal", **kw)
    chunked = attention.attend(qc, kc, vc, impl="chunked", **kw)
    torch.cuda.synchronize()
    assert LAUNCHES == _counts()
    scale = chunked.abs().max().item()
    assert (got - chunked).abs().max().item() <= 1e-5 * scale
    want = attention.attend(q, k, v, impl="blocked_causal", **kw)
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * scale


def test_flash_backward_on_cuda(cuda_device):
    q, k, v = (torch.as_tensor(x).to(cuda_device).requires_grad_()
               for x in flash_case(64, 2, 2, 16, seed=3, B=1))
    fops.flash_attention(q, k, v).sum().backward()
    got = [t.grad for t in (q, k, v)]
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    fref.attention_ref(qc, kc, vc).sum().backward()
    for g, want in zip(got, (qc.grad, kc.grad, vc.grad)):
        torch.testing.assert_close(g.cpu(), want, atol=1e-5, rtol=0)


LM_CFG = get_arch("tinyllama-1.1b").reduced()


def _lm_pair(cuda_device, dtype=torch.float32):
    cpu = mdl.init(LM_CFG, 1, device="cpu", dtype=dtype)
    return cpu, mdl.init(LM_CFG, 1, device="cpu", dtype=dtype).to(cuda_device)


@pytest.mark.parametrize("chunk", [1024, 16])
def test_lm_forward_card_equals_cpu(cuda_device, chunk):
    """Reduced TinyLlama: the card (flash kernel, one launch per layer)
    against the port on the CPU (masked or chunked plain attention), f32,
    to 1e-5 of the largest |logit|."""
    cpu, card = _lm_pair(cuda_device)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 40)))
    rc = RunConfig(attn_chunk=chunk)
    reset_launch_counts()
    with torch.inference_mode():
        got = mdl.forward(LM_CFG, rc, card, {"tokens": toks.to(cuda_device)})[0]
        torch.cuda.synchronize()
        assert LAUNCHES == _counts(flash_attention=LM_CFG.n_layers)
        want = mdl.forward(LM_CFG, rc, cpu, {"tokens": toks})[0]
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_lm_prefill_decode_on_the_card(cuda_device):
    """Prefill launches the kernel once per layer, decode never; the first
    decode logits agree with a full forward (test_smoke_archs' check) and
    with the CPU."""
    cpu, card = _lm_pair(cuda_device)
    toks = np.random.default_rng(1).integers(0, 256, (2, 33))
    rc = RunConfig()
    reset_launch_counts()
    cache, _ = engine.make_prefill_step(LM_CFG, rc, 40)(card,
                                                       {"tokens": toks[:, :32]})
    assert LAUNCHES == _counts(flash_attention=LM_CFG.n_layers)
    dec, cache = engine.make_decode_step(LM_CFG, rc)(card, cache,
                                                     toks[:, 32:], 32)
    assert LAUNCHES == _counts(flash_attention=LM_CFG.n_layers)
    with torch.inference_mode():
        full = mdl.forward(LM_CFG, rc, card,
                           {"tokens": torch.as_tensor(toks, device=cuda_device)})[0]
    ccache, _ = engine.make_prefill_step(LM_CFG, rc, 40, device="cpu")(
        cpu, {"tokens": toks[:, :32]})
    cdec, _ = engine.make_decode_step(LM_CFG, rc, device="cpu")(
        cpu, ccache, toks[:, 32:], 32)
    scale = full[:, 32].abs().max().item()
    assert (dec - full[:, 32]).abs().max().item() <= 1e-5 * scale
    assert (dec.cpu() - cdec).abs().max().item() <= 1e-5 * scale


FAMILIES = ["olmo-1b", "starcoder2-7b", "gemma2-2b", "recurrentgemma-2b",
            "mamba2-1.3b", "granite-moe-3b-a800m", "deepseek-v3-671b",
            "musicgen-medium", "internvl2-2b"]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_prefill_decode_on_the_card(cuda_device, name):
    """Each family reduced (recurrentgemma with its tail group), f32: the
    card's forward equals the CPU's to 1e-5 of the largest |logit|; prefill
    launches flash once per attention layer (none for MLA, whose q/k and v
    head dims differ, and none for musicgen's cross attention, which is not
    causal) and decode never; 4 decode steps from the card's prefill give
    the card's full forward and the CPU's decode. musicgen and internvl2
    take the same ``cond``/``prefix`` (``stub_frontend``) on both sides.
    The MoE families run at a capacity where nothing drops: prefill and
    the forward chunk the batch differently, and a drop in one and not the
    other changes the rows after it."""
    cfg = get_arch(name).reduced()
    if cfg.rglru is not None:
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern) + 2)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    n_attn = 0 if cfg.mla is not None else \
        sum(k in ("attn", "local") for k in cfg.layer_kinds)
    cpu = mdl.init(cfg, 1, device="cpu", dtype=torch.float32)
    card = mdl.init(cfg, 1, device="cpu", dtype=torch.float32).to(cuda_device)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 44))
    extra = mdl.stub_frontend(cfg, 2, 5, device="cpu")
    on_card = {k: t.to(cuda_device) for k, t in extra.items()}
    rc = RunConfig()
    reset_launch_counts()
    with torch.inference_mode():
        full = mdl.forward(cfg, rc, card, {"tokens": torch.as_tensor(
            toks, device=cuda_device), **on_card})[0]
        torch.cuda.synchronize()
        assert LAUNCHES == _counts(flash_attention=n_attn)
        want = mdl.forward(cfg, rc, cpu, {"tokens": torch.as_tensor(toks),
                                          **extra})[0]
    scale = want.abs().max().item()
    assert (full.cpu() - want).abs().max().item() <= 1e-5 * scale
    cache, _ = engine.make_prefill_step(cfg, rc, 48)(
        card, {"tokens": toks[:, :40], **on_card})
    ccache, _ = engine.make_prefill_step(cfg, rc, 48, device="cpu")(
        cpu, {"tokens": toks[:, :40], **extra})
    step = engine.make_decode_step(cfg, rc)
    cstep = engine.make_decode_step(cfg, rc, device="cpu")
    for pos in range(40, 44):
        dec, cache = step(card, cache, toks[:, pos:pos + 1], pos)
        cdec, ccache = cstep(cpu, ccache, toks[:, pos:pos + 1], pos)
        assert (dec - full[:, pos]).abs().max().item() <= 1e-5 * scale
        assert (dec.cpu() - cdec).abs().max().item() <= 1e-5 * scale
    torch.cuda.synchronize()
    assert LAUNCHES == _counts(flash_attention=2 * n_attn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_moe_layer_equals_plain_per_expert_on_the_card(cuda_device, name,
                                                       dtype):
    """Reduced widths with two padded experts, 150 tokens (64-token chunks,
    the last padded) at capacity factor 0.5, where the send buffer and the
    experts both drop assignments: the port's batched dispatch keeps
    exactly the plain version's assignments, and its output is within 1e-5
    (f32) or 2e-2 (bf16, a few ulps) of max |y|. No kernel launches."""
    from repro_torch.models import moe
    from repro_torch.models.params import init_module
    cfg = get_arch(name).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_expert_pad=2, capacity_factor=0.5))
    mod = moe.MoE(cfg, device=cuda_device, dtype=dtype)
    init_module(mod, moe.moe_schema(cfg), seed=4)
    bias = torch.randn(cfg.moe.n_experts_padded, generator=torch.Generator()
                       .manual_seed(5)).mul_(0.1).to(cuda_device)
    x = torch.randn(150, cfg.d_model, generator=torch.Generator().manual_seed(
        6)).to(cuda_device, dtype)
    reset_launch_counts()
    with torch.inference_mode():
        y, _, _, keep = moe._moe_body(cfg, mod, x, bias)
        want, want_keep = plain_moe(cfg, mod, x, bias)
    assert LAUNCHES == _counts()
    assert torch.equal(keep, want_keep) and not keep[:150].all()
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    assert (y.float() - want.float()).abs().max().item() <= \
        rel * want.float().abs().max().item()


def test_mla_decode_equals_the_decompressed_form_on_the_card(cuda_device):
    """Reduced deepseek-v3 MLA, f32: prefill over 40 tokens, then 6
    absorbed decode steps against the latent cache give what one
    decompressed ``mla_apply`` over 46 tokens gives at those positions, to
    1e-5 of its largest |y|, on the card and on the CPU; the card equals
    the CPU."""
    from repro_torch.models import attention
    from repro_torch.models.params import init_params
    cfg = get_arch("deepseek-v3-671b").reduced()
    cpu = init_params(attention.attn_schema(cfg, "attn"), seed=7,
                      device="cpu", dtype=torch.float32)
    card = {k: v.to(cuda_device) for k, v in cpu.items()}
    x = torch.randn(2, 46, cfg.d_model, generator=torch.Generator()
                    .manual_seed(8))
    got = {}
    for name, p, xs in (("card", card, x.to(cuda_device)), ("cpu", cpu, x)):
        pos = torch.arange(46, device=xs.device)
        full, _ = attention.mla_apply(cfg, p, xs, positions=pos,
                                      impl="masked", chunk=1024)
        _, cache = attention.mla_apply(cfg, p, xs[:, :40], positions=pos[:40],
                                       impl="masked", chunk=1024,
                                       make_cache=48)
        got[name] = torch.cat([attention.mla_decode(
            cfg, p, xs[:, i:i + 1], cache, i)[0] for i in range(40, 46)], 1)
        scale = full.abs().max().item()
        assert (got[name] - full[:, 40:]).abs().max().item() <= 1e-5 * scale
    assert (got["card"].cpu() - got["cpu"]).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serve_engine_card_equals_cpu(cuda_device, dtype):
    """The same requests on the card and on the CPU, f32 caches (see
    test_torch_lm.py's serve test for why): equal token lists. bf16 weights
    only have to finish every request."""
    cpu, card = _lm_pair(cuda_device, dtype)
    rng = np.random.default_rng(2)
    reqs = [engine.Request(rid=i, prompt=rng.integers(
        0, 256, size=rng.integers(4, 12)).tolist(), max_new=8)
        for i in range(6)]
    outs = []
    for params, dev in ((card, None), (cpu, "cpu")):
        eng = engine.ServeEngine(LM_CFG, RunConfig(), params, slots=4,
                                 max_len=64, device=dev)
        if dtype == torch.float32:
            eng.cache = [{"attn": {n: t.float() for n, t in c["attn"].items()}}
                         for c in eng.cache]
        mine = [engine.Request(r.rid, r.prompt, r.max_new) for r in reqs]
        for r in mine:
            eng.submit(r)
        eng.run(max_steps=63)
        assert eng.closed and all(r.done and len(r.out) == 8 for r in mine)
        outs.append([r.out for r in mine])
    if dtype == torch.float32:
        assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the streaming executor on the card: the prefetch side stream, lanes on
# streams of their own, fences on the current stream only
# ---------------------------------------------------------------------------

def _stream_jobs(codec):
    part = ZonePartitioner(0.03)
    return [neighbor_search_job(0.03, partitioner=part, codec=codec),
            neighbor_statistics_job(np.linspace(0.01, 0.03, 5) / ARCSEC,
                                    partitioner=part, codec=codec)]


def _outs(results):
    return [np.asarray(r.output).tolist() for r in results]


@pytest.mark.parametrize("codec", ["identity", "int16", "int8"])
def test_streamed_equals_monolithic_with_prefetch(cuda_device, codec):
    """Nine prefetched splits (each copied on the side stream through the
    reused pinned buffer): the monolithic outputs and launches."""
    xyz = make_catalog(40_000, 6)
    jobs = _stream_jobs(codec)
    reset_launch_counts()
    mono = run_jobs(jobs, xyz)
    want = dict(LAUNCHES)
    reset_launch_counts()
    got = run_jobs_streaming(jobs, ArraySplits(xyz, 9), prefetch=2)
    assert LAUNCHES == want
    assert _outs(got) == _outs(mono)
    st = got[0].stats
    assert st.n_splits == 9 and st.device.startswith("cuda")
    assert st.tiers == mono[0].stats.tiers
    assert 0.0 <= st.overlap_fraction <= 1.0


def test_pinned_copier_delivers_every_split_whole(cuda_device):
    """Splits whose contents differ go through the prefetch thread's one
    pinned buffer and side stream while the consumer's stream lags behind
    (a sleep kernel before each read): every split arrives whole. A buffer
    refilled before its copy ended, or a tensor's memory handed to the next
    split while the consumer still reads it, would mix two splits."""
    copier = _PinnedCopier(cuda_device)
    rows = 1 << 18
    base = np.arange(rows, dtype=np.float32)[:, None] * np.ones(3, np.float32)

    def produce(k):
        return copier(base + 1000.0 * k)

    got = []
    with Prefetcher(produce, depth=2, n=12) as pf:
        while (rec := pf.get()) is not None:
            k, item, _, _ = rec
            x = copier.receive(item)
            torch.cuda._sleep(20_000_000)
            got.append((k, x * 2.0))
            del x
    want = torch.as_tensor(base, device=cuda_device)
    assert [k for k, _ in got] == list(range(12))
    for k, y in got:
        assert torch.equal(y, 2.0 * (want + 1000.0 * k)), k


def test_lanes_equal_sequential_with_the_same_launches(cuda_device):
    """Four lanes, each on its own stream, give the sequential run's
    outputs and launches; wordcount's combine adds accumulators made on
    other lanes' streams."""
    xyz = make_catalog(40_000, 7)
    jobs = _stream_jobs("int16")
    reset_launch_counts()
    seq = run_jobs_streaming(jobs, ArraySplits(xyz, 8))
    want = dict(LAUNCHES)
    reset_launch_counts()
    lanes = run_jobs_streaming(jobs, ArraySplits(xyz, 8), n_lanes=4)
    assert LAUNCHES == want
    assert _outs(lanes) == _outs(seq)
    st = lanes[0].stats
    assert st.n_lanes == 4 and len(st.lane_walls) == 4 and st.elapsed_s > 0
    toks = np.random.default_rng(3).integers(0, 5000, 400_000)
    items = toks.astype(np.float32).reshape(-1, 1)
    res = run_job_streaming(token_histogram_job(5000), ArraySplits(items, 8),
                            n_lanes=4)
    assert res.stats.combiner == "token_count"
    np.testing.assert_array_equal(res.output,
                                  np.bincount(toks, minlength=5000))


def test_fence_waits_for_the_current_stream_only(cuda_device):
    """A kernel queued on another stream (about a second of sleep) is
    still running after ``_fence`` returns on the current stream."""
    side = torch.cuda.Stream(cuda_device)
    done = torch.cuda.Event()
    with torch.cuda.stream(side):
        torch.cuda._sleep(2_000_000_000)
        done.record(side)
    x = torch.ones(1024, device=cuda_device) * 2.0
    _fence(cuda_device)
    assert not done.query()
    assert float(x.sum()) == 2048.0
    done.synchronize()


def test_concurrent_lanes_lose_no_launch_counts(cuda_device):
    """Sixteen tasks over four lanes, each launching the masked count 50
    times on its lane's stream: every launch is counted and every result
    equals the plain version's."""
    a, b, no, nb = _on(cuda_device, masked_case(*MASKED_CASES[0]))
    want = int(ref.pair_count_masked_ref(a, b, no, nb, COS60))
    per_task = 50

    def task(cancel):
        stream = torch.cuda.current_stream(cuda_device)
        outs = [kernel.pair_count_masked_cuda(a, b, no, nb, COS60)
                for _ in range(per_task)]
        stream.synchronize()
        return stream, [int(o) for o in outs]

    reset_launch_counts()
    with LanePool(4, devices=[cuda_device]) as pool:
        for k in range(16):
            pool.submit(k, task)
        pool.drain(range(16))
    assert LAUNCHES == _counts(pair_count_masked=16 * per_task)
    default = torch.cuda.default_stream(cuda_device)
    for stream, counts in pool.results.values():
        assert stream != default and counts == [want] * per_task
    assert all(lane.stream is not None for lane in pool.lanes)


# ---------------------------------------------------------------------------
# the external shuffle on the card: ranges read back through the pinned
# copier; the card's energy counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [0, 200_000])
@pytest.mark.parametrize("n_lanes", [1, 3])
def test_spilled_equals_monolithic_on_the_card(cuda_device, tmp_path, budget,
                                               n_lanes):
    """Twelve splits spilled at two budgets, sequential and over lanes: the
    monolithic outputs, one masked launch per reducer per read-back tier,
    peak resident bytes within budget + one chunk (sequential), and no
    file left."""
    from repro_torch.mapreduce import SpillConfig
    xyz = make_catalog(40_000, 8)
    jobs = _stream_jobs("int16")
    mono = run_jobs(jobs, xyz)
    root = tmp_path / "spill"
    reset_launch_counts()
    got = run_jobs_streaming(jobs, ArraySplits(xyz, 12), n_lanes=n_lanes,
                             spill=SpillConfig(budget_bytes=budget,
                                               dir=str(root)))
    st = got[0].stats
    assert _outs(got) == _outs(mono)
    assert st.spilled_splits == 12 and st.spill_ranges >= 1
    assert LAUNCHES == _counts(pair_count_masked=len(st.tiers),
                               pair_hist_masked=len(st.tiers))
    assert st.spill_ranges <= len(st.tiers) <= 3 * st.spill_ranges
    if n_lanes == 1:
        assert st.spill_peak_bytes <= budget + st.spill_chunk_bytes
    assert not root.exists()


def test_pinned_copier_copies_mixed_dtypes_whole(cuda_device):
    """A range record's fields (int16 payload, int32 indices, f32 sort key,
    an empty field) through one pinned buffer at 16-byte offsets, the
    record grown and shrunk between copies: every field arrives whole, in
    its dtype and shape."""
    copier = _PinnedCopier(cuda_device)
    rng = np.random.default_rng(0)
    for n in (1000, 77, 5000, 3):
        fields = (rng.integers(-3000, 3000, (n, 3)).astype(np.int16),
                  rng.integers(0, 99, n).astype(np.int32),
                  rng.integers(0, 99, 2 * n + 1).astype(np.int32),
                  np.zeros(0, np.int32),
                  rng.standard_normal(n).astype(np.float32),
                  rng.integers(-127, 127, (n, 3)).astype(np.int8))
        outs = copier.receive(copier.copy(fields))
        for f, o in zip(fields, outs):
            assert o.device.type == "cuda" and tuple(o.shape) == f.shape
            assert np.array_equal(o.cpu().numpy(), f)


def test_nvml_meter_reads_the_card(cuda_device):
    """NVML's total-energy counter through ctypes: available on the card,
    monotone, and a metered run gets nonzero joules attributed by stage."""
    from repro_torch.obs import NvmlMeter, use_meter
    meter = NvmlMeter(0)
    assert meter.available
    tok = meter.begin()
    assert tok is not None and tok > 0
    xyz = make_catalog(200_000, 9)
    jobs = _stream_jobs("int16")
    deadline = time.perf_counter() + 10.0     # the counter moves in steps
    with use_meter(meter):
        while True:
            st = run_jobs(jobs, xyz)[0].stats
            if st.energy_j > 0 or time.perf_counter() > deadline:
                break
    assert meter.read_joules(tok) > 0
    assert st.energy_source == "nvml" and st.energy_j > 0
    assert st.rows_per_joule == st.n_items / st.energy_j


# ---------------------------------------------------------------------------
# the card's DeviceSpec, the calibrated cost model, auto knobs, the service
# ---------------------------------------------------------------------------

@pytest.fixture
def isolated_model(monkeypatch, tmp_path):
    """The cost model's disk cache in a tmp dir, process cache dropped."""
    from repro_torch.core import reset_cost_model
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_CALIBRATE", raising=False)
    monkeypatch.delenv("REPRO_NO_CALIBRATE", raising=False)
    reset_cost_model()
    yield tmp_path
    reset_cost_model()


def test_device_spec_reads_the_card(cuda_device):
    """SMs from the device properties, the clock and power limit from
    NVML, the rest from the data sheet; the roofline's compute peak is the
    FP32 non-fused issue rate."""
    from repro_torch.core import DATA_SHEET, device_spec
    spec = device_spec()
    assert spec is device_spec(cuda_device)              # read once
    assert spec.name == torch.cuda.get_device_name(0) and spec.name in \
        DATA_SHEET
    assert spec.sm_count == 132 and spec.sm_clock_hz > 0
    assert spec.peak_flops == 132 * 128 * spec.sm_clock_hz
    assert 0 < spec.chip_w <= 700.0
    assert spec.hbm_bw == 3.35e12 and spec.n_links == 18
    st = run_jobs(_stream_jobs("int16"), make_catalog(100_000, 3))[0].stats
    am = st.to_dict()["amdahl"]
    assert am["t_compute_s"] == st.reduce_flops / spec.peak_flops


def test_calibrated_replay_predicts_within_2x(cuda_device, isolated_model):
    """The card's counterpart of the reference's calibration check: every
    probe after the anchor predicted within 2x of its measured wall, and no
    fitted rate above the spec's peak."""
    import json
    from repro_torch.core import cost_model as cm
    from repro_torch.core import device_spec, get_cost_model
    reset_launch_counts()
    m = get_cost_model(calibrate=True)
    p = m.profile
    assert p.calibrated and len(p.probes) == len(cm.CALIBRATION_SHAPES)
    assert LAUNCHES["pair_count_masked"] == 7 * len(p.probes)
    spec = device_spec()
    assert p.flops_per_s <= spec.peak_flops and p.bytes_per_s <= spec.hbm_bw
    for (P, C1, C2, wall, flops, byts) in p.probes[1:]:
        pred = m.predict_wall(cm.StageCost(flops=flops, hbm_bytes=byts))
        assert 0.5 < pred / wall < 2.0, (P, C1, C2, pred, wall)
    saved = json.load(open(cm.cache_path(p.fingerprint)))
    assert saved["fingerprint"].startswith("cuda|" + spec.name + "|torch")


@pytest.mark.parametrize("engine", ["device", "host"])
def test_auto_knobs_on_the_card_equal_manual(cuda_device, isolated_model,
                                             engine):
    import dataclasses
    xyz = make_catalog(300_000, 4)
    hand = _stream_jobs("identity")
    auto = [dataclasses.replace(j, codec="auto", tile="auto") for j in hand]
    got = run_jobs(auto, xyz, engine=engine)
    want = run_jobs(hand, xyz, engine=engine)
    assert [np.asarray(r.output).tolist() for r in got] == \
        [np.asarray(r.output).tolist() for r in want]
    st = got[0].stats
    assert st.codec == "identity"
    if engine == "device":
        assert st.auto_tile in (64, 128, 256, 512)
        assert st.predicted_reduce_wall_s > 0 and st.prediction_error >= 1
    toks = np.random.default_rng(5).integers(0, 3000, 1_000_000)
    job = token_histogram_job(3000)
    res = run_jobs([dataclasses.replace(job, codec="auto", tile="auto")],
                   toks.astype(np.float32), engine=engine, split_rows="auto")
    assert np.array_equal(res[0].output, np.bincount(toks, minlength=3000))


@pytest.mark.parametrize("n_lanes", [1, 2])
def test_mr_service_on_the_card_equals_run_jobs(cuda_device, n_lanes):
    """The service threaded on the card (and over 2 lanes, each on a
    stream of its own): every request's output equals ``run_jobs`` of its
    job alone, and comes back as a host value."""
    from repro_torch.serving import MRQueryService
    xyz = make_catalog(200_000, 6)
    jobs = _stream_jobs("int16")
    singles = [np.asarray(run_jobs([j], xyz)[0].output).tolist()
               for j in jobs]
    svc = MRQueryService(max_batch=4, max_wait_s=0.001, n_lanes=n_lanes)
    cat = svc.load_catalog("sky", xyz, jobs[0].partitioner, codec="int16")
    assert cat.device.type == "cuda"
    reset_launch_counts()
    with svc:
        reqs = [svc.submit(jobs[i % len(jobs)], catalog="sky")
                for i in range(24)]
        outs = [r.result(timeout=120) for r in reqs]
    for i, out in enumerate(outs):
        assert not isinstance(out, torch.Tensor)
        assert np.asarray(out).tolist() == singles[i % len(jobs)]
    assert LAUNCHES["pair_count_masked"] > 0 and LAUNCHES["pair_hist_masked"] > 0
    assert sum(b["size"] for b in svc.batches) == 24
    assert svc._pool is None and svc.latency_summary()["n"] == 24


# --- the data-axis mesh on the card ---------------------------------------

MESH_N = 200_000
MESH_RANKS = 4


def _mesh_jobs(codec):
    part = ZonePartitioner(0.02)
    return [neighbor_search_job(0.02, partitioner=part, codec=codec),
            neighbor_statistics_job(np.linspace(0.005, 0.02, 6) / ARCSEC,
                                    partitioner=part, codec=codec)]


def _mesh_rank(rank, world):
    """One of ``MESH_RANKS`` gloo ranks sharing the card: the sharded device
    and host engines, streamed and spilled, and the three all-reduces of a
    bucket on (pod 2, data 2), with this rank's launch counts."""
    from repro_torch.core import collectives, compression
    from repro_torch.launch.mesh import make_mesh
    xyz = make_catalog(MESH_N, 5)
    mesh = make_mesh((world,), ("data",))
    out = {}
    for name, fn in (
            ("device", lambda j: run_jobs(j, xyz, mesh=mesh)),
            ("host", lambda j: run_jobs(j, xyz, mesh=mesh, engine="host")),
            ("stream", lambda j: run_jobs_streaming(
                j, ArraySplits(xyz, 5), mesh=mesh)),
            ("spill", lambda j: run_jobs_streaming(
                j, ArraySplits(xyz, 5), mesh=mesh, spill=0))):
        reset_launch_counts()
        res = fn(_mesh_jobs("int16"))
        torch.cuda.synchronize()
        out[name] = (_outs(res), dict(LAUNCHES), res[0].stats.n_shards)
    cmesh = make_mesh((2, world // 2), ("pod", "data"))
    g = torch.Generator(device="cuda").manual_seed(rank)
    x = torch.randn(1 << 20, generator=g, device="cuda")
    reset_launch_counts()
    flat = collectives.flat_psum(x, ("pod", "data"), mesh=cmesh)
    hier = collectives.hierarchical_psum_1d(x, "data", "pod", mesh=cmesh)
    comp = compression.compressed_psum_1d(x, ("pod", "data"), mesh=cmesh)
    torch.cuda.synchronize()
    out["collectives"] = ({k: v.cpu().numpy() for k, v in (
        ("flat", flat), ("hier", hier), ("comp", comp))}, dict(LAUNCHES), 0)
    return out


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.launch.mesh import spawn_world
    store = tmp_path_factory.mktemp("mesh") / "store"
    return spawn_world(_mesh_rank, MESH_RANKS, init_file=str(store),
                       timeout_s=600)


@pytest.mark.parametrize("name", ["device", "host", "stream", "spill"])
def test_mesh_ranks_on_the_card_equal_one_card(mesh_world, name):
    """Every rank's sharded run equals the unsharded run on the card, and
    launched the pair kernels (masked: device engine, streamed, spilled;
    unmasked: host engine) on its own rows."""
    want = _outs(run_jobs(_mesh_jobs("int16"), make_catalog(MESH_N, 5),
                          engine="host" if name == "host" else "device"))
    kern = "pair_count" if name == "host" else "pair_count_masked"
    for rank, ranks in enumerate(mesh_world):
        got, counts, n_shards = ranks[name]
        assert got == want, rank
        assert n_shards == MESH_RANKS and counts[kern] >= 1, (rank, counts)


def test_mesh_collectives_on_the_card(mesh_world):
    """hierarchical == flat (rtol 1e-6); the int8-compressed all-reduce
    within md_check's 3% of max|flat| and through the quantize kernels."""
    for rank, ranks in enumerate(mesh_world):
        vals, counts, _ = ranks["collectives"]
        scale = np.abs(vals["flat"]).max()
        np.testing.assert_allclose(vals["hier"], vals["flat"], rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(vals["comp"] - vals["flat"]).max() <= 0.03 * scale
        assert counts["quantize"] == 2 and counts["dequantize"] == 2, counts


def test_mesh_world_of_one_nccl_rank_equals_no_mesh(cuda_device):
    """A world of one NCCL rank in this process: D = 1, the unsharded
    reduce, and an all-reduce over one rank returns its input."""
    import torch.distributed as dist
    from repro_torch.core.compression import psum_1d
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        xyz = make_catalog(MESH_N, 6)
        got = run_jobs(_mesh_jobs("int8"), xyz, mesh=mesh)
        assert _outs(got) == _outs(run_jobs(_mesh_jobs("int8"), xyz))
        assert got[0].stats.n_shards == 1
        x = torch.arange(1000, dtype=torch.float32, device="cuda")
        assert torch.equal(psum_1d(x, "data", mesh=mesh), x)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat,flash_per_layer", [("full", 2), ("none", 1)])
def test_train_step_on_card_equals_cpu(cuda_device, remat, flash_per_layer):
    """Two steps of reduced TinyLlama in f32 (flash's f32 ``<16>`` on the
    card, the masked formula on the CPU) with SGD+momentum, whose update is
    linear in the gradient: the loss and grad norm within rtol 1e-4, every
    parameter within 1e-5 of its max. The flash kernel launches once a
    layer in the forward, and once more in the recompute under
    ``remat="full"``; nothing else launches."""
    from repro_torch.training import make_train_step
    from repro_torch.training.state import state_for
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").reduced(),
                              optimizer="sgdm")
    rc = RunConfig(remat=remat, warmup_steps=0, steps=4, learning_rate=1e-2)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 64))
    out = {}
    for dev in ("cpu", cuda_device):
        # drawn on the CPU (a generator on the card draws other numbers)
        lm = mdl.init(cfg, 0, device="cpu", dtype=torch.float32).to(dev)
        st = state_for(cfg, rc, lm)
        fn = make_train_step(cfg, rc)
        reset_launch_counts()
        mets = [fn(st, {"tokens": toks})[1] for _ in range(2)]
        out[str(dev)] = (dict(LAUNCHES), [{k: v.item() for k, v in m.items()}
                                          for m in mets],
                         {n: p.detach().cpu() for n, p in
                          st["params"].named_parameters()})
    (_, want, wp), (counts, got, gp) = out["cpu"], out["cuda"]
    assert counts == _counts(flash_attention=2 * flash_per_layer
                             * cfg.n_layers)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    for n, w in wp.items():
        assert (gp[n] - w).abs().max() <= 1e-5 * w.abs().max(), n


def test_ef_compress_quantizers_equal_plain_bitwise(cuda_device):
    """``ef_compress`` of a gradient bucket on the card runs the quantize
    and dequantize kernels (one launch each) and equals the plain
    versions on the CPU bit for bit, residual included."""
    g = torch.Generator().manual_seed(3)
    grad = torch.randn(70_000, generator=g) * 1e-3
    err = torch.randn(70_000, generator=g) * 1e-6
    reset_launch_counts()
    sent, new_err = compression.ef_compress(grad.to(cuda_device),
                                            err.to(cuda_device))
    assert _counts(quantize=1, dequantize=1) == dict(LAUNCHES)
    want_sent, want_err = compression.ef_compress(grad, err)
    assert torch.equal(sent.cpu().view(torch.int32),
                       want_sent.view(torch.int32))
    assert torch.equal(new_err.cpu().view(torch.int32),
                       want_err.view(torch.int32))


def test_compressed_train_step_launches_the_quantizers(cuda_device):
    """The replicated step with ``compress_grads`` on one card compresses
    each gradient bucket once (error feedback; no collective on one
    rank): one quantize and one dequantize launch per bucket a step."""
    from repro_torch.training import make_train_step
    from repro_torch.training.state import init_state, make_bucket_plan
    cfg = get_arch("tinyllama-1.1b").reduced()
    rc = RunConfig(pod_param_mode="replicated", compress_grads=True,
                   bucket_bytes=40_000)
    st = init_state(cfg, rc, 0, device=cuda_device)
    n = len(make_bucket_plan(cfg, rc, lm=st["params"]).bucket_sizes)
    assert n > 1
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 32))
    fn = make_train_step(cfg, rc)
    reset_launch_counts()
    st, mets = fn(st, {"tokens": toks})
    assert LAUNCHES["quantize"] == n and LAUNCHES["dequantize"] == n
    assert np.isfinite(mets["loss"].item())
    assert len(st["ef"]) == n


# ---------------------------------------------------------------------------
# FSDP on gloo ranks sharing the card
# ---------------------------------------------------------------------------

FSDP_RANKS = 2


def _fsdp_tokens(cfg):
    return [np.random.default_rng(40 + i).integers(0, cfg.vocab, (4, 32))
            for i in range(3)]


def _fsdp_steps(cfg, rc, mesh=None):
    from repro_torch.training import make_train_step
    from repro_torch.training.state import checkpoint_leaves, init_state
    st = init_state(cfg, rc, 0, mesh, device="cuda", dtype=torch.float32)
    fn = make_train_step(cfg, rc, mesh)
    mets = []
    for toks in _fsdp_tokens(cfg):
        st, m = fn(st, {"tokens": toks})
        mets.append({k: v.item() for k, v in m.items()})
    return mets, {k: lf.get().cpu().numpy() for k, lf in
                  checkpoint_leaves(st).items() if k.startswith("params/")}


def _fsdp_rank(rank, world):
    """One rank: the weights' gather and the gradients' reduce-scatter on
    CUDA tensors of two dtypes and odd shapes, then 3 FSDP steps."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.fsdp import Fsdp
    mesh = make_mesh((world,), ("data",))
    fs = Fsdp(mesh, ("data",))
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(7, 5), (3,), (2, 3, 9)]
    fulls = [torch.randn(s, generator=g, device="cuda") for s in shapes]
    fulls[1] = fulls[1].to(torch.bfloat16)
    shards = [fs.shard(f).requires_grad_(True) for f in fulls]
    got = fs.gather(shards, shapes)
    gathered = all(torch.equal(a, b) for a, b in zip(got, fulls))
    loss = sum((x.float() * (rank + 1)).sum() for x in got)
    grads = torch.autograd.grad(loss, shards)
    # the sum over ranks of d/dx (rank + 1) x: world (world + 1) / 2 a cell
    want = world * (world + 1) / 2
    scattered = all(torch.all(gr[:fs.spec(s).rows * fs.spec(s).c] == want)
                    if rank == 0 else True
                    for gr, s in zip(grads, shapes))
    cfg = get_arch("tinyllama-1.1b").reduced()
    rc = RunConfig(warmup_steps=1, steps=4, learning_rate=1e-3)
    mets, params = _fsdp_steps(cfg, rc, mesh)
    return {"gathered": gathered, "scattered": scattered, "metrics": mets,
            "params": params}


@pytest.fixture(scope="module")
def fsdp_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.launch.mesh import spawn_world
    store = tmp_path_factory.mktemp("fsdp") / "store"
    return spawn_world(_fsdp_rank, FSDP_RANKS, init_file=str(store),
                       timeout_s=600)


def test_fsdp_gather_and_reduce_scatter_on_the_card(fsdp_world):
    """``Fsdp.gather`` on CUDA shards of f32 and bf16 tensors whose rows do
    not split evenly gives the whole tensors on every rank, and its
    backward reduce-scatters the sum of the ranks' gradients."""
    for rank, r in enumerate(fsdp_world):
        assert r["gathered"] and r["scattered"], rank


def test_fsdp_ranks_on_the_card_equal_one_rank(fsdp_world, cuda_device):
    """Two gloo ranks sharing the card, "sharded" FSDP, 3 steps of a 4-row
    batch (2 rows a rank): every step's metrics within rtol 1e-5 of one
    rank's step on the whole batch (1e-4 after the first update), the
    gathered parameters equal on both ranks and within 2e-5 of each
    leaf's max of one rank's but the Adam flips (twice the learning
    rate)."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    rc = RunConfig(warmup_steps=1, steps=4, learning_rate=1e-3)
    want, params = _fsdp_steps(cfg, rc)
    for r in fsdp_world:
        for i, (g, w) in enumerate(zip(r["metrics"], want, strict=True)):
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-5 if i < 2
                                             else 1e-4), (i, k)
        for k, w in params.items():
            assert np.array_equal(r["params"][k], fsdp_world[0]["params"][k])
            d = np.abs(r["params"][k] - w)
            top = np.abs(w).max()
            assert np.mean(d > 2e-5 * top) <= 1e-3 and d.max() <= 2e-3, k


# ---------------------------------------------------------------------------
# the census on the card sees the kernels' custom ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 96])
def test_census_charges_a_flash_launch_its_attended_pairs(cuda_device,
                                                          window):
    """The flash forward is a custom op, so the operation census sees its
    launch (before it went through ctypes below the dispatch mode and was
    charged nothing): one ``repro_torch::flash_attention_fwd``, attended
    pairs x 4 x dh FLOPs, the bytes of q, k, v and o."""
    from repro_torch.core.op_census import attended_pairs, census
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, S, H, Kv, dh = 2, 256, 8, 2, 64
    q = torch.randn(B, S, H, dh, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(B, S, Kv, dh, generator=g, device=cuda_device,
                        dtype=torch.bfloat16) for _ in range(2))
    reset_launch_counts()
    with census() as c:
        fops.flash_attention(q, k, v, True, window, 0.0, None)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert c.ops["repro_torch::flash_attention_fwd"] == 1
    assert c.flops == 4.0 * B * H * dh * attended_pairs(S, window) > 0
    assert c.hbm_bytes == 2 * (q.numel() + 2 * k.numel() + q.numel())


def test_census_of_a_meta_step_equals_the_cards(cuda_device):
    """A 2-layer TinyLlama train step (bf16, 2 x 256) on the card and the
    same step on ``meta`` under ``card_routing``: the same operators, op by
    op, the same FLOPs, element-wise FLOPs and bytes, and the same argument
    bytes."""
    from repro_torch.kernels import card_routing
    from repro_torch.launch.dryrun import run_step
    from repro_torch.training.state import abstract_state, init_state
    from repro_torch.training.step import make_train_step
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), n_layers=2)
    rc = RunConfig()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 256),
                                             dtype=np.int32)
    real = run_step(make_train_step(cfg, rc),
                    (init_state(cfg, rc, 0), {"tokens": torch.as_tensor(
                        toks, device=cuda_device)}))
    with card_routing():
        dry = run_step(make_train_step(cfg, rc),
                       (abstract_state(cfg, rc), {"tokens": torch.empty(
                           (2, 256), dtype=torch.int32, device="meta")}))
    assert dict(real[0].ops) == dict(dry[0].ops)
    assert real[0].ops["repro_torch::flash_attention_fwd"] == 4
    for f in ("flops", "ew_flops", "hbm_bytes"):
        assert getattr(real[0], f) == getattr(dry[0], f), f
    assert (real[1]["argument_bytes_per_device"]
            == dry[1]["argument_bytes_per_device"])
