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
                              FLASH_EDGE_CASES, HIST_EDGE_SETS, MASKED_CASES,
                              close_pairs_case, flash_case, masked_case,
                              quantize_case)
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
