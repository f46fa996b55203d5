"""The port's block int8 quantizer, compression module and host codecs held
against the JAX package's.

The JAX package computes the block scale two ways. Eagerly (``quantize_ref``
called op by op, and ``core/compression.py``'s ``quantize_block``, which
the int8 shuffle codec runs) it divides, ``max|x| / 127``. Under ``jax.jit``
(``jax.jit(quantize_ref)``, and ``quantize_pallas(interpret=True)``, which
is traced) the compiler rewrites the division by a constant into a
multiplication by ``f32(1/127)``, one ulp away in about 4% of the blocks.
The port divides (``__fdiv_rn`` in the CUDA kernel), so it is held bitwise
to the eager reference and the int8 codec, and to the traced kernel block
by block wherever the two scales agree.

The CUDA kernels have no CPU mode: their tests are in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.mapreduce as R  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.kernels.quantize.kernel import (dequantize_pallas,  # noqa: E402
                                           quantize_pallas)
from repro.kernels.quantize.ref import (dequantize_ref as jdq,  # noqa: E402
                                        quantize_ref as jq)
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.kernels.quantize import kernel, ops, ref  # noqa: E402
from test_torch_cases import quantize_case  # noqa: E402

SHAPES = [(8, 256), (16, 1024), (8, 2048)]       # tests/test_kernels.py


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bf16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.as_tensor(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.as_tensor(x)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("rows,cols", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "bf16-valued f32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_ref_bitwise_matches_eager_jax(rows, cols, dtype, seed):
    x = quantize_case(rows, cols, seed, bf16_valued=dtype != "f32")
    jx, tx = _pair(x, "bf16" if dtype == "bf16" else "f32")
    q, s = ref.quantize_ref(tx)
    jqq, js = jq(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    back = ref.dequantize_ref(q, s)
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(jdq(jqq, js)))


@pytest.mark.parametrize("rows,cols", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_ref_against_pallas_interpret(rows, cols, dtype):
    """Codes equal wherever the traced kernel's scale equals the divided
    one; elsewhere its scale is amax * f32(1/127), one ulp off."""
    x = quantize_case(rows, cols, 3, bf16_valued=dtype == "bf16")
    jx, tx = _pair(x, dtype)
    q, s = ref.quantize_ref(tx)
    pq, ps = (np.array(a) for a in quantize_pallas(jx, interpret=True))
    amax = np.abs(np.asarray(jx, np.float32)).reshape(rows, -1, 256).max(-1)
    np.testing.assert_array_equal(
        _bits(ps), _bits(np.maximum(amax * np.float32(1 / 127), 1e-12)))
    same = ps == s.numpy()
    ulps = np.abs(_bits(ps).astype(np.int64) - _bits(s.numpy()))
    assert same.any() and ulps.max() <= 1
    codes = q.numpy().reshape(rows, -1, 256)
    np.testing.assert_array_equal(codes[same], pq.reshape(rows, -1, 256)[same])
    diff = np.abs(codes.astype(np.int32) - pq.reshape(rows, -1, 256))
    assert diff.max() <= 1
    # dequantize of identical (q, s): the kernel, both refs and the port
    pd = dequantize_pallas(jnp.asarray(pq), jnp.asarray(ps), interpret=True)
    td = ref.dequantize_ref(torch.as_tensor(pq), torch.as_tensor(ps))
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(pd))
    np.testing.assert_array_equal(_bits(td.numpy()),
                                  _bits(jdq(jnp.asarray(pq), jnp.asarray(ps))))


def test_quantize_edge_cases():
    """An all-zero block takes the 1e-12 floor and codes 0; values whose
    quotient lands on .5 round half to even; the block maximum codes 127."""
    x = np.zeros((2, 512), np.float32)
    x[1, :5] = [127.0, 0.5, 1.5, 2.5, -2.5]          # scale exactly 1.0
    x[1, 256:260] = [-3.0, 1.5, -0.5, 0.0]           # scale 3/127
    q, s = ref.quantize_ref(torch.as_tensor(x))
    jqq, js = jq(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    assert s[0].tolist() == [np.float32(1e-12)] * 2 and not q[0].any()
    assert s[1, 0].item() == 1.0
    assert q[1, :5].tolist() == [127, 0, 2, 2, -2]
    assert q[1, 256] == -127


@pytest.mark.parametrize("n", [1, 255, 256, 257, 3001])
@pytest.mark.parametrize("seed", [0, 1])
def test_compression_bitwise_matches_jax(n, seed):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    q, s, m = tcomp.quantize_block(torch.as_tensor(x))
    jqq, js, jm = jcomp.quantize_block(jnp.asarray(x))
    assert m == jm == n
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    back = tcomp.dequantize_block(q, s, n)
    np.testing.assert_array_equal(_bits(back.numpy()),
                                  _bits(jcomp.dequantize_block(jqq, js, n)))
    rt = tcomp.compress_roundtrip(torch.as_tensor(x))
    np.testing.assert_array_equal(_bits(rt.numpy()),
                                  _bits(jcomp.compress_roundtrip(
                                      jnp.asarray(x))))
    assert tcomp.int8_wire_bytes(n) == jcomp.int8_wire_bytes(n)


@pytest.mark.parametrize("n,scale,seed", [(1, 1e-3, 0), (255, 1.0, 1),
                                          (257, 1e3, 2), (1000, 7.5, 3),
                                          (2000, 0.01, 4)])
def test_quantization_error_bound(n, scale, seed):
    """|x - dq(q(x))| <= per-block max/127/2 + eps, elementwise (the
    property of tests/test_compression.py)."""
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=n) * scale,
                        dtype=torch.float32)
    q, s, m = tcomp.quantize_block(x)
    back = tcomp.dequantize_block(q, s, m)
    pad = (-n) % tcomp.BLOCK
    xp = np.pad(x.numpy(), (0, pad)).reshape(-1, tcomp.BLOCK)
    bound = np.abs(xp).max(axis=1, keepdims=True) / 127.0 * 0.51 + 1e-9
    err = np.pad(np.abs(back.numpy() - x.numpy()), (0, pad))
    assert np.all(err.reshape(-1, tcomp.BLOCK) <= bound)


def test_compress_roundtrip_shape_preserved():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 5, 7)),
                        dtype=torch.bfloat16)
    y = tcomp.compress_roundtrip(x)
    assert y.shape == x.shape and y.dtype == x.dtype
    want = jcomp.compress_roundtrip(jnp.asarray(x.float().numpy()
                                                ).astype(jnp.bfloat16))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(want, np.float32))
    q, s, n = tcomp.quantize_block(torch.zeros(0))
    assert q.shape == (0,) and s.shape == (0,) and n == 0


# ---------------------------------------------------------------------------
# the codecs' host transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["identity", "int16", "int8"])
@pytest.mark.parametrize("n,d,seed", [(1, 1, 0), (7, 3, 1), (256, 3, 2),
                                      (1000, 3, 3), (513, 2, 4)])
def test_host_codec_bitwise_matches_jax(name, n, d, seed):
    x = np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(np.float32)
    tc, jc = T.get_codec(name), R.get_codec(name)
    te, je = tc.encode(torch.as_tensor(x)), jc.encode(x)
    assert te.wire_bytes == je.wire_bytes == tc.nbytes(x.size)
    assert sum(a.numel() * a.element_size() for a in te.arrays) == \
        te.wire_bytes
    assert te.shape == je.shape and te.codec == je.codec
    for t, j in zip(te.arrays, je.arrays):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                      j.view(np.uint8))
    back = tc.roundtrip(x).numpy()
    np.testing.assert_array_equal(_bits(back), _bits(jc.roundtrip(x)))
    np.testing.assert_array_equal(_bits(tc.decode(te).numpy()), _bits(back))
    assert back.shape == x.shape
    assert np.max(np.abs(back - x)) <= tc.error_bound(x) + 1e-7
    assert tc.error_bound(x) == jc.error_bound(x)
    assert tc.exact == jc.exact


@pytest.mark.parametrize("block", [64, 128, 512])
def test_int8_codec_custom_block_matches_jax(block):
    x = np.random.default_rng(7).normal(size=(300,)).astype(np.float32)
    tc, jc = T.Int8BlockCodec(block=block), R.Int8BlockCodec(block=block)
    np.testing.assert_array_equal(_bits(tc.roundtrip(x).numpy()),
                                  _bits(jc.roundtrip(x)))
    assert tc.encode(x).wire_bytes == tc.nbytes(x.size) == jc.nbytes(x.size)


def test_wordcount_int16_codec_roundtrip_matches_jax():
    toks = np.random.default_rng(1).integers(0, 900, 4000).astype(np.float32)
    tc, jc = T.Int16Codec(max_abs=900.0), R.Int16Codec(max_abs=900.0)
    np.testing.assert_array_equal(_bits(tc.roundtrip(toks).numpy()),
                                  _bits(jc.roundtrip(toks)))
    assert np.array_equal(np.round(tc.roundtrip(toks).numpy()), toks)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_plain_version_and_kernel_refuses_it():
    x = torch.as_tensor(quantize_case(8, 256, 0))
    before = dict(kernel.LAUNCHES)
    q, s = ops.quantize(x)
    wq, ws = ref.quantize_ref(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert torch.equal(ops.dequantize(q, s), ref.dequantize_ref(q, s))
    assert kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.quantize_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.dequantize_cuda(q, s)
    assert kernel.LAUNCHES == before
