"""The port's flash attention against the JAX package's on the CPU: the
plain version (``ref.attention_ref``) and the dispatch (``ops``, which
takes the plain version for a CPU tensor) against the Pallas kernel in
interpret mode and the JAX oracle, on the same numpy inputs. The CUDA
kernel itself is checked on the card (``test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from test_torch_cases import (FLASH_CASES, FLASH_EDGE_CASES,  # noqa: E402
                              FLASH_FAMILY_CASES, flash_case)

# test_flash_sweep's tolerances: f32 to 2e-6; bf16 to 3e-2, a few bf16 ulps
# of outputs below 1 (p is rounded to bf16 before the context product)
ATOL = {"float32": 2e-6, "bfloat16": 3e-2}


def _both(arrs, dtype):
    """The same numpy draws as JAX and torch arrays of ``dtype`` (both
    round f32 to bf16 to nearest even, so the values are equal)."""
    j = tuple(jnp.asarray(a).astype(dtype) for a in arrs)
    t = tuple(torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs)
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax(case, dtype):
    S, H, Kv, dh, window, cap = case
    (jq, jk, jv), (q, k, v) = _both(flash_case(S, H, Kv, dh), dtype)
    kw = dict(causal=True, window=window, softcap=cap)
    want_pallas = flash_attention_pallas(jq, jk, jv, bq=64, bk=64,
                                         interpret=True, **kw)
    want_ref = jax_ref(jq, jk, jv, **kw)
    reset_launch_counts()
    got_ref = ref.attention_ref(q, k, v, **kw)
    got_ops = ops.flash_attention(q, k, v, True, window, cap)
    assert LAUNCHES["flash_attention"] == 0          # the CPU launches nothing
    assert got_ref.dtype == got_ops.dtype == q.dtype
    for got in (got_ref, got_ops):
        for want in (want_pallas, want_ref):
            np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                                       rtol=0)


@pytest.mark.parametrize("causal,scale", [(False, None), (True, 0.3)])
def test_flash_options_match_jax(causal, scale):
    (jq, jk, jv), (q, k, v) = _both(flash_case(96, 4, 2, 32, seed=1),
                                    "float32")
    want = jax_ref(jq, jk, jv, causal=causal, window=40, softcap=20.0,
                   scale=scale)
    got = ops.flash_attention(q, k, v, causal, 40, 20.0, scale)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"],
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ["gemma2", "recurrentgemma"])
def test_flash_family_instances_match_jax(case, causal):
    """gemma2's and recurrentgemma's f32 instances as the card's tests draw
    them (``FLASH_FAMILY_CASES``: head dim 256, 8/4 heads, window, softcap
    50 and scale 1/16; 10/1 heads, window): the plain version, which the
    card holds the kernel to, and the dispatch against the Pallas kernel in
    interpret mode and the JAX oracle."""
    dtype, S, H, Kv, dh, window, cap, scale, B = FLASH_FAMILY_CASES[case]
    assert dtype == torch.float32
    (jq, jk, jv), (q, k, v) = _both(flash_case(S, H, Kv, dh, seed=S + H, B=B),
                                    "float32")
    kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
    want_pallas = flash_attention_pallas(jq, jk, jv, bq=64, bk=64,
                                         interpret=True, **kw)
    want_ref = jax_ref(jq, jk, jv, **kw)
    got_ref = ref.attention_ref(q, k, v, **kw)
    got_ops = ops.flash_attention(q, k, v, causal, window, cap, scale)
    for got in (got_ref, got_ops):
        for want in (want_pallas, want_ref):
            np.testing.assert_allclose(_np(got), _np(want),
                                       atol=ATOL["float32"], rtol=0)


def test_flash_backward_matches_jax():
    """test_flash_custom_vjp_backward's case: the gradient through the
    autograd Function (backward recomputes through attention_ref) against
    jax.grad through the custom_vjp, for q, k and v."""
    arrs = flash_case(64, 2, 2, 16, seed=2, B=1)
    jarrs = tuple(map(jnp.asarray, arrs))
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash(q, k, v, True, 0, 0.0,
                                                      None, False)),
                    argnums=(0, 1, 2))(*jarrs)
    q, k, v = (torch.as_tensor(a).requires_grad_() for a in arrs)
    ops.flash_attention(q, k, v).sum().backward()
    for got, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_flash_kernel_refuses_a_cpu_tensor():
    q, k, v = (torch.as_tensor(a) for a in flash_case(*FLASH_CASES[0][:4]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention_cuda(q, k, v)
