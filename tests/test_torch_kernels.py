"""The port's zones pair kernels held against the JAX package's.

Scores, masked counts and cumulative histograms of ``repro_torch`` against
the JAX package's refs and its Pallas kernels in interpret mode, on inputs
made from numpy seeds. Every count and histogram must be equal and every
score bit-identical. The JAX refs run eagerly, one op at a time, which is
the rounded formulation they document: under ``jax.jit`` the CPU compiler
contracts the products into FMAs and moves scores that sit on a threshold.

The CUDA kernels have no CPU mode: their tests are in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.zones_pairs import ref as jref  # noqa: E402
from repro.kernels.zones_pairs.kernel import (  # noqa: E402
    pair_count_masked_pallas, pair_count_pallas, pair_hist_masked_pallas,
    pair_hist_pallas)
from repro_torch.kernels.zones_pairs import kernel, ops, ref  # noqa: E402
from repro_torch.data.sky import make_catalog  # noqa: E402
from test_torch_cases import (ARCSEC, COS60, HIST_EDGE_SETS,  # noqa: E402
                         MASKED_CASES,
                         close_pairs_case as _close_pairs_case,
                         masked_case as _masked_case, rotate as _rotate)

def _t(x):
    return torch.as_tensor(np.asarray(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# scores: bit-identical to the JAX package's rounded formulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dots2d_bitwise_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = make_catalog(64, seed)
    b = _rotate(np.repeat(a, 2, axis=0), rng.uniform(0, 90, 128) * ARCSEC, rng)
    got = ref._batched_dots(_t(a)[None], _t(b)[None]).numpy()[0]
    want = np.asarray(jref._dots2d(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # numpy in f32 with a rounding after every op is a third witness
    p = [(a[:, None, k] * b[None, :, k]).astype(np.float32) for k in range(3)]
    np.testing.assert_array_equal(_bits(got), _bits((p[0] + p[1]) + p[2]))


def test_batched_dots_bitwise_matches_jax_on_threshold():
    a, b, _, _ = _close_pairs_case()
    got = ref._batched_dots(_t(a), _t(b)).numpy()
    want = np.asarray(jref._batched_dots(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.sum(got == COS60) >= 2          # scores that sit ON the edge


def test_threshold_compare_is_f32():
    """A score equal to f32 cos(60") counts; one ulp below does not. With
    the threshold compared in f64 the scores equal to it would not count."""
    a, b, _, _ = _close_pairs_case()
    cnt = ref.pair_count_ref(_t(a[0, :4]), _t(b[0, 8:12]),
                             _t(np.float32(COS60)))
    want = jref.pair_count_ref(jnp.asarray(a[0, :4]), jnp.asarray(b[0, 8:12]),
                               float(np.cos(60 * ARCSEC)))
    assert int(cnt) == int(want) == 4 * 3      # 1.0, COS60 and COS60 + ulp


@pytest.mark.parametrize("exclude_self", [False, True])
def test_unmasked_refs_match_jax(exclude_self):
    a, b, _, _ = _close_pairs_case(P=1)
    a, b = a[0], b[0]
    e = np.cos(np.arange(1, 61) * ARCSEC).astype(np.float32)
    for arcsec in (15, 60, 0.05 / ARCSEC):
        cmin = float(np.cos(arcsec * ARCSEC))
        got = ref.pair_count_ref(_t(a), _t(b), cmin, exclude_self=exclude_self)
        want = jref.pair_count_ref(jnp.asarray(a), jnp.asarray(b), cmin,
                                   exclude_self=exclude_self)
        assert int(got) == int(want), arcsec
    got = ref.pair_hist_ref(_t(a), _t(b), _t(e), exclude_self=exclude_self)
    want = jref.pair_hist_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(e),
                              exclude_self=exclude_self)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


# ---------------------------------------------------------------------------
# batched unmasked plain versions (the host engine's reduce) vs the JAX refs
# summed over partitions, and vs Pallas (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,C1,C2,n_o,n_b", MASKED_CASES[:4])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_batched_unmasked_refs_match_jax_summed(P, C1, C2, n_o, n_b,
                                                exclude_self):
    """Every row is scored, padding included (here: zero rows past the
    real counts, as the host engine pads): the sum over partitions of the
    JAX package's per-partition refs."""
    a, b, no, nb = _masked_case(P, C1, C2, n_o, n_b, seed=11)
    for x, n in ((a, no), (b, nb)):
        for p in range(P):
            x[p, n[p]:] = 0.0
    b[:, :min(C1, C2) // 2] = a[:, :min(C1, C2) // 2]   # real self pairs
    e = np.cos(np.linspace(0.02, 0.4, 5)).astype(np.float32)[[3, 0, 4, 1, 2]]
    for radius in (0.05, 0.3):
        cmin = float(np.cos(radius))
        got = ref.pair_count_ref(_t(a), _t(b), cmin, exclude_self=exclude_self)
        want = sum(int(jref.pair_count_ref(jnp.asarray(a[p]), jnp.asarray(b[p]),
                                           cmin, exclude_self=exclude_self))
                   for p in range(P))
        assert int(got) == want, radius
    got = ref.pair_hist_ref(_t(a), _t(b), _t(e), exclude_self=exclude_self)
    want = sum(np.asarray(jref.pair_hist_ref(jnp.asarray(a[p]),
                                             jnp.asarray(b[p]),
                                             jnp.asarray(e),
                                             exclude_self=exclude_self),
                          np.int64) for p in range(P))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,tm,tn", [(256, 256, 256, 256),
                                       (512, 256, 256, 256),
                                       (512, 512, 128, 256)])
@pytest.mark.parametrize("radius", [0.02, 0.1])
def test_unmasked_count_matches_pallas(m, n, tm, tn, radius):
    """The shapes of tests/test_kernels.py::test_pair_count_sweep."""
    a, b = make_catalog(m, 1), make_catalog(n, 2)
    cm = float(np.cos(radius))
    pallas = pair_count_pallas(jnp.asarray(a), jnp.asarray(b), cm, tm=tm,
                               tn=tn, interpret=True)
    assert int(ref.pair_count_ref(_t(a), _t(b), cm)) == int(pallas)
    a2 = make_catalog(256, 3)
    pallas = pair_count_pallas(jnp.asarray(a2), jnp.asarray(a2), cm,
                               exclude_self=True, tm=128, tn=128,
                               interpret=True)
    assert int(ref.pair_count_ref(_t(a2), _t(a2), cm,
                                  exclude_self=True)) == int(pallas)


@pytest.mark.parametrize("nbins", [4, 16, 60, "duplicates", "below_zero",
                                   "below_minus_two"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_unmasked_hist_matches_pallas(nbins, exclude_self):
    """``nbins`` names an edge set of ``HIST_EDGE_SETS`` or a count of
    descending edges; a named set also gets zero padding rows, as the host
    engine pads, which score 0 and pass an edge below 0."""
    a, b = make_catalog(256, 4), make_catalog(512, 5)
    b[:256] = a if exclude_self else b[:256]
    if isinstance(nbins, str):
        e = HIST_EDGE_SETS[nbins]
        a[200:], b[400:] = 0.0, 0.0
    else:
        e = np.cos(np.linspace(0.01, 0.2, nbins)).astype(np.float32)
    pallas = pair_hist_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(e),
                              exclude_self=exclude_self, tm=256, tn=256,
                              interpret=True)
    got = ref.pair_hist_ref(_t(a), _t(b), _t(e), exclude_self=exclude_self)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas, np.int64))
    want = jref.pair_hist_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(e),
                              exclude_self=exclude_self)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


# ---------------------------------------------------------------------------
# masked plain versions vs Pallas (interpret) and the JAX refs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,C1,C2,n_o,n_b", MASKED_CASES)
@pytest.mark.parametrize("radius", [0.05, 0.3])
def test_pair_count_masked_matches_jax(P, C1, C2, n_o, n_b, radius):
    a, b, no, nb = _masked_case(P, C1, C2, n_o, n_b)
    cmin = float(np.cos(radius))
    got = int(ref.pair_count_masked_ref(_t(a), _t(b), _t(no), _t(nb), cmin))
    ja, jb, jno, jnb = map(jnp.asarray, (a, b, no, nb))
    pallas = pair_count_masked_pallas(ja, jb, jno, jnb, cmin, tm=64, tn=64,
                                      interpret=True)
    want = jref.pair_count_masked_ref(ja, jb, jno, jnb, cmin)
    assert got == int(pallas) == int(want)


@pytest.mark.parametrize("P,C1,C2,n_o,n_b", MASKED_CASES)
@pytest.mark.parametrize("edges", ["3", "17", "unsorted", "duplicates",
                                   "below_zero", "below_minus_two"])
def test_pair_hist_masked_matches_jax(P, C1, C2, n_o, n_b, edges):
    """An edge below 0 would count every padding cell (zero rows score 0)
    if the mask let one through. The JAX package scores a masked-out cell
    -2 (``_hist_masked_kernel``, ``pair_hist_masked_ref``), so its count at
    an edge at or below -2 also holds every padding cell; the port counts
    the real cells only, as both docstrings define the function. At those
    edges the JAX count is the port's plus the padding cells, exactly."""
    a, b, no, nb = _masked_case(P, C1, C2, n_o, n_b, seed=7)
    for x, n in ((a, no), (b, nb)):
        for p in range(P):
            x[p, n[p]:] = 0.0
    if edges in HIST_EDGE_SETS:
        e = HIST_EDGE_SETS[edges]
    else:
        nbins = 5 if edges == "unsorted" else int(edges)
        e = np.cos(np.linspace(0.02, 0.4, nbins)).astype(np.float32)
        if edges == "unsorted":
            e = e[[3, 0, 4, 1, 2]]
    got = ref.pair_hist_masked_ref(_t(a), _t(b), _t(no), _t(nb), _t(e))
    padding = P * C1 * C2 - int(np.sum(no.astype(np.int64) * nb))
    jax_got = got.numpy() + np.where(e <= -2.0, padding, 0)
    ja, jb, jno, jnb, je = map(jnp.asarray, (a, b, no, nb, e))
    pallas = pair_hist_masked_pallas(ja, jb, jno, jnb, je, tm=64, tn=64,
                                     interpret=True)
    np.testing.assert_array_equal(jax_got, np.asarray(pallas, np.int64))
    # the JAX ref takes edges sorted descending: give it them so, and put
    # its counts back in the order of e
    order = np.argsort(-e, kind="stable")
    want = np.empty(len(e), np.int64)
    want[order] = np.asarray(jref.pair_hist_masked_ref(
        ja, jb, jno, jnb, jnp.asarray(e[order])), np.int64)
    np.testing.assert_array_equal(jax_got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_plain_on_arcsec_pairs_matches_jax(seed):
    """Pairs 0..70" apart against the paper's radii and the default
    60-edge arcsec set: every pair sits a few ulps from its threshold."""
    a, b, no, nb = _close_pairs_case(seed=seed)
    ja, jb, jno, jnb = map(jnp.asarray, (a, b, no, nb))
    for arcsec in (15, 30, 60):
        cmin = float(np.cos(arcsec * ARCSEC))
        got = ref.pair_count_masked_ref(_t(a), _t(b), _t(no), _t(nb), cmin)
        want = jref.pair_count_masked_ref(ja, jb, jno, jnb, cmin)
        assert int(got) == int(want), arcsec
    e = np.cos(np.arange(1, 61) * ARCSEC).astype(np.float32)
    got = ref.pair_hist_masked_ref(_t(a), _t(b), _t(no), _t(nb), _t(e))
    want = jref.pair_hist_masked_ref(ja, jb, jno, jnb, jnp.asarray(e))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))
    assert got[-1] > got[0] > 0


def test_hist_unsorted_edges_is_a_permutation():
    a, b, no, nb = map(_t, _close_pairs_case(seed=3))
    e = np.cos(np.arange(1, 61) * ARCSEC).astype(np.float32)
    perm = np.random.default_rng(0).permutation(60)
    sorted_out = ref.pair_hist_masked_ref(a, b, no, nb, _t(e))
    perm_out = ref.pair_hist_masked_ref(a, b, no, nb, _t(e[perm]))
    np.testing.assert_array_equal(perm_out.numpy(), sorted_out.numpy()[perm])


def test_chunked_plain_equals_one_block(monkeypatch):
    """Chunking the partition loop changes nothing."""
    a, b, no, nb = map(_t, _masked_case(*MASKED_CASES[3]))
    e = _t(np.cos(np.linspace(0.02, 0.4, 9)).astype(np.float32))
    whole_c = ref.pair_count_masked_ref(a, b, no, nb, np.cos(0.3))
    whole_h = ref.pair_hist_masked_ref(a, b, no, nb, e)
    whole_u = [(ref.pair_count_ref(a, b, np.cos(0.3), exclude_self=x),
                ref.pair_hist_ref(a, b, e, exclude_self=x))
               for x in (False, True)]
    monkeypatch.setattr(ref, "_CHUNK_CELLS", 1)       # one partition a chunk
    assert int(ref.pair_count_masked_ref(a, b, no, nb, np.cos(0.3))) == \
        int(whole_c)
    assert torch.equal(ref.pair_hist_masked_ref(a, b, no, nb, e), whole_h)
    for x, (c, h) in zip((False, True), whole_u):
        assert int(ref.pair_count_ref(a, b, np.cos(0.3), exclude_self=x)) \
            == int(c)
        assert torch.equal(ref.pair_hist_ref(a, b, e, exclude_self=x), h)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_plain_version_and_kernel_refuses_it():
    a, b, no, nb = map(_t, _masked_case(*MASKED_CASES[0]))
    e = _t(np.ones(3, np.float32))
    before = dict(kernel.LAUNCHES)
    assert int(ops.pair_count_masked(a, b, no, nb, np.cos(0.3))) == int(
        ref.pair_count_masked_ref(a, b, no, nb, np.cos(0.3)))
    assert torch.equal(ops.pair_hist_masked(a, b, no, nb, e),
                       ref.pair_hist_masked_ref(a, b, no, nb, e))
    assert int(ops.pair_count(a, b, np.cos(0.3))) == int(
        ref.pair_count_ref(a, b, np.cos(0.3)))
    assert torch.equal(ops.pair_hist(a[0], b[0], e),
                       ref.pair_hist_ref(a[0], b[0], e))
    assert kernel.LAUNCHES == before
    for launch in (lambda: kernel.pair_count_masked_cuda(a, b, no, nb, 0.5),
                   lambda: kernel.pair_hist_masked_cuda(a, b, no, nb, e),
                   lambda: kernel.pair_count_cuda(a, b, 0.5),
                   lambda: kernel.pair_hist_cuda(a, b, e)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            launch()
    assert kernel.LAUNCHES == before
