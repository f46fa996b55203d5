"""Inputs shared by the port's kernel tests, made from numpy seeds, and the
MoE checks shared by the tests and ``chip_smoke.py``: a plain per-expert
MoE layer and the routing records that say which rows two calls route
alike, and ``salted_init``, the JAX package's parameter draw made
independent of the process's hash salt (this module holds no tests).
Imports neither jax nor the JAX package, so the card's tests
(``test_torch_cuda.py``) and ``chip_smoke.py`` can use it where JAX is not
installed."""
import contextlib
import functools
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from repro_torch.data.sky import ARCSEC, make_catalog
from repro_torch.models import moe
from repro_torch.models.common import activate
from repro_torch.models.transformer import layer_plan

COS60 = np.float32(np.cos(60 * ARCSEC))

# (P, C1, C2, n_owned, n_bucket), as in tests/test_kernels.py: ragged counts,
# empty partitions, a full-capacity one, one partition, and all padding
MASKED_CASES = [
    (4, 128, 256, (0, 128, 64, 1), (0, 256, 100, 3)),
    (3, 64, 64, (64, 64, 64), (64, 64, 64)),
    (1, 256, 128, (200,), (90,)),
    (5, 64, 128, (0, 0, 10, 64, 33), (0, 5, 0, 128, 77)),
    (3, 64, 64, (0, 0, 0), (0, 0, 0)),
]


# Edge sets for the histograms beside the usual descending ones, in no
# particular order: the paper's 60 arcsecond edges; duplicated edges and
# edges exactly on f32 cos(60") and one ulp either side of it; an edge below
# 0 (cos 100 degrees), which every zero padding row passes; edges at and
# below -2, which every cell passes and the -2 of an excluded diagonal cell
# (unmasked exclude_self) passes exactly at -2
HIST_EDGE_SETS = {
    "arcsec60": np.cos(np.arange(1, 61) * ARCSEC).astype(np.float32),
    "duplicates": np.array(
        [COS60, np.cos(30 * ARCSEC), COS60, np.nextafter(COS60, np.float32(2)),
         np.nextafter(COS60, np.float32(0)), np.cos(30 * ARCSEC),
         np.cos(0.05), np.cos(0.3), np.cos(0.3)], np.float32),
    "below_zero": np.array([np.cos(0.05), np.cos(np.radians(100.0)),
                            np.cos(0.3), COS60], np.float32),
    "below_minus_two": np.array([COS60, -1.0, -2.0, -2.5], np.float32),
}

def clumped_catalog(n, seed, clump):
    """Random unit catalog of ``n`` objects; ``clump`` piles half of them
    into one tiny dec band, so partitions get real skew."""
    xyz = make_catalog(max(n, 1), seed)[:n]
    if clump and n >= 8:
        rng = np.random.default_rng(seed + 1)
        k = n // 2
        xyz = xyz.copy()
        xyz[:k] = xyz[k:k + 1] + rng.normal(0, 1e-3, (k, 3))
        xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    return xyz.astype(np.float32)


def masked_case(P, C1, C2, n_o, n_b, seed=0):
    a = np.stack([make_catalog(C1, seed + p) for p in range(P)])
    b = np.stack([make_catalog(C2, 100 + seed + p) for p in range(P)])
    return a, b, np.asarray(n_o, np.int32), np.asarray(n_b, np.int32)


def rotate(x, angles, rng):
    """Rotate each unit vector of ``x`` by ``angles`` about a random axis
    perpendicular to it."""
    x = x.astype(np.float64)
    r = rng.normal(size=x.shape)
    r -= np.sum(r * x, axis=1, keepdims=True) * x
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    return (np.cos(angles)[:, None] * x + np.sin(angles)[:, None] * r
            ).astype(np.float32)


def close_pairs_case(P=3, C=128, seed=0):
    """Tiers whose bucket rows sit 0..70 arcsec from the owned rows, plus
    exact copies and rows placed so their score lands on f32 cos(60")."""
    rng = np.random.default_rng(seed)
    a = np.stack([make_catalog(C, seed + p) for p in range(P)])
    b = np.empty_like(a)
    for p in range(P):
        ang = rng.uniform(0.0, 70.0, C) * ARCSEC
        ang[:8] = 0.0                                  # exact copies
        b[p] = rotate(a[p], ang, rng)
    # rows whose score is exactly COS60, one ulp above and one ulp below
    on = np.array([[1, 0, 0], [COS60, 0, 0],
                   [np.nextafter(COS60, np.float32(2)), 0, 0],
                   [np.nextafter(COS60, np.float32(0)), 0, 0]], np.float32)
    a[0, :4] = on[[0, 0, 0, 0]]
    b[0, 8:12] = on
    n = np.array([C, C - 5, C // 2][:P], np.int32)
    return a, b, n, n


def quantize_case(rows, cols, seed, bf16_valued=False):
    """[rows, cols] f32 draws of N(0, 9), as tests/test_kernels.py makes
    them; ``bf16_valued`` rounds each to the nearest bf16 (half to even),
    so the values are exact in both types."""
    x = (np.random.default_rng(seed).normal(size=(rows, cols)) * 3
         ).astype(np.float32)
    if bf16_valued:
        b = x.view(np.uint32)
        b = (b + np.uint32(0x7FFF) + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)
        x = b.view(np.float32)
    return x


# (S, H, Kv, dh, window, cap), as tests/test_kernels.py::test_flash_sweep
FLASH_CASES = [
    (256, 4, 4, 64, 0, 0.0),
    (256, 4, 2, 64, 0, 0.0),         # GQA
    (256, 4, 1, 32, 64, 0.0),        # MQA + window
    (128, 8, 4, 64, 0, 50.0),        # softcap (gemma2)
    (192, 2, 2, 64, 0, 0.0),         # non-multiple of block
]
# the CUDA kernel's own edges (64-row query and key tiles): windows that are
# not a multiple of the tile, so some rows' first loaded tile is wholly
# masked; the head dims 16, 128 and 256; one row
FLASH_EDGE_CASES = [
    (200, 4, 2, 16, 40, 0.0),
    (130, 4, 1, 128, 0, 30.0),
    (100, 2, 1, 256, 70, 0.0),
    (1, 2, 1, 64, 0, 0.0),
]


def flash_case(S, H, Kv, dh, seed=0, B=2):
    """q [B,S,H,dh], k and v [B,S,Kv,dh]: f32 draws of N(0, 0.25), as
    test_flash_sweep scales them."""
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=(B, S, n, dh)) * 0.5).astype(np.float32)
                 for n in (H, Kv, Kv))


# (dtype, S, H, Kv, dh, window, cap, scale, B) at the model families' flash
# instances: gemma2's and recurrentgemma's f32 streams (head dim 256, a
# window shorter than S, gemma2's softcap 50 and query scale 1/16,
# recurrentgemma's 10 query heads on one kv head, with and without a
# softcap), starcoder2's bf16 36 heads on 4 (G = 9), olmo's bf16 MHA at
# head dim 128, musicgen's bf16 MHA at 64 (24 heads, G = 1) and internvl2's
# bf16 16 heads on 8 at 128 (G = 2); none of S a multiple of a tile. Then
# the f32 kernel's own edges (64-row query tiles, 128-key tiles, K chunks of
# 32 head-dim columns, V chunks of 16 to 128 keys): every head dim, S and
# windows a multiple of no tile or chunk (129: one key past a tile), a
# window past S, G = 8 and G = 10 with a softcap, B = 3 and S = 1
FLASH_FAMILY_CASES = {
    "gemma2": (torch.float32, 300, 8, 4, 256, 70, 50.0, 1 / 16, 2),
    "recurrentgemma": (torch.float32, 300, 10, 1, 256, 70, 0.0, None, 2),
    "g10_softcap": (torch.float32, 200, 10, 1, 256, 70, 50.0, 1 / 16, 2),
    "starcoder2": (torch.bfloat16, 300, 36, 4, 128, 0, 0.0, None, 2),
    "olmo": (torch.bfloat16, 300, 16, 16, 128, 0, 0.0, None, 2),
    "g10_bf16": (torch.bfloat16, 130, 10, 1, 256, 70, 50.0, 1 / 16, 2),
    "musicgen": (torch.bfloat16, 300, 24, 24, 64, 0, 0.0, None, 2),
    "internvl2": (torch.bfloat16, 300, 16, 8, 128, 0, 0.0, None, 2),
    "f32_dh16_b3": (torch.float32, 200, 4, 2, 16, 100, 0.0, None, 3),
    "f32_dh32_softcap_b3": (torch.float32, 130, 4, 1, 32, 0, 30.0, None, 3),
    "f32_dh64_g8": (torch.float32, 330, 8, 1, 64, 90, 0.0, None, 2),
    "f32_dh128_window": (torch.float32, 257, 4, 2, 128, 200, 20.0, None, 1),
    "f32_dh256_g10_softcap_b3": (torch.float32, 140, 10, 1, 256, 0, 50.0,
                                 1 / 16, 3),
    "f32_dh256_window_129": (torch.float32, 390, 2, 1, 256, 129, 0.0, None,
                             1),
    "f32_window_past_s": (torch.float32, 100, 4, 4, 64, 500, 0.0, None, 2),
    "f32_s1_dh256_b3": (torch.float32, 1, 4, 2, 256, 0, 0.0, None, 3),
    "f32_s1_dh16_b3": (torch.float32, 1, 2, 1, 16, 0, 0.0, None, 3),
}


# ---------------------------------------------------------------------------
# MoE: a plain per-expert layer, and which rows two calls route alike
# ---------------------------------------------------------------------------

def plain_moe(cfg, p, x, bias):
    """The routed experts one expert at a time: per chunk, the assignments
    that chose each expert in token-major order, the first ``C_send`` of
    the chunk sent and the first ``C_exp`` of those the expert's, run
    through that expert alone and added with their gates in f32. ->
    (y [T, D] in x's dtype, kept [T_padded, K] bool)."""
    m = cfg.moe
    T, D = x.shape
    n, C_send, C_exp = moe._capacity(m, T)
    xp = torch.nn.functional.pad(x, (0, 0, 0, -(-T // n) * n - T))
    ys, kept = [], []
    for xt in xp.split(n):
        gates, ids, _ = moe.route(m, xt.float() @ p["router"].float(), bias)
        flat = ids.reshape(-1)
        keep = torch.zeros(ids.numel(), dtype=torch.bool, device=x.device)
        y = torch.zeros(n, D, device=x.device)
        for e in range(m.n_experts_padded):
            a = torch.nonzero(flat[:C_send] == e).flatten()[:C_exp]
            keep[a] = True
            xe = xt[a // m.top_k]
            out = (activate(cfg.act, xe @ p["w_gate"][e])
                   * (xe @ p["w_up"][e])) @ p["w_down"][e]
            y.index_add_(0, a // m.top_k, out.float() * gates.reshape(-1)[
                a, None].to(x.dtype).float())
        ys.append(y.to(x.dtype))
        kept.append(keep.view(n, m.top_k))
    return torch.cat(ys)[:T], torch.cat(kept)


@contextlib.contextmanager
def recorded_routing():
    """Keeps the expert ids [n, K] of every dispatch chunk the port routes,
    in call order (as the tensors come, nothing copied)."""
    calls, route = [], moe.route

    def recorded(m, logits, bias):
        out = route(m, logits, bias)
        calls.append(out[1])
        return out
    moe.route = recorded
    try:
        yield calls
    finally:
        moe.route = route


def kept_experts(cfg, calls, B: int, L: int, n_steps: int = 0):
    """[MoE layers, B, L + n_steps, E_pad] bool: each token's kept
    experts, from the ``calls`` (expert ids [n, K]) of one pass over B x L
    tokens (every MoE layer's chunks in order) and then ``n_steps`` decode
    steps of B tokens, the capacity rule (``moe._dispatch``) applied per
    chunk."""
    m = cfg.moe
    n_moe = sum(f == "moe" for _, f in layer_plan(cfg))
    n_pre = len(calls) - n_steps * n_moe
    passes = [(calls[:n_pre], L)] + [
        (calls[n_pre + i * n_moe:n_pre + (i + 1) * n_moe], 1)
        for i in range(n_steps)]
    out = []
    for part, length in passes:
        per = len(part) // n_moe
        assert per * n_moe == len(part) == n_moe * -(-B * length // min(
            m.chunk_tokens, B * length))
        layers = []
        for li in range(n_moe):
            rows = []
            for ids in part[li * per:(li + 1) * per]:
                ids = torch.as_tensor(ids).long()
                _, C_send, C_exp = moe._capacity(m, len(ids))
                keep, _ = moe._dispatch(ids, C_send, C_exp, m.n_experts_padded)
                rows.append(torch.zeros(len(ids), m.n_experts_padded,
                                        dtype=torch.bool, device=ids.device)
                            .scatter_(1, ids, keep.view(ids.shape)))
            layers.append(torch.cat(rows)[:B * length].view(B, length, -1))
        out.append(torch.stack(layers))
    return torch.cat(out, dim=2)


def routed_alike(cfg, got, want):
    """[B, L] bool from two ``kept_experts`` of the same tokens: the rows
    whose own kept experts agree in every MoE layer, and so do those of
    every earlier token of their sequence in each MoE layer that later
    attention reads (all but the stack's last layer). Capacity drops depend
    on a dispatch chunk's tokens, so two calls that chunk a batch
    differently drop differently, and a token dropped in one call and kept
    in the other changes every later token of its sequence."""
    moe_layers = [i for i, (_, f) in enumerate(layer_plan(cfg)) if f == "moe"]
    same = (got == want.to(got.device)).all(dim=3)
    feeds = [j for j, i in enumerate(moe_layers) if i < cfg.n_layers - 1]
    earlier = same[feeds].all(dim=0).int().cummin(dim=1).values.bool()
    return same.all(dim=0) & earlier


# ---------------------------------------------------------------------------
# the reference's parameter draw under a fixed hash salt
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def salted_hashes(paths: tuple, salt: int) -> dict:
    """``{path: hash(path)}`` as a Python process started with
    ``PYTHONHASHSEED=salt`` computes them (in a subprocess: this
    process's own salt is whatever it was started with)."""
    code = ("import json, sys; print(json.dumps({p: hash(p) for p in "
            "json.load(sys.stdin)}))")
    out = subprocess.run([sys.executable, "-c", code], input=json.dumps(
        list(paths)), capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONHASHSEED=str(salt)))
    return json.loads(out.stdout)


def salted_init(jsharding, schema, key, salt: int = 0, **kw):
    """The JAX package's ``init_params(schema, key, **kw)`` as a process
    whose hash salt is ``salt`` draws it (``jsharding``: the JAX package's
    ``parallel/sharding.py``, which this module does not import).
    ``init_params`` folds ``hash(path)`` into each leaf's key, so without a
    fixed salt every process draws other weights."""
    paths = []
    jsharding.tree_map_schema(
        lambda path, pd: paths.append("/".join(map(str, path))), schema)
    table = salted_hashes(tuple(sorted(paths)), int(salt))
    with mock.patch.object(jsharding, "hash", table.__getitem__,
                           create=True):
        return jsharding.init_params(schema, key, **kw)
