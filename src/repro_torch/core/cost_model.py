"""Calibrated cost model: predicted stage walls drive the planning knobs.

The port of ``repro.core.cost_model``. The paper's argument is a balance
calculation: measure where cycles and bytes go, then size the system so no
knob is the accidental bottleneck. This module closes that loop:

1. **Census** (``op_census.stage_census``): the FLOPs, elementwise FLOPs
   and bytes a stage callable dispatches. The reference parses compiled
   HLO; the port counts ATen operators.
2. **Calibration** (``CostModel.calibrate``): a short replay of the port's
   masked pair count (``kernels/zones_pairs/ops.py::pair_count_masked``) on
   the card at ``CALIBRATION_SHAPES``, timed with CUDA events, fitted to
   ``wall ~= flops/F + bytes/B + dispatch`` with F and B held at or under
   the card's peaks (``DeviceSpec``), and cached on disk per backend
   fingerprint (``cuda|<device name>|torch<version>|cpus<n>``). A probe's
   cost is the kernel's own count: ``FP32_OPS_PER_CELL`` non-fused FP32
   operations a real cell, and its input and output bytes. The replay
   NEVER runs implicitly: plain ``get_cost_model()`` loads the disk cache
   when the fingerprint matches and otherwise takes analytic defaults (on
   the card: its ``DeviceSpec`` peaks and ``LAUNCH_S``), so planning never
   disturbs a timed run. Calibration is skipped (analytic defaults,
   ``calibrated=False``) on the CPU, with fewer than 2 CPUs, or under
   ``REPRO_NO_CALIBRATE=1``.
3. **Prediction** (``predict_stage_wall``, ``argmin``): seconds per stage
   from the profile's rates, and an argmin over candidate configurations.

Consumers: ``plan_tiers(tier_cost=...)``, ``codec="auto"`` and
``tile="auto"`` on the jobs, ``run_jobs(split_rows="auto")`` and
``SpillConfig(n_ranges="auto")``. Every auto path changes shapes and
choices, never arithmetic: exact codecs only, and the masked kernels take
any geometry, so auto runs equal their manual twins bit for bit.
``tier_cost_fn``, ``plan_shuffle`` and the choosers are the reference's
formulas, so one profile gives the same tile and plan in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import statistics
import threading

import numpy as np
import torch

from repro_torch.core.amdahl import device_spec
from repro_torch.core.device import resolve_device
from repro_torch.core.op_census import OpCensus, stage_census

# CPU rates used when the port runs its plain versions on the CPU: they only
# rank candidate shapes there and are never written down as a measurement.
CPU_RATES = (2.0e10, 1.0e10, 5.0e-5)
# The card's analytic per-launch overhead before calibration: one ctypes
# launch of a pair kernel from Python plus its output allocation, about
# 10 us (the anchor probe measures it).
LAUNCH_S = 1.0e-5
# The pair kernels' per-cell work: 3 FMUL + 2 FADD, rounded, no FMA
# (zones_pairs.cu)
FP32_OPS_PER_CELL = 5.0

# Replay probes (P, C1, C2) of the masked pair count, every row real. The
# first is tiny (the per-launch anchor); the rest run from launch-bound to
# about a millisecond on an H100 (1e6 to 4e9 cells), and vary C1 and C2 as
# well as P, so cells (P*C1*C2) and bytes (P*(C1+C2)) do not grow in one
# ratio, which would make the fit singular. Past the anchor every probe has
# at least 1,024 blocks of 1,024 owned rows (the kernel's grid is
# P x ceil(C1/1024)), several to an SM, as the main path's tiers have.
CALIBRATION_SHAPES = ((1, 32, 32), (1056, 1024, 1), (2048, 1024, 16),
                      (1024, 1024, 128), (512, 2048, 256),
                      (1024, 1024, 1024), (512, 2048, 2048),
                      (256, 4096, 4096))
CALIBRATION_COS = 0.99        # score threshold of the probes

DEFAULT_CHUNK = (64, 64, 512)      # the reference's blocked chunk shape
TILE_CANDIDATES = (64, 128, 256, 512)
# fixed per-tier dispatch chain charged under the "rows" cost basis: each
# tier is its own decode + reduce + accumulator-output sequence, and for
# linear reducers that overhead dominates the (tiny) arithmetic saved
_TIER_DISPATCHES = 8.0


def backend_fingerprint(device=None) -> str:
    """``cuda|<device name>|torch<version>|cpus<n>`` (or ``cpu|cpu|...``):
    the key of a calibration cache file. It never equals the reference's
    (``...|jax<version>|...``), so the two never share a file."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return (f"{dev.type}|{kind}|torch{torch.__version__}"
            f"|cpus{os.cpu_count() or 1}")


def calibration_enabled() -> bool:
    """Replay is allowed: >=2 CPUs and not opted out via env."""
    if os.environ.get("REPRO_NO_CALIBRATE") == "1":
        return False
    return (os.cpu_count() or 1) >= 2


def _can_replay(device: torch.device) -> bool:
    """The replay times the card's kernel: the CPU keeps its defaults."""
    return device.type == "cuda" and calibration_enabled()


def cache_dir() -> str:
    return (os.environ.get("REPRO_CACHE_DIR")
            or os.path.join(os.path.expanduser("~"), ".cache", "repro"))


def cache_path(fingerprint: str) -> str:
    tag = hashlib.sha1(fingerprint.encode()).hexdigest()[:12]
    return os.path.join(cache_dir(), f"cost_model-{tag}.json")


@dataclasses.dataclass(frozen=True)
class StageCost:
    """Analytic cost of one stage configuration (census units)."""
    flops: float                 # dot + elementwise FLOPs
    hbm_bytes: float = 0.0
    n_dispatch: float = 1.0

    @classmethod
    def from_analysis(cls, a: OpCensus, n_dispatch: float = 1.0):
        return cls(a.flops + a.ew_flops, a.hbm_bytes, n_dispatch)


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    """Effective rates for one backend fingerprint."""
    fingerprint: str
    flops_per_s: float
    bytes_per_s: float
    dispatch_s: float
    calibrated: bool = False
    # per-probe replay rows: (P, C1, C2, wall_s, flops, hbm_bytes)
    probes: tuple = ()


def probe_cost(P: int, C1: int, C2: int) -> StageCost:
    """One masked count launch over a full [P, C1] x [P, C2] tier: the
    kernel's own count of work (every cell real) and bytes (the two f32
    row sets and the two int32 count vectors read, one int64 written)."""
    return StageCost(flops=FP32_OPS_PER_CELL * P * C1 * C2,
                     hbm_bytes=12.0 * P * (C1 + C2) + 8.0 * P + 8.0)


def _probe_args(P: int, C1: int, C2: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((P, C1, 3)).astype(np.float32)
    b = rng.standard_normal((P, C2, 3)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)

    def dev(x):
        return torch.as_tensor(x, device=device)

    return (dev(a), dev(b), dev(np.full(P, C1, np.int32)),
            dev(np.full(P, C2, np.int32)), CALIBRATION_COS)


def _cuda_wall(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median seconds of one call of ``fn`` over ``reps``, each between two
    CUDA events on the current stream, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    walls = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end) * 1e-3)
    return statistics.median(walls)


def _run_replay(device=None, shapes=CALIBRATION_SHAPES):
    """Time the card's masked pair count at the probe shapes. -> probe rows
    (P, C1, C2, wall_s, flops, hbm_bytes)."""
    from repro_torch.kernels.zones_pairs.ops import pair_count_masked
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the replay times the card's kernel, not {device}")
    rows = []
    with torch.cuda.device(device):
        for (P, C1, C2) in shapes:
            args = _probe_args(P, C1, C2, device)
            wall = _cuda_wall(lambda: pair_count_masked(*args))
            c = probe_cost(P, C1, C2)
            rows.append((P, C1, C2, float(wall), c.flops, c.hbm_bytes))
            del args
    return tuple(rows)


def _bounded_lstsq(A, r, lo):
    """min ||A c - r|| over c >= lo (two coefficients): the unconstrained
    solution if it is feasible, else the best with one or both at their
    bound (the optimum of a convex problem over a box lies on the face
    whose free coefficient solves its own least squares)."""
    best, best_err = None, np.inf
    for fixed in ((), (0,), (1,), (0, 1)):
        c = lo.copy()
        free = [i for i in (0, 1) if i not in fixed]
        if free:
            resid = r - A[:, list(fixed)] @ lo[list(fixed)]
            c[free] = np.linalg.lstsq(A[:, free], resid, rcond=None)[0]
        if np.all(c >= lo):
            err = float(np.sum((A @ c - r) ** 2))
            if err < best_err:
                best, best_err = c, err
    return best


def _fit_profile(fingerprint: str, probes, peaks=None) -> BackendProfile:
    """wall ~= flops/F + bytes/B + c, nonnegative. The tiny anchor probe
    pins the dispatch overhead; a least-squares fit over the residuals gives
    the rates, with a single-rate fallback if the fit goes non-positive.

    ``peaks`` (flop/s, bytes/s): the device's peak rates, which no fitted
    rate may exceed. The fit is then least squares over the coefficients
    at or above 1/peak: probes that time one resource leave the other
    undetermined, and an unbounded fit may give it any rate. Without
    ``peaks`` the fit is the reference's."""
    walls = np.array([p[3] for p in probes], np.float64)
    flops = np.array([p[4] for p in probes], np.float64)
    byts = np.array([p[5] for p in probes], np.float64)
    dispatch = float(max(walls.min(), 1e-7))
    resid = np.maximum(walls - dispatch, 1e-9)
    big = flops > flops.min()       # drop the anchor from the rate fit
    if peaks is not None:
        lo = 1.0 / np.asarray(peaks, np.float64)
        A = np.stack([flops[big], byts[big]], axis=1)
        coef = (_bounded_lstsq(A, resid[big], lo) if big.sum() >= 2
                else lo)
    elif big.sum() >= 2:
        A = np.stack([flops[big], byts[big]], axis=1)
        coef, *_ = np.linalg.lstsq(A, resid[big], rcond=None)
    else:
        coef = np.zeros(2)
    if coef[0] <= 0 or coef[1] <= 0:
        # degenerate fit: charge everything to both rates proportionally
        per = resid.sum()
        coef = np.array([per / max(flops.sum(), 1.0),
                         per / max(byts.sum(), 1.0)])
    return BackendProfile(fingerprint, 1.0 / float(coef[0]),
                          1.0 / float(coef[1]), dispatch,
                          calibrated=True, probes=tuple(probes))


def _peaks(device: torch.device):
    """(flop/s, bytes/s) the card's spec allows, or None on the CPU."""
    if device.type != "cuda":
        return None
    spec = device_spec(device)
    return (spec.peak_flops, spec.hbm_bw)


def _default_profile(fingerprint: str, device: torch.device
                     ) -> BackendProfile:
    """Analytic rates: the card's ``DeviceSpec`` peaks and ``LAUNCH_S``, or
    ``CPU_RATES``."""
    peaks = _peaks(device)
    f, b, d = CPU_RATES if peaks is None else (*peaks, LAUNCH_S)
    return BackendProfile(fingerprint, f, b, d, calibrated=False)


def _load_cached(fingerprint: str) -> BackendProfile | None:
    path = cache_path(fingerprint)
    try:
        with open(path) as fh:
            d = json.load(fh)
    except (OSError, ValueError):
        return None
    if d.get("fingerprint") != fingerprint:   # stale: backend changed
        return None
    try:
        return BackendProfile(
            d["fingerprint"], float(d["flops_per_s"]),
            float(d["bytes_per_s"]), float(d["dispatch_s"]),
            calibrated=True,
            probes=tuple(tuple(p) for p in d.get("probes", ())))
    except (KeyError, TypeError, ValueError):
        return None


def _save_cache(profile: BackendProfile) -> None:
    os.makedirs(cache_dir(), exist_ok=True)
    path = cache_path(profile.fingerprint)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"fingerprint": profile.fingerprint,
                   "flops_per_s": profile.flops_per_s,
                   "bytes_per_s": profile.bytes_per_s,
                   "dispatch_s": profile.dispatch_s,
                   "probes": [list(p) for p in profile.probes]}, fh)
    os.replace(tmp, path)


def _calibrated_profile(fingerprint: str, device) -> BackendProfile:
    prof = _fit_profile(fingerprint, _run_replay(device), _peaks(device))
    _save_cache(prof)
    return prof


class CostModel:
    """Predicted stage walls + argmin planning over one backend profile."""

    def __init__(self, profile: BackendProfile):
        self.profile = profile

    # -- construction -------------------------------------------------------

    @classmethod
    def load(cls, calibrate: bool = False, device=None) -> "CostModel":
        device = resolve_device(device)
        fp = backend_fingerprint(device)
        prof = _load_cached(fp)
        if prof is None and calibrate and _can_replay(device):
            prof = _calibrated_profile(fp, device)
        if prof is None:
            prof = _default_profile(fp, device)
        return cls(prof)

    def calibrate(self, device=None) -> "CostModel":
        """Force the replay (subject to the skip guards) and re-fit."""
        device = resolve_device(device)
        fp = backend_fingerprint(device)
        if not _can_replay(device):
            return CostModel(_default_profile(fp, device))
        self.profile = _calibrated_profile(fp, device)
        return self

    # -- prediction ---------------------------------------------------------

    def predict_wall(self, cost: StageCost) -> float:
        p = self.profile
        return (cost.flops / p.flops_per_s + cost.hbm_bytes / p.bytes_per_s
                + cost.n_dispatch * p.dispatch_s)

    def predict_stage_wall(self, config, *args) -> float:
        """Seconds for one stage configuration. ``config`` may be a
        ``StageCost``, an ``OpCensus``, or a stage callable (censused by
        running it once at ``*args``)."""
        if callable(config):
            config = StageCost.from_analysis(stage_census(config, *args))
        elif isinstance(config, OpCensus):
            config = StageCost.from_analysis(config)
        return self.predict_wall(config)

    def argmin(self, candidates):
        """``candidates``: iterable of (key, StageCost). Returns the
        (key, predicted_wall) pair with the smallest wall; first wins ties."""
        best = None
        for key, cost in candidates:
            w = self.predict_wall(cost)
            if best is None or w < best[1]:
                best = (key, w)
        if best is None:
            raise ValueError("argmin over no candidates")
        return best

    # -- consumer choosers --------------------------------------------------

    def tier_cost_fn(self, *, d: int = 3, basis: str = "pairs",
                     flops_per_cell: float = 8.0,
                     bytes_per_cell: float = 4.0):
        """Vectorized ``f(Pt, C1, C2) -> predicted tier walls`` for
        ``plan_tiers(tier_cost=...)``. Phantom shards stay charged because
        Pt is the padded partition count.

        ``basis`` follows the reducer's declared ``cost_basis``:

        - ``"pairs"`` (cross-row reducers): work is quadratic in the padded
          score cells (Pt*C1*C2) plus input HBM traffic and per-chunk
          dispatch overhead.
        - ``"rows"`` (monoid/bincount-style reducers): work is LINEAR in
          the padded owned rows (Pt*C1), so tiering buys almost no
          arithmetic back and each extra tier is mostly its fixed
          dispatch-chain overhead (decode + reduce + accumulator output).
          The per-tier constant makes the planner prefer few tiers and
          coarse tiles here.
        """
        p = self.profile
        ctm, ctn, cb0 = DEFAULT_CHUNK
        chunk_cells = float(ctm * ctn * cb0)

        def cost(Pt, C1, C2):
            Pt = np.asarray(Pt, np.float64)
            C1 = np.asarray(C1, np.float64)
            C2 = np.asarray(C2, np.float64)
            io_bytes = Pt * (C1 + C2) * d * 4.0
            if basis == "rows":
                rows = Pt * C1
                flops = rows * 4.0
                ndisp = np.maximum(rows / chunk_cells, 1.0) + _TIER_DISPATCHES
                return (flops / p.flops_per_s + io_bytes / p.bytes_per_s
                        + ndisp * p.dispatch_s)
            cells = Pt * C1 * C2
            flops = cells * flops_per_cell
            byts = cells * bytes_per_cell + io_bytes
            ndisp = np.maximum(cells / chunk_cells, 1.0)
            return (flops / p.flops_per_s + byts / p.bytes_per_s
                    + ndisp * p.dispatch_s)

        return cost

    def plan_shuffle(self, n_owned, n_bucket, pad_partitions_to: int = 1,
                     *, d: int = 3, basis: str = "pairs", max_tiers: int = 3,
                     candidates=TILE_CANDIDATES):
        """Pick (tile, tier plan) minimizing the predicted reduce wall.
        Each candidate tile is planned with the predicted-wall tier cost
        (``basis`` per the reducer's ``cost_basis``, see ``tier_cost_fn``);
        ties keep the earliest candidate. Returns (tile, plan, wall_s)."""
        from repro_torch.mapreduce.job import plan_tiers
        f = self.tier_cost_fn(d=d, basis=basis)
        best = None
        for tile in candidates:
            plan = plan_tiers(n_owned, n_bucket, tile, max_tiers=max_tiers,
                              pad_partitions_to=pad_partitions_to,
                              tier_cost=f)
            Pt = np.array([-(-len(ids) // pad_partitions_to)
                           * pad_partitions_to for ids, _, _ in plan])
            C1 = np.array([c1 for _, c1, _ in plan])
            C2 = np.array([c2 for _, _, c2 in plan])
            wall = float(np.sum(f(Pt, C1, C2)))
            if best is None or wall < best[2]:
                best = (tile, plan, wall)
        return best

    def choose_codec(self, *, d: int = 3, candidates=None,
                     n_items: float = 1e6) -> str:
        """Exact codecs only: codec choice must never change arithmetic.
        Ranked by predicted shuffle wire traffic + decode cost."""
        from repro_torch.mapreduce.codecs import available_codecs, get_codec
        names = candidates if candidates is not None else available_codecs()
        exact = [n for n in names if get_codec(n).exact]
        if not exact:
            raise ValueError("no exact codec available for codec='auto'")
        key, _ = self.argmin(
            (n, StageCost(
                flops=0.0 if n == "identity" else 2.0 * n_items * d,
                hbm_bytes=3.0 * n_items
                * get_codec(n).device_bytes_per_item(d)))
            for n in exact)
        return key

    def choose_blocked_chunk(self, default=DEFAULT_CHUNK):
        """(TM, TN, B0) of the reference's blocked engine, from probes
        measured at chunk shapes ``(tm, tn, b0, wall, ...)``: rank measured
        per-cell walls amortized over a nominal workload; otherwise keep the
        hand-tuned default. The port has no blocked engine, so nothing
        calls it; it stays for parity with the reference's choosers."""
        probes = [p for p in self.profile.probes
                  if p[0] * p[1] * p[2] >= 32 * 32 * 256]   # skip the anchor
        if not self.profile.calibrated or not probes:
            return default
        W = float(2 ** 27)        # nominal score cells per partition pair
        disp = self.profile.dispatch_s

        def wall(p):
            tm, tn, b0, w, _, _ = p
            cells = float(tm * tn * b0)
            return W * (w / cells) + np.ceil(W / cells) * disp

        best = min(probes, key=wall)
        if wall(best) >= wall(next((p for p in probes
                                    if tuple(p[:3]) == default), best)):
            return default        # ties / default measured best: keep it
        return (int(best[0]), int(best[1]), int(best[2]))

    def choose_split_rows(self, n_rows: int, *, d: int = 3,
                          bytes_per_row: float | None = None,
                          max_split_bytes: float = 128e6) -> int:
        """Rows per split for streaming: large enough that per-split fixed
        overhead (~8 dispatches) stays under ~5% of the per-split wall,
        small enough that a split's raw bytes fit the working-set cap."""
        p = self.profile
        bpr = bytes_per_row if bytes_per_row is not None else 4.0 * d
        row_wall = 3.0 * bpr / p.bytes_per_s + 8.0 * d / p.flops_per_s
        fixed = 8.0 * p.dispatch_s
        lo = int(np.ceil(20.0 * fixed / max(row_wall, 1e-18)))
        hi = max(int(max_split_bytes / max(bpr, 1.0)), 1)
        return int(np.clip(min(lo, hi), 1, max(n_rows, 1)))

    def choose_spill_ranges(self, est_total_bytes: float,
                            budget_bytes: float, P: int,
                            max_ranges: int = 256) -> int:
        """Smallest range count whose per-range read-back fits inside half
        the budget (the spill runtime's flush watermark); fewer ranges mean
        fewer replans, each costing fixed overhead."""
        cap = max(1, min(int(P), int(max_ranges)))
        half = max(budget_bytes / 2.0, 1.0)
        need = int(np.ceil(max(est_total_bytes, 0.0) / half))
        return int(np.clip(need, 1, cap))


_MODEL_CACHE: dict[str, CostModel] = {}
_MODEL_LOCK = threading.Lock()      # lanes ask for the model concurrently
_PINNED: set[str] = set()           # fingerprints holding a mesh's model
_AGREED: set[tuple] = set()         # the rank lists of the meshes agreed on


def get_cost_model(calibrate: bool | None = None, device=None) -> CostModel:
    """Process-cached model for ``device`` (None: the card).
    ``calibrate=None`` (default) never runs the replay: it loads the disk
    cache when the fingerprint matches, else analytic defaults. Pass
    ``calibrate=True`` (or set ``REPRO_CALIBRATE=1``) to run the one-time
    replay (still subject to the CPU / <2-CPU / ``REPRO_NO_CALIBRATE``
    guards)."""
    want = bool(calibrate) or os.environ.get("REPRO_CALIBRATE") == "1"
    device = resolve_device(device)
    fp = backend_fingerprint(device)
    with _MODEL_LOCK:
        m = _MODEL_CACHE.get(fp)
        if m is None or (want and not m.profile.calibrated
                         and fp not in _PINNED):
            m = CostModel.load(calibrate=want, device=device)
            _MODEL_CACHE[fp] = m
    return m


def agree_cost_model(mesh, device=None) -> None:
    """Make the model of ``mesh``'s first rank this rank's model.

    Under a mesh every rank resolves the auto knobs (tile plan, codec,
    split rows, spill ranges) on its own, from the same data, and they
    must come out alike, or the ranks' tiers, shards and collectives stop
    matching. The data is replicated; only the models differ (each rank
    calibrates, or takes defaults, by itself). So the first rank
    broadcasts its profile, once per mesh's set of ranks, and every rank
    keeps it for ``device``: ``get_cost_model`` returns it, calibration
    included, until ``reset_cost_model()``. A mesh already agreed on costs
    no collective: its entry points call this on the calling thread before
    any lane starts, and the calls the lanes then make return at once."""
    import torch.distributed as dist
    from repro_torch.core.compression import axis_group
    key = tuple(mesh.mesh.flatten().tolist())
    with _MODEL_LOCK:
        if len(key) == 1 or key in _AGREED:
            return
    box = [get_cost_model(device=device).profile]
    dist.broadcast_object_list(box, group=axis_group(mesh.mesh_dim_names,
                                                     mesh=mesh), src=key[0])
    fp = backend_fingerprint(resolve_device(device))
    with _MODEL_LOCK:
        _MODEL_CACHE[fp] = CostModel(box[0])
        _PINNED.add(fp)
        _AGREED.add(key)


def reset_cost_model() -> None:
    """Drop process-cached models, a mesh's agreed one too (tests; does not
    touch the disk cache)."""
    with _MODEL_LOCK:
        _MODEL_CACHE.clear()
        _PINNED.clear()
        _AGREED.clear()
