"""The port's cost model against the JAX package's, and its auto knobs.

Three contracts:

1. **Planner parity**: given one ``BackendProfile``, every chooser
   (``tier_cost_fn``, ``plan_shuffle``, ``choose_codec``,
   ``choose_blocked_chunk``, ``choose_split_rows``,
   ``choose_spill_ranges``) and ``plan_tiers`` (all options) return what
   the reference's do, and ``_fit_profile`` fits the reference's profile
   from the reference's synthetic probes.
2. **Bit identity**: every ``"auto"`` knob (codec, tile, split rows, spill
   ranges) changes shapes and choices, never arithmetic: auto runs equal
   their manual twins exactly, on both engines.
3. **No implicit replay**: the calibration replay runs only when asked, and
   its cache file never collides with the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.cost_model as jcm  # noqa: E402
import repro.mapreduce as R  # noqa: E402
from repro.mapreduce import job as jjob  # noqa: E402
import repro_torch.core.cost_model as cm  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.core import (BackendProfile, CostModel,  # noqa: E402
                              StageCost, backend_fingerprint,
                              calibration_enabled, get_cost_model,
                              reset_cost_model, stage_census)
from repro_torch.data import pipeline as tp  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.mapreduce import job as tjob  # noqa: E402

CPU = torch.device("cpu")

# the reference test's synthetic probes: (tm, tn, b0, wall_s, flops, bytes)
# at F=1e10, B=5e9, c=2e-5
SYNTH_PROBES = (
    (8, 8, 8, 2.01e-5, 1.0e3, 2.0e2),
    (32, 32, 256, 2.0e-5 + 1e-2 + 2e-3, 1.0e8, 1.0e7),
    (64, 64, 256, 2.0e-5 + 2e-2 + 4e-3, 2.0e8, 2.0e7),
    (64, 64, 512, 2.0e-5 + 4e-2 + 6e-3, 4.0e8, 3.0e7),
    (128, 128, 512, 2.0e-5 + 8e-2 + 1e-2, 8.0e8, 5.0e7),
)
# profiles shared by both packages: a calibrated CPU-like one (with probes
# at chunk shapes for the blocked chooser), the card's analytic defaults,
# and the CPU defaults
PROFILES = {
    "calibrated": (1e10, 5e9, 2e-5, True,
                   ((8, 8, 8, 1.0e-5, 1e3, 2e2),
                    (64, 64, 512, 3.0e-3, 4e8, 3e7),
                    (128, 128, 512, 4.0e-3, 16e8, 6e7))),
    "card": (132 * 128 * 1.98e9, 3.35e12, cm.LAUNCH_S, False, ()),
    "cpu": (*cm.CPU_RATES, False, ()),
}


def _models(name):
    f, b, d, cal, probes = PROFILES[name]
    return (CostModel(BackendProfile("fp", f, b, d, cal, probes)),
            jcm.CostModel(jcm.BackendProfile("fp", f, b, d, cal, probes)))


@pytest.fixture
def isolated_model(monkeypatch, tmp_path):
    """Point the disk cache at a tmp dir and drop process-cached models
    (both packages), so no test sees or writes a real calibration cache."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_CALIBRATE", raising=False)
    reset_cost_model()
    jcm.reset_cost_model()
    yield tmp_path
    reset_cost_model()
    jcm.reset_cost_model()


@pytest.fixture
def shared_profile(isolated_model):
    """Install one profile as the process model of both packages."""
    def install(name):
        tm, jm = _models(name)
        cm._MODEL_CACHE[backend_fingerprint(CPU)] = tm
        jcm._MODEL_CACHE[jcm.backend_fingerprint()] = jm
        return tm, jm
    return install


# ---------------------------------------------------------------------------
# profiles, calibration guards, disk cache
# ---------------------------------------------------------------------------

def test_default_profile_is_analytic_and_uncalibrated(isolated_model):
    m = get_cost_model(device="cpu")
    assert not m.profile.calibrated
    assert m.profile.fingerprint == backend_fingerprint("cpu")
    assert (m.profile.flops_per_s, m.profile.bytes_per_s,
            m.profile.dispatch_s) == cm.CPU_RATES
    assert get_cost_model(device="cpu") is m          # process cache


def test_fingerprint_never_names_the_reference_cache(isolated_model):
    fp = backend_fingerprint("cpu")
    assert fp.startswith("cpu|cpu|torch") and "|cpus" in fp
    assert fp != jcm.backend_fingerprint()
    assert cm.cache_path(fp) != jcm.cache_path(jcm.backend_fingerprint())


def test_replay_needs_the_card_and_honours_the_opt_out(isolated_model,
                                                        monkeypatch):
    monkeypatch.setattr(cm, "_run_replay",
                        lambda *a, **k: pytest.fail("replay ran"))
    assert not cm._can_replay(CPU)              # the CPU keeps its defaults
    m = CostModel.load(calibrate=True, device="cpu")
    assert not m.profile.calibrated
    assert not m.calibrate(device="cpu").profile.calibrated
    monkeypatch.setenv("REPRO_NO_CALIBRATE", "1")
    assert not calibration_enabled()
    assert not get_cost_model(calibrate=True,
                              device="cpu").profile.calibrated


def test_fit_profile_matches_reference():
    got = cm._fit_profile("fp", SYNTH_PROBES)
    want = jcm._fit_profile("fp", SYNTH_PROBES)
    assert got.calibrated and got.probes == SYNTH_PROBES
    assert (got.flops_per_s, got.bytes_per_s, got.dispatch_s) == \
        (want.flops_per_s, want.bytes_per_s, want.dispatch_s)
    assert got.flops_per_s == pytest.approx(1e10, rel=0.25)
    w = CostModel(got).predict_wall(StageCost(flops=4.0e8, hbm_bytes=3.0e7))
    assert 0.5 < w / SYNTH_PROBES[3][3] < 2.0


@pytest.mark.parametrize("peaks,bound", [
    ((1e12, 1e12), None),            # the free fit is inside the peaks
    ((1e12, 4e9), "bytes"),          # it needs 5e9 B/s: held at 4e9
    ((8e9, 1e12), "flops"),          # it needs 1e10 flop/s: held at 8e9
])
def test_bounded_fit_holds_rates_at_or_under_the_peaks(peaks, bound):
    free = cm._fit_profile("fp", SYNTH_PROBES)
    got = cm._fit_profile("fp", SYNTH_PROBES, peaks=peaks)
    assert got.flops_per_s <= peaks[0] and got.bytes_per_s <= peaks[1]
    if bound is None:
        assert got.flops_per_s == pytest.approx(free.flops_per_s, rel=1e-9)
        assert got.bytes_per_s == pytest.approx(free.bytes_per_s, rel=1e-9)
    elif bound == "bytes":
        assert got.bytes_per_s == pytest.approx(peaks[1], rel=1e-12)
    else:
        assert got.flops_per_s == pytest.approx(peaks[0], rel=1e-12)
    # the bounded optimum fits no worse than any other feasible point
    m = CostModel(got)

    def sse(model):
        return sum((model.predict_wall(StageCost(p[4], p[5])) - p[3]) ** 2
                   for p in SYNTH_PROBES[1:])
    corner = CostModel(BackendProfile("fp", *peaks, got.dispatch_s))
    assert sse(m) <= sse(corner) * (1 + 1e-9)


def test_calibration_cache_roundtrip_and_invalidation(isolated_model,
                                                      monkeypatch):
    monkeypatch.setattr(cm, "_can_replay", lambda device: True)
    monkeypatch.setattr(cm, "_run_replay", lambda device: SYNTH_PROBES)
    m = CostModel.load(calibrate=True, device="cpu")
    assert m.profile.calibrated
    fp = backend_fingerprint("cpu")
    path = cm.cache_path(fp)
    assert json.load(open(path))["fingerprint"] == fp

    # a later load (no calibrate) reads the cache: the replay must NOT run
    monkeypatch.setattr(cm, "_run_replay",
                        lambda device: pytest.fail("replay ran on load"))
    m2 = CostModel.load(device="cpu")
    assert m2.profile.calibrated and m2.profile.probes == SYNTH_PROBES
    assert get_cost_model(device="cpu").profile == m2.profile

    # a fingerprint mismatch (backend changed) invalidates the cache file
    d = json.load(open(path))
    d["fingerprint"] = "other|backend"
    json.dump(d, open(path, "w"))
    assert cm._load_cached(fp) is None
    assert not CostModel.load(device="cpu").profile.calibrated

    # corrupt JSON is treated as a miss, not an error
    open(path, "w").write("{not json")
    assert cm._load_cached(fp) is None


def test_replay_never_runs_implicitly(isolated_model, monkeypatch):
    """Auto knobs and predictions on every path read the model; none of
    them may start the replay."""
    monkeypatch.setattr(cm, "_can_replay", lambda device: True)
    monkeypatch.setattr(cm, "_run_replay",
                        lambda *a, **k: pytest.fail("implicit replay"))
    xyz = sky.make_catalog(600, 1)
    job = T.neighbor_search_job(0.05, codec="auto", tile="auto")
    for engine in ("device", "host"):
        T.run_job(job, xyz, engine=engine, device="cpu", split_rows="auto")
    assert not get_cost_model(device="cpu").profile.calibrated


# ---------------------------------------------------------------------------
# predictors and choosers: the reference's, on one shared profile
# ---------------------------------------------------------------------------

def test_argmin_first_wins_ties(isolated_model):
    m = get_cost_model(device="cpu")
    c = StageCost(flops=1e6)
    key, wall = m.argmin([("a", c), ("b", c), ("c", StageCost(flops=1e9))])
    assert key == "a" and wall > 0
    with pytest.raises(ValueError):
        m.argmin([])


def test_stage_census_counts_a_matmul(isolated_model):
    x = torch.ones((64, 64))
    a = stage_census(lambda t: t @ t, x)
    assert a.flops == 2 * 64 ** 3 and a.ew_flops == 0
    assert a.hbm_bytes == 3 * 64 * 64 * 4
    m = get_cost_model(device="cpu")
    assert m.predict_stage_wall(lambda t: t @ t, x) == \
        m.predict_wall(StageCost(2.0 * 64 ** 3, 3 * 64 * 64 * 4.0))
    assert m.predict_stage_wall(a) == m.predict_stage_wall(
        StageCost.from_analysis(a))
    # elementwise ops count their outputs; views count nothing
    b = stage_census(lambda t: (t * 2).t().reshape(-1)[:5], x)
    assert b.flops == 0 and b.ew_flops >= 64 * 64


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("basis", ["pairs", "rows"])
def test_tier_cost_fn_matches_reference(name, basis):
    tm, jm = _models(name)
    rng = np.random.default_rng(1)
    Pt, C1, C2 = (rng.integers(1, 4000, 50) for _ in range(3))
    np.testing.assert_array_equal(tm.tier_cost_fn(basis=basis)(Pt, C1, C2),
                                  jm.tier_cost_fn(basis=basis)(Pt, C1, C2))


def _counts(seed):
    rng = np.random.default_rng(seed)
    P = int(rng.integers(1, 60))
    n_bucket = rng.integers(0, 3000, P)
    if seed % 2:
        n_bucket[rng.integers(0, P)] *= 10                    # skew
    return (n_bucket * rng.uniform(0.2, 0.8, P)).astype(np.int64), n_bucket


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("seed", range(4))
def test_plan_shuffle_matches_reference(name, seed):
    tm, jm = _models(name)
    n_owned, n_bucket = _counts(seed)
    for basis in ("pairs", "rows"):
        for pad in (1, 4):
            gt, gplan, gw = tm.plan_shuffle(n_owned, n_bucket, pad,
                                            basis=basis)
            wt, wplan, ww = jm.plan_shuffle(n_owned, n_bucket, pad,
                                            basis=basis)
            assert (gt, gw) == (wt, ww)
            assert len(gplan) == len(wplan)
            for (gi, g1, g2), (wi, w1, w2) in zip(gplan, wplan):
                np.testing.assert_array_equal(gi, wi)
                assert (g1, g2) == (w1, w2)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_choosers_match_reference(name):
    tm, jm = _models(name)
    for d in (1, 3):
        assert tm.choose_codec(d=d) == jm.choose_codec(d=d) == "identity"
    with pytest.raises(ValueError):
        tm.choose_codec(candidates=["int8"])
    assert tm.choose_blocked_chunk() == jm.choose_blocked_chunk()
    for n, kw in ((10_000_000, {}), (5, {}), (10 ** 9, dict(
            bytes_per_row=1e6, max_split_bytes=128e6)), (4096, dict(d=1))):
        assert tm.choose_split_rows(n, **kw) == jm.choose_split_rows(n, **kw)
    for args in ((0.0, 1e9, 64), (1e12, 1e6, 64), (1e9, 1e9, 256, 8),
                 (10e6, 4e6, 256)):
        assert tm.choose_spill_ranges(*args) == jm.choose_spill_ranges(*args)


def test_choose_blocked_chunk_prefers_measured_faster():
    tm, _ = _models("calibrated")
    assert tm.choose_blocked_chunk() == (128, 128, 512)
    assert _models("card")[0].choose_blocked_chunk() == cm.DEFAULT_CHUNK


@pytest.mark.parametrize("seed", range(40))
def test_plan_tiers_options_match_reference(seed):
    """Every option of the planner: ``max_tiers`` 1-4 (past 3 the
    depth-first search), ``pad_partitions_to``, and a predicted-wall
    ``tier_cost`` from one shared profile."""
    rng = np.random.default_rng(seed)
    P = int(rng.integers(1, 40))
    tile = int(rng.choice([1, 8, 64, 256]))
    pad = int(rng.choice([1, 2, 4]))
    kmax = int(rng.choice([1, 2, 3, 4]))
    n_bucket = rng.integers(0, 2000, P)
    n_owned = rng.integers(0, 2000, P)
    tm, jm = _models(("calibrated", "card", "cpu")[seed % 3])
    for tier_cost in (None, "pairs", "rows"):
        got = tjob.plan_tiers(
            n_owned, n_bucket, tile, max_tiers=kmax, pad_partitions_to=pad,
            tier_cost=tier_cost and tm.tier_cost_fn(basis=tier_cost))
        want = jjob.plan_tiers(
            n_owned, n_bucket, tile, max_tiers=kmax, pad_partitions_to=pad,
            tier_cost=tier_cost and jm.tier_cost_fn(basis=tier_cost))
        assert len(got) == len(want)
        for (gi, g1, g2), (wi, w1, w2) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert (g1, g2) == (w1, w2)


# ---------------------------------------------------------------------------
# auto knobs: bit identity, the tile the reference would plan, predictions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("engine", ["device", "host"])
def test_auto_knobs_bit_identical(isolated_model, seed, engine):
    rng = np.random.default_rng(seed)
    xyz = sky.make_catalog(int(rng.integers(200, 1200)), seed)
    part = T.ZonePartitioner(0.05)
    hand = [T.neighbor_search_job(0.05, partitioner=part, tile=256),
            T.neighbor_statistics_job(np.linspace(0.01, 0.05, 5) / sky.ARCSEC,
                                      partitioner=part, tile=256)]
    auto = [dataclasses.replace(j, codec="auto", tile="auto") for j in hand]
    r_hand = T.run_jobs(hand, xyz, engine=engine, device="cpu")
    r_auto = T.run_jobs(auto, xyz, engine=engine, device="cpu")
    assert r_auto[0].output == r_hand[0].output
    np.testing.assert_array_equal(r_auto[1].output, r_hand[1].output)
    st = r_auto[0].stats
    assert st.codec == "identity" and T.get_codec(st.codec).exact
    # the host engine's results do not depend on the tile: it takes 256
    assert st.auto_tile in ((0,) if engine == "host" else cm.TILE_CANDIDATES)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_auto_knobs_bit_identical_wordcount(isolated_model, engine):
    toks = np.random.default_rng(3).integers(0, 3000, 20000)
    hand = T.token_histogram_job(3000, n_partitions=8, tile=256)
    auto = dataclasses.replace(hand, codec="auto", tile="auto")
    got = T.run_job(auto, toks.astype(np.float32), engine=engine,
                    device="cpu")
    np.testing.assert_array_equal(
        got.output, T.run_job(hand, toks.astype(np.float32), engine=engine,
                              device="cpu").output)
    np.testing.assert_array_equal(got.output, np.bincount(toks,
                                                          minlength=3000))


class _HostZonesT(T.ZonePartitioner):
    assign_device = T.Partitioner.assign_device
    bucket_entries_device = T.Partitioner.bucket_entries_device


class _HostZonesR(R.ZonePartitioner):
    assign_device = R.Partitioner.assign_device
    bucket_entries_device = R.Partitioner.bucket_entries_device


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_auto_tile_is_the_references(shared_profile, name):
    """Under one profile, ``tile="auto"`` resolves to the reference's tile
    and tiers on the same partition counts (both sides take their zone keys
    from the same numpy ``assign``), and ``shuffle_once`` keeps it."""
    shared_profile(name)
    xyz = sky.make_catalog(3000, 7)
    got = T.run_job(T.neighbor_search_job(
        0.05, partitioner=_HostZonesT(0.05), tile="auto"), xyz,
        device="cpu").stats
    want = R.run_job(R.neighbor_search_job(
        0.05, partitioner=_HostZonesR(0.05), tile="auto"), xyz,
        engine="device").stats
    assert got.auto_tile == want.auto_tile > 0
    assert got.reduce_flops == want.reduce_flops        # the same tiers
    cat = T.shuffle_once(_HostZonesT(0.05), xyz, tile="auto", device="cpu")
    assert cat.tile == "auto" and cat.tile_resolved == got.auto_tile
    assert cat.run(T.neighbor_search_job(0.05, partitioner=cat.partitioner,
                                         tile="auto"))[0].output > 0


def test_predicted_walls_recorded_and_error_observable(isolated_model):
    xyz = sky.make_catalog(3000, 0)
    job = T.neighbor_search_job(0.05)
    st = T.run_job(job, xyz, device="cpu").stats
    assert st.predicted_shuffle_wall_s > 0
    assert st.predicted_reduce_wall_s > 0
    assert st.prediction_error >= 1.0
    assert st.to_dict()["prediction_error"] == st.prediction_error
    # the reduce is charged the real cells the masked kernels walk
    m = get_cost_model(device="cpu")
    cat = T.shuffle_once(job.partitioner, xyz, device="cpu")
    cost = cat.reduce_cost([job.reducer])
    assert cost.flops == cm.FP32_OPS_PER_CELL * cat.sd.real_pair_cells
    assert cat.sd.real_pair_cells < cat.sd.pair_cells
    st2 = cat.run(job)[0].stats
    assert st2.predicted_reduce_wall_s == m.predict_wall(cost)
    # the host engine records no device prediction: its error reads 0.0
    st3 = T.run_job(job, xyz, engine="host", device="cpu").stats
    assert st3.prediction_error == 0.0


def test_prediction_error_folds_both_directions():
    st = T.StageStats(shuffle_wall_s=1.0, predicted_shuffle_wall_s=0.25,
                      reduce_wall_s=1.0, predicted_reduce_wall_s=3.0)
    assert st.prediction_error == 4.0
    assert T.StageStats().prediction_error == 0.0


# ---------------------------------------------------------------------------
# split rows and spill ranges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["device", "host"])
def test_split_rows_auto_and_int_equal_monolithic(isolated_model, engine):
    xyz = sky.make_catalog(2000, 4)
    jobs = [T.neighbor_search_job(0.05)]
    mono = T.run_jobs(jobs, xyz, engine=engine, device="cpu")[0]
    auto = T.run_jobs(jobs, xyz, engine=engine, device="cpu",
                      split_rows="auto")[0]
    assert auto.output == mono.output and auto.stats.n_splits == 1
    split = T.run_jobs(jobs, xyz, engine=engine, device="cpu",
                       split_rows=700)[0]
    assert split.output == mono.output and split.stats.n_splits == 3
    # a profile with a cheap dispatch asks for small splits
    cm._MODEL_CACHE[backend_fingerprint(CPU)] = CostModel(
        BackendProfile("fp", 2e10, 1e10, 2e-9))
    rows = get_cost_model(device="cpu").choose_split_rows(len(xyz))
    assert rows < len(xyz)
    auto = T.run_jobs(jobs, xyz, engine=engine, device="cpu",
                      split_rows="auto")[0]
    assert auto.output == mono.output
    assert auto.stats.n_splits == -(-len(xyz) // rows)


def test_spill_auto_ranges_equal_monolithic(isolated_model, tmp_path):
    xyz = sky.make_catalog(3000, 4)
    job = T.neighbor_search_job(0.03, tile=128)
    want = T.run_job(job, xyz, device="cpu").output
    est = None
    for budget in (20_000, 0):
        res = T.run_job_streaming(
            job, tp.ArraySplits(xyz, n_splits=4),
            spill=T.SpillConfig(budget_bytes=budget,
                                dir=str(tmp_path / f"sp{budget}"),
                                n_ranges="auto"), device="cpu")
        assert res.output == want
        assert res.stats.spill_ranges >= 1 and res.stats.spill_bytes > 0
        est = res.stats.spill_bytes
    # the lanes path asks the same chooser
    res = T.run_job_streaming(
        job, tp.ArraySplits(xyz, n_splits=4), n_lanes=2,
        spill=T.SpillConfig(budget_bytes=20_000, dir=str(tmp_path / "lanes"),
                            n_ranges="auto"), device="cpu")
    assert res.output == want and est > 0
