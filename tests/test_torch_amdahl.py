"""The port's Amdahl / roofline analysis against the JAX package's.

``RooflineTerms`` priced at a ``DeviceSpec`` holding the reference's TPU v5e
constants must give the reference's numbers exactly (floats to rel 1e-12),
``balance_report``/``suggest`` its text, and a run's ``StageStats`` the same
``roofline()`` and ``to_dict()["amdahl"]`` as the reference's run of the
same jobs on the same catalog (the CPU device engine; both sides take
their zone keys and border copies from the same numpy ``assign`` and
``replicas``, so the tiers, and so the byte and FLOP accounting, agree).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.amdahl as jam  # noqa: E402
import repro.mapreduce as R  # noqa: E402
from repro.core.balance import balance_report as jreport  # noqa: E402
from repro.core.balance import suggest as jsuggest  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.core import (DeviceSpec, RooflineTerms,  # noqa: E402
                              balance_report, device_spec,
                              model_flops_decode, model_flops_prefill,
                              model_flops_train, suggest)
from repro_torch.data import sky  # noqa: E402

JAX_SPEC = DeviceSpec(name="TPU v5e (the reference's constants)",
                      peak_flops=jam.PEAK_FLOPS, hbm_bw=jam.HBM_BW,
                      link_bw=jam.ICI_BW, n_links=jam.ICI_LINKS_PER_CHIP,
                      cross_bw=jam.CROSS_POD_BW)


def _assert_same_dict(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        else:
            assert got[k] == pytest.approx(w, rel=1e-12, abs=0.0), k


def _term_sets(n=24):
    rng = np.random.default_rng(0)
    for i in range(n):
        kw = dict(flops=float(10 ** rng.uniform(6, 16)),
                  hbm_bytes=float(10 ** rng.uniform(5, 13)),
                  coll_bytes_intra=float(10 ** rng.uniform(3, 12)),
                  coll_bytes_cross=float(10 ** rng.uniform(3, 11)),
                  chips=int(rng.choice([1, 2, 4, 8, 256])),
                  model_flops=float(10 ** rng.uniform(5, 16)),
                  chip_w=float(rng.choice([0.0, 200.0, 700.0])))
        # degenerate cases: no FLOPs, no I/O, no model FLOPs
        if i % 6 == 1:
            kw["flops"] = 0.0
        if i % 6 == 2:
            kw.update(hbm_bytes=0.0, coll_bytes_intra=0.0,
                      coll_bytes_cross=0.0)
        if i % 6 == 3:
            kw["model_flops"] = 0.0
        yield kw


@pytest.mark.parametrize("kw", list(_term_sets()))
def test_roofline_terms_match_reference(kw):
    got = RooflineTerms(**kw, spec=JAX_SPEC)
    want = jam.RooflineTerms(**kw)
    _assert_same_dict(got.to_dict(), want.to_dict())
    assert got.dominant == want.dominant
    assert got.mfu_bound == want.mfu_bound
    assert got.power_w == want.power_w
    assert balance_report("cell", got) == jreport("cell", want)
    assert suggest(got) == jsuggest(want)


@pytest.mark.parametrize("kw", list(_term_sets(6)))
def test_from_stage_bytes_matches_reference(kw):
    args = dict(flops=kw["flops"], hbm_bytes=kw["hbm_bytes"],
                wire_bytes=kw["coll_bytes_intra"], chips=kw["chips"],
                model_flops=kw["model_flops"], chip_w=kw["chip_w"])
    _assert_same_dict(
        RooflineTerms.from_stage_bytes(**args, spec=JAX_SPEC).to_dict(),
        jam.RooflineTerms.from_stage_bytes(**args).to_dict())


@pytest.mark.parametrize("useful", [0.1, 0.9])
def test_suggest_covers_every_dominant_term(useful):
    """Each branch of ``suggest``: compute-bound at a low and a high useful
    ratio, memory-bound, collective-bound."""
    for flops, hbm, coll in ((1e18, 1.0, 1.0), (1.0, 1e15, 1.0),
                             (1.0, 1.0, 1e15)):
        kw = dict(flops=flops, hbm_bytes=hbm, coll_bytes_intra=coll,
                  coll_bytes_cross=0.0, chips=1, model_flops=useful * flops)
        assert suggest(RooflineTerms(**kw, spec=JAX_SPEC)) == \
            jsuggest(jam.RooflineTerms(**kw))


def test_model_flops_match_reference():
    for n, tok in ((1_100_000_000, 2048), (7, 3)):
        assert model_flops_train(n, tok) == jam.model_flops_train(n, tok)
        assert model_flops_prefill(n, tok) == jam.model_flops_prefill(n, tok)
        assert model_flops_decode(n, tok) == jam.model_flops_decode(n, tok)


def test_no_spec_off_the_card():
    """There is no CPU spec: a CPU run prices its roofline only at a spec
    its caller passes, and ``to_dict`` says so with ``amdahl: None``."""
    with pytest.raises(ValueError, match="spec"):
        device_spec("cpu")
    st = T.StageStats(device="cpu", reduce_flops=1e9, map_bytes=10)
    with pytest.raises(ValueError, match="spec"):
        st.roofline()
    assert st.to_dict()["amdahl"] is None
    assert st.to_dict(spec=JAX_SPEC)["amdahl"]["flops"] == 1e9


class _HostZonesT(T.ZonePartitioner):
    assign_device = T.Partitioner.assign_device
    bucket_entries_device = T.Partitioner.bucket_entries_device


class _HostZonesR(R.ZonePartitioner):
    assign_device = R.Partitioner.assign_device
    bucket_entries_device = R.Partitioner.bucket_entries_device


def _zone_jobs(side, part, codec):
    radius = part.radius
    edges = np.linspace(radius / 4, radius, 5) / sky.ARCSEC
    return [side.neighbor_search_job(radius, partitioner=part, codec=codec,
                                     tile=64),
            side.neighbor_search_job(radius / 2, partitioner=part,
                                     codec=codec, tile=64),
            side.neighbor_statistics_job(edges, partitioner=part,
                                         codec=codec, tile=64)]


@pytest.mark.parametrize("codec", ["identity", "int16"])
@pytest.mark.parametrize("chips", [1, 4])
def test_stage_stats_roofline_matches_reference(codec, chips):
    xyz = sky.make_catalog(2000, 5)
    got = T.run_jobs(_zone_jobs(T, _HostZonesT(0.05), codec), xyz,
                     device="cpu")[0].stats
    want = R.run_jobs(_zone_jobs(R, _HostZonesR(0.05), codec), xyz,
                      engine="device")[0].stats
    assert got.tiers and got.device == "cpu"
    for f in ("reduce_flops", "map_bytes", "reduce_bytes",
              "shuffle_wire_bytes", "spill_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    _assert_same_dict(got.roofline(chips, 700.0, spec=JAX_SPEC).to_dict(),
                      want.roofline(chips, 700.0).to_dict())
    _assert_same_dict(got.to_dict(chips, spec=JAX_SPEC)["amdahl"],
                      want.to_dict(chips)["amdahl"])


def test_wordcount_stats_roofline_matches_reference():
    toks = np.random.default_rng(2).integers(0, 500, 6000).astype(np.float32)
    got = T.run_job(T.token_histogram_job(500, tile=64), toks,
                    device="cpu").stats
    want = R.run_job(R.token_histogram_job(500, tile=64), toks,
                     engine="device").stats
    _assert_same_dict(got.to_dict(spec=JAX_SPEC)["amdahl"],
                      want.to_dict()["amdahl"])
