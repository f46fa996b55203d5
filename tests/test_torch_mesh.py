"""The port's data-axis mesh held against the JAX package, on the CPU.

One gloo world of 4 ranks (spawned, meeting through a ``FileStore`` under
the test's tmp dir) runs every scenario once, on a ``("data",)`` mesh of 4
and on a ``("data", "model")`` mesh of (2, 2) (the module fixture
``world``); each case below is then its own test of what the ranks
returned. Every rank must return the same results, and rank 0's must equal
the JAX package's single-device ``run_jobs`` (its device engine through the
plain refs of its Pallas kernels, called eagerly, as in
``test_torch_mapreduce.py``): the reference's own sharded results equal its
single-device ones (``tests/md_check.py`` mapreduce checks), so the JAX
side needs no mesh in process. Wordcount is held to ``np.bincount`` too.

The ``auto-*`` cases give every rank a cost model of its own first (rank r
dispatches 1000**r times slower), so the ranks would plan different tiers
from the same counts; they run with ``tile="auto"``, lanes, speculation
and a straggler split that differs by rank, and must still agree: the mesh
plans with its first rank's model, and no lane issues a collective.

``n_shards`` and ``shard_padded_ratio`` against the reference's at D = 8
are in ``test_torch_collectives.py``, whose world has 8 ranks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.mapreduce as R  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.data.pipeline import ArraySplits  # noqa: E402
from repro_torch.ft import FaultySplitSource, SpeculativeConfig  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_world  # noqa: E402
from test_torch_mapreduce import _jobs  # noqa: E402

ARCSEC = sky.ARCSEC
WORLD = 4
MESHES = {"data4": ((4,), ("data",)), "data2x2": ((2, 2), ("data", "model"))}
VOCAB = 500


def _skewed():
    """``md_check.py``'s skewed catalog: its crowded tier has fewer real
    partitions than shards."""
    rng = np.random.default_rng(11)
    base = sky.make_catalog(900, 1)
    pts = np.concatenate([base, base[:1] + rng.normal(0, 1e-3, (600, 3))])
    return (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(
        np.float32)


# name: (catalog, radius, codec, how the port runs it)
PAIR_CASES = {
    "device-identity": (lambda: sky.make_catalog(1200, 7), 0.1, "identity",
                        "device"),
    "device-int16": (lambda: sky.make_catalog(1200, 7), 0.1, "int16",
                     "device"),
    "host-identity": (lambda: sky.make_catalog(1200, 7), 0.1, "identity",
                      "host"),
    "host-int16": (lambda: sky.make_catalog(1200, 7), 0.1, "int16", "host"),
    "stream2": (lambda: sky.make_catalog(1200, 7), 0.1, "identity",
                "stream2"),
    "stream5": (lambda: sky.make_catalog(1200, 7), 0.1, "int16", "stream5"),
    "spill0": (lambda: sky.make_catalog(1200, 7), 0.1, "int16", "spill0"),
    "lanes": (lambda: sky.make_catalog(1200, 7), 0.1, "identity", "lanes"),
    "lanes-spill0": (lambda: sky.make_catalog(1200, 7), 0.1, "int16",
                     "lanes-spill0"),
    "ragged-700": (lambda: sky.make_catalog(700, 3), 0.09, "identity",
                   "device"),
    "ragged-150": (lambda: sky.make_catalog(150, 1), 0.25, "int16",
                   "device"),
    "skewed": (_skewed, 0.08, "identity", "device"),
    "empty": (lambda: np.zeros((0, 3), np.float32), 0.05, "identity",
              "device"),
}
# name: (tokens, vocab, how the port runs it)
WORDCOUNT_CASES = {
    "wc-device": (lambda: np.random.default_rng(1).integers(0, VOCAB, 4000),
                  VOCAB, "device"),
    "wc-host": (lambda: np.random.default_rng(1).integers(0, VOCAB, 4000),
                VOCAB, "host"),
    "wc-empty-partitions": (
        lambda: np.random.default_rng(0).integers(0, 3, 1000), 3, "device"),
    "wc-stream": (lambda: np.random.default_rng(2).integers(0, VOCAB, 3000),
                  VOCAB, "stream3"),
    "wc-lanes": (lambda: np.random.default_rng(2).integers(0, VOCAB, 3000),
                 VOCAB, "lanes"),
}
# name: how the port runs it, each with tile="auto" and a model per rank
AUTO_CASES = {
    "auto-device": "device",
    "auto-lanes": "lanes",
    "auto-lanes-spill0": "lanes-spill0",
    "wc-auto-lanes": "wordcount",
}
CASES = (sorted(PAIR_CASES) + sorted(WORDCOUNT_CASES) + sorted(AUTO_CASES)
         + ["zone-reduce"])
AUTO_RADIUS = 0.1


def _edges_arcsec(radius):
    return np.linspace(radius / 5, radius, 5) / ARCSEC


def _stats(st):
    return {"n_shards": st.n_shards, "engine": st.engine,
            "shard_padded_ratio": st.shard_padded_ratio,
            "collective_wall_s": st.collective_wall_s}


def _run_pairs(case, mesh):
    make, radius, codec, how = PAIR_CASES[case]
    xyz = make()
    jobs = _jobs((radius,), _edges_arcsec(radius), codec, 64, jax_side=False)
    kw = dict(mesh=mesh, device="cpu")
    if how in ("device", "host"):
        res = T.run_jobs(jobs, xyz, engine=how, **kw)
    elif how.startswith("stream"):
        res = T.run_jobs_streaming(jobs, ArraySplits(xyz, int(how[6:])),
                                   **kw)
    elif how == "spill0":
        res = T.run_jobs_streaming(jobs, ArraySplits(xyz, 4), spill=0, **kw)
    elif how == "lanes":
        res = T.run_jobs_streaming(jobs, ArraySplits(xyz, 3), n_lanes=2, **kw)
    else:
        res = T.run_jobs_streaming(jobs, ArraySplits(xyz, 3), n_lanes=2,
                                   spill=0, **kw)
    return [np.asarray(r.output).tolist() for r in res], _stats(res[0].stats)


def _run_wordcount(case, mesh):
    make, vocab, how = WORDCOUNT_CASES[case]
    toks = make()
    if how in ("device", "host"):
        res = T.token_histogram(toks, vocab, tile=64, mesh=mesh, engine=how,
                                device="cpu")
    else:
        res = T.run_jobs_streaming(
            [T.token_histogram_job(vocab, tile=64)],
            ArraySplits(toks.astype(np.float32), 3), mesh=mesh, device="cpu",
            n_lanes=2 if how == "lanes" else 1)[0]
    return [np.asarray(res.output).tolist()], _stats(res.stats)


def _run_zone_reduce(mesh):
    """The legacy surface: zones padded to the data axis, reduced sharded."""
    D = T.job._data_axis_size(mesh)
    zd = T.bucket_by_zone(sky.make_catalog(1500, 5), 0.05, pad_zones_to=D,
                          device="cpu")
    total = T.sharded_zone_reduce(lambda o, b: (b[:, 2] > 0).sum(), zd, mesh,
                                  device="cpu")
    return [int(total)], {}


def _own_model(rank):
    """A cost model of this rank's own: the defaults, dispatching 1000**rank
    times slower (enough to move the tier plan of ``AUTO_CASES``)."""
    cm.reset_cost_model()
    cpu = torch.device("cpu")
    base = cm.CostModel.load(device=cpu).profile
    cm._MODEL_CACHE[cm.backend_fingerprint(cpu)] = cm.CostModel(
        dataclasses.replace(base, dispatch_s=base.dispatch_s * 1000.0 ** rank))
    return base


def _auto_items(case):
    if case.startswith("wc-"):
        return np.random.default_rng(2).integers(0, VOCAB, 3000)
    return sky.make_catalog(1200, 7)


def _run_auto(case, mesh, rank):
    """One ``AUTO_CASES`` case; a straggler split whose index differs by
    rank draws a speculated clone on some ranks and not on others."""
    base = _own_model(rank)
    how = AUTO_CASES[case]
    items = _auto_items(case)
    kw = dict(mesh=mesh, device="cpu")
    lanes = dict(n_lanes=2, speculate=SpeculativeConfig(slowdown=2.0,
                                                        min_finished=2))
    if how == "wordcount":
        jobs = [T.token_histogram_job(VOCAB, tile="auto")]
        items = items.astype(np.float32)
    else:
        jobs = _jobs((AUTO_RADIUS,), _edges_arcsec(AUTO_RADIUS), "identity",
                     "auto", jax_side=False)
    src = FaultySplitSource(ArraySplits(items, 5), delays={1 + rank % 2: 0.3})
    if how == "device":
        res = T.run_jobs(jobs, items, split_rows="auto", **kw)
    elif how == "lanes-spill0":
        res = T.run_jobs_streaming(jobs, src, spill=0, **lanes, **kw)
    else:
        res = T.run_jobs_streaming(jobs, src, **lanes, **kw)
    st = res[0].stats
    stats = dict(_stats(st), auto_tile=st.auto_tile,
                 tiers=sorted(st.tiers),       # in the lanes' commit order
                 model_is_first_ranks=(cm.get_cost_model(
                     device="cpu").profile == base))
    cm.reset_cost_model()
    return [np.asarray(r.output).tolist() for r in res], stats


def _scenarios(rank, world):
    """Every case on every mesh, on this rank. -> {(mesh, case): (outputs,
    stats)}."""
    torch.set_num_threads(1)     # the ranks share the machine's cores
    out = {}
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes, device_type="cpu")
        for case in CASES:
            if case in PAIR_CASES:
                out[name, case] = _run_pairs(case, mesh)
            elif case in WORDCOUNT_CASES:
                out[name, case] = _run_wordcount(case, mesh)
            elif case in AUTO_CASES:
                out[name, case] = _run_auto(case, mesh, rank)
            else:
                out[name, case] = _run_zone_reduce(mesh)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = tmp_path_factory.mktemp("mesh") / "store"
    return spawn_world(_scenarios, WORLD, init_file=str(store),
                       timeout_s=900)


def _jax_pairs(case):
    make, radius, codec, _ = PAIR_CASES[case]
    jobs = _jobs((radius,), _edges_arcsec(radius), codec, 64, jax_side=True)
    return [np.asarray(r.output).tolist()
            for r in R.run_jobs(jobs, make(), engine="device")]


def _want(case):
    if case in PAIR_CASES:
        return _jax_pairs(case)
    if case in AUTO_CASES and not case.startswith("wc-"):
        jobs = _jobs((AUTO_RADIUS,), _edges_arcsec(AUTO_RADIUS), "identity",
                     64, jax_side=True)
        return [np.asarray(r.output).tolist()
                for r in R.run_jobs(jobs, _auto_items(case), engine="device")]
    if case in AUTO_CASES:
        toks = _auto_items(case)
        return [np.bincount(toks, minlength=VOCAB).tolist()]
    if case in WORDCOUNT_CASES:
        make, vocab, _ = WORDCOUNT_CASES[case]
        toks = make()
        jax_out = R.token_histogram(toks, vocab, tile=64).output
        np.testing.assert_array_equal(jax_out,
                                      np.bincount(toks, minlength=vocab))
        return [np.asarray(jax_out).tolist()]
    zd = R.bucket_by_zone(sky.make_catalog(1500, 5), 0.05)
    return [int(R.sharded_zone_reduce(lambda o, b: (b[:, 2] > 0).sum(), zd))]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_equals_jax_single_device(world, mesh, case):
    got = [ranks[mesh, case][0] for ranks in world]
    assert all(g == got[0] for g in got), f"ranks disagree: {got}"
    assert got[0] == _want(case)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_stats(world, mesh):
    """The reduce ran over the data axis: ``n_shards`` is its size, one
    padded/real ratio a shard, the same on every rank, and the all-reduces
    were timed."""
    D = MESHES[mesh][0][0]
    for case in sorted(PAIR_CASES) + sorted(WORDCOUNT_CASES):
        st = [ranks[mesh, case][1] for ranks in world]
        assert st[0]["n_shards"] == D, case
        assert len(st[0]["shard_padded_ratio"]) == D, case
        assert all(s["shard_padded_ratio"] == st[0]["shard_padded_ratio"]
                   for s in st), case
        assert st[0]["collective_wall_s"] > 0, case
    assert world[0][mesh, "device-identity"][1]["engine"] == "device"


@pytest.mark.parametrize("case", sorted(AUTO_CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_auto_knobs_agree_across_ranks(world, mesh, case):
    """Ranks with models of their own plan with the mesh's first rank's
    model: one tile and one tier plan on every rank, and each rank's model
    is rank 0's once the run is over."""
    st = [ranks[mesh, case][1] for ranks in world]
    assert all(s["model_is_first_ranks"] for s in st), case
    assert all((s["auto_tile"], s["tiers"]) == (st[0]["auto_tile"],
                                                st[0]["tiers"])
               for s in st), [(s["auto_tile"], s["tiers"]) for s in st]
    assert st[0]["auto_tile"] in cm.TILE_CANDIDATES
    assert st[0]["n_shards"] == MESHES[mesh][0][0]


def test_engine_auto_is_device_under_a_mesh_and_rank_count_one_is_unsharded():
    """In process: a one-rank (1, 1) mesh has D = 1, so the reduce is the
    single-device one (no collective), and ``engine="auto"`` picks the
    device engine."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_cpu_mesh
    was = dist.is_initialized()
    mesh = make_cpu_mesh()
    try:
        xyz = sky.make_catalog(800, 2)
        job = T.neighbor_search_job(0.1, tile=64)
        got = T.run_job(job, xyz, mesh=mesh, device="cpu")
        want = T.run_job(job, xyz, device="cpu")
        assert got.output == want.output
        assert got.stats.engine == "device" and got.stats.n_shards == 1
        assert got.stats.collective_wall_s == 0.0
        assert got.stats.shard_padded_ratio == want.stats.shard_padded_ratio
    finally:
        if not was:
            dist.destroy_process_group()


def test_mesh_device_rules(monkeypatch):
    """Under a mesh ``device=None`` means the rank's card, which this box
    lacks; a device of another type than the mesh's raises."""
    from repro_torch.core.device import resolve_device

    class CpuMesh:
        device_type = "cpu"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None, CpuMesh())
    with pytest.raises(ValueError, match="mesh's device type"):
        resolve_device("meta", CpuMesh())
    assert resolve_device("cpu", CpuMesh()).type == "cpu"
