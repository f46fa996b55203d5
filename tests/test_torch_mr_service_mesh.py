"""The port's MapReduce query service under a data-axis mesh, held against
the JAX package: ``tests/md_check.py``'s ``check_mapreduce_service_sharded``
(the reference's one service case the port's ``test_torch_mr_service.py``
does not mirror), on the CPU.

One gloo world of 4 ranks (spawned, meeting through a ``FileStore`` under
the test's tmp dir) runs every scenario once, on a ``("data",)`` mesh of 4
and on a ``("data", "model")`` mesh of (2, 2) (the module fixture
``world``); each case below is then its own test of what the ranks
returned. The service is SPMD: rank 0 takes the clients and the other
ranks follow its batches, so every rank returns the outputs of the same
requests. Rank 0's outputs come from the requests ``submit`` returned,
the others' from ``MRQueryService.followed``. Every rank must equal the
port's per-query ``run_job`` under the same mesh and the JAX package's
single-device ``run_jobs`` (its device engine through the plain refs of
its Pallas kernels, called eagerly, as ``test_torch_mesh.py`` runs it).

Every wait in the service times out (``MESH_TIMEOUT_S``), and ``spawn_world``
kills a world that outlives its own timeout: a hang fails the module.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.mapreduce as R  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_world  # noqa: E402
from repro_torch.mapreduce import MapReduceJob, PairCountReducer  # noqa: E402
from repro_torch.serving import MRQueryService  # noqa: E402
from repro_torch.serving import mr_service  # noqa: E402
from test_torch_mapreduce import _jobs  # noqa: E402

WORLD = 4
MESHES = {"data4": ((4,), ("data",)), "data2x2": ((2, 2), ("data", "model"))}
RADIUS = 0.09
N, SEED = 900, 5
POISON_RANK = 1
IDLE_TIMEOUT_S = 5.0     # the idle case's MESH_TIMEOUT_S; it idles 2.5x that


def _edges_arcsec():
    return np.linspace(0.03, RADIUS, 4) / sky.ARCSEC


def _port_jobs():
    """Search at RADIUS/2 and RADIUS, and statistics, over one
    ``ZonePartitioner(RADIUS)``, int16, tile 64."""
    return _jobs((RADIUS / 2, RADIUS), _edges_arcsec(), "int16", 64,
                 jax_side=False)


@dataclasses.dataclass(frozen=True)
class RankPoison(PairCountReducer):
    """A pair count whose reduce raises on one rank only: a query that
    every rank admits and only one fails."""

    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        import torch.distributed as dist
        if dist.get_rank() == POISON_RANK:
            raise ValueError(f"poison on rank {POISON_RANK}")
        return super().reduce_partitions(owned, bucket, n_owned, n_bucket)


def _out(x):
    return np.asarray(x).tolist()


def _served(svc, reqs):
    """This rank's requests: rank 0's own, the others' mirrored."""
    return reqs if reqs is not None else svc.followed


def _sync_case(mesh, rank, xyz, jobs):
    """``md_check.py``'s service check: 6 requests in batches of 4, served
    by ``run_pending`` on every rank under the operation census."""
    from repro_torch.core import op_census
    svc = MRQueryService(mesh=mesh, device="cpu", max_batch=4)
    cat = svc.load_catalog("sky", xyz, jobs[0].partitioner, codec="int16",
                           tile=64)
    n_shards = cat.run(jobs[0])[0].stats.n_shards
    reqs = None
    submit_error = None
    if rank == 0:
        reqs = [svc.submit(j, catalog="sky") for j in jobs + jobs]
    else:
        try:
            svc.submit(jobs[0], catalog="sky")
        except RuntimeError as e:
            submit_error = str(e)
    with op_census.census() as c:
        served = svc.run_pending()      # batches of 4: [j0 j1 j2 j0] [j1 j2]
    allreduces = sum(col.op == "all-reduce" for col in c.collectives)
    outs = [_out(r.output) for r in _served(svc, reqs)]
    rec = {"n_shards": n_shards, "served": served,
           "batches": [(b["size"], b["n_unique"], b["allreduces"])
                       for b in svc.batches],
           "census_allreduces": allreduces, "outputs": outs,
           "submit_error": submit_error,
           "collective_wall_s": [b["collective_wall_s"] for b in svc.batches]}

    # a job that does not pickle cannot reach the other ranks: refused at
    # submit, and the service goes on serving
    @dataclasses.dataclass(frozen=True)
    class LocalCount(PairCountReducer):
        pass

    rec["unpicklable_error"] = None
    if rank == 0:
        try:
            svc.submit(MapReduceJob("local", jobs[0].partitioner,
                                    LocalCount(RADIUS), codec="int16",
                                    tile=64), catalog="sky")
        except TypeError as e:
            rec["unpicklable_error"] = str(e)

    # a batch holding a reducer that raises on one rank only
    poison = MapReduceJob("poison", jobs[0].partitioner,
                          RankPoison(RADIUS), codec="int16", tile=64)
    if rank == 0:
        reqs = [svc.submit(j, catalog="sky")
                for j in (jobs[0], poison, jobs[2], jobs[0])]
        n0 = 0
    else:
        n0 = len(svc.followed)
    served = svc.run_pending()
    mine = reqs if rank == 0 else svc.followed[n0:]
    rec["poison"] = [(None if r.error is not None else _out(r.output),
                      None if r.error is None else
                      (type(r.error).__name__, str(r.error)))
                     for r in mine]
    rec["poison_batch"] = (served, svc.batches[-1]["size"],
                           svc.batches[-1]["allreduces"])
    svc.close()
    rec["closed"] = svc.closed
    return rec


def _threaded_case(mesh, rank, xyz, jobs):
    """The background path after one batch through ``run_pending``: ``with
    svc:`` on every rank, 2 lanes, 12 requests submitted on rank 0; the
    other ranks' ``close`` returns at rank 0's stop."""
    svc = MRQueryService(mesh=mesh, device="cpu", max_batch=4,
                         max_wait_s=0.01, n_lanes=2)
    svc.load_catalog("sky", xyz, jobs[0].partitioner, codec="int16",
                     tile=64)
    if rank == 0:
        svc.submit(jobs[0], catalog="sky")
    svc.run_pending()
    svc.batches.clear()
    svc.followed.clear()
    reqs = None
    with svc:
        if rank == 0:
            reqs = [svc.submit(jobs[i % 3], catalog="sky") for i in range(12)]
            for r in reqs:
                r.result(timeout=120)
    return {"outputs": [_out(r.output) for r in _served(svc, reqs)],
            "batches": [(b["size"], b["allreduces"]) for b in svc.batches],
            "pool_gone": svc._pool is None}


def _idle_case(mesh, rank, xyz, jobs):
    """The background path left idle for 2.5x a ``MESH_TIMEOUT_S`` of 5 s
    before rank 0's first request: the other ranks wait for batches in a
    control group that times out after 5 s, so only rank 0's heartbeats
    keep them alive. Then 3 requests are served on every rank."""
    timeout_s, mr_service.MESH_TIMEOUT_S = (mr_service.MESH_TIMEOUT_S,
                                            IDLE_TIMEOUT_S)
    try:
        svc = MRQueryService(mesh=mesh, device="cpu", max_batch=4)
        svc.load_catalog("sky", xyz, jobs[0].partitioner, codec="int16",
                         tile=64)
        reqs = None
        try:
            with svc:
                if rank == 0:
                    time.sleep(2.5 * IDLE_TIMEOUT_S)
                    reqs = [svc.submit(j, catalog="sky") for j in jobs]
                    for r in reqs:
                        r.result(timeout=60)
        except Exception as e:      # fails this case, not the whole world
            return {"outputs": None, "failure": repr(e)}
    finally:
        mr_service.MESH_TIMEOUT_S = timeout_s
    return {"outputs": [_out(r.output) for r in _served(svc, reqs)],
            "failure": None if svc._failure is None else repr(svc._failure)}


def _scenarios(rank, world):
    torch.set_num_threads(1)     # the ranks share the machine's cores
    xyz = sky.make_catalog(N, SEED)
    jobs = _port_jobs()
    out = {}
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes, device_type="cpu")
        out[name, "sync"] = _sync_case(mesh, rank, xyz, jobs)
        out[name, "threaded"] = _threaded_case(mesh, rank, xyz, jobs)
        if name == "data4":
            out[name, "idle"] = _idle_case(mesh, rank, xyz, jobs)
        out[name, "per_query"] = [
            _out(T.run_job(j, xyz, mesh=mesh, device="cpu").output)
            for j in jobs]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = tmp_path_factory.mktemp("mr-service-mesh") / "store"
    return spawn_world(_scenarios, WORLD, init_file=str(store),
                       timeout_s=600)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX package's single-device outputs of the three jobs."""
    jobs = _jobs((RADIUS / 2, RADIUS), _edges_arcsec(), "int16", 64,
                 jax_side=True)
    res = R.run_jobs(jobs, sky.make_catalog(N, SEED), engine="device")
    return [_out(r.output) for r in res]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_catalog_shards_over_data(world, mesh):
    D = MESHES[mesh][0][0]
    assert [ranks[mesh, "sync"]["n_shards"] for ranks in world] == [D] * WORLD


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_serves_the_same_batches(world, mesh):
    """``run_pending`` on every rank serves batches [4, 2]; the duplicate
    j0 of the first is coalesced (3 distinct jobs)."""
    for ranks in world:
        rec = ranks[mesh, "sync"]
        assert rec["served"] == 6
        assert [(s, u) for s, u, _ in rec["batches"]] == [(4, 3), (2, 2)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_outputs_equal_per_query_mesh_run_and_jax(world, mesh, jax_outputs):
    per_query = [ranks[mesh, "per_query"] for ranks in world]
    assert all(p == jax_outputs for p in per_query), per_query
    for rank, ranks in enumerate(world):
        assert ranks[mesh, "sync"]["outputs"] == jax_outputs * 2, rank


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_threaded_lanes_path(world, mesh, jax_outputs):
    """``with svc:`` and 2 lanes: every rank serves the 12 requests in the
    same batches, equal to the JAX package; each batch one all-reduce."""
    want = [jax_outputs[i % 3] for i in range(12)]
    batches = [ranks[mesh, "threaded"]["batches"] for ranks in world]
    for rank, ranks in enumerate(world):
        rec = ranks[mesh, "threaded"]
        assert rec["outputs"] == want, rank
        assert rec["pool_gone"], rank
    assert all(b == batches[0] for b in batches), batches
    assert sum(s for s, _ in batches[0]) == 12
    assert all(n == 1 for _, n in batches[0]), batches[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_poison_on_one_rank_fails_only_its_request(world, mesh, jax_outputs):
    """A reducer that raises on rank 1 only: its request fails on every
    rank (with rank 1's message; rank 1 keeps its own exception), its
    batch-mates are served on every rank, and no rank hangs."""
    for rank, ranks in enumerate(world):
        rec = ranks[mesh, "sync"]
        good = [p for i, p in enumerate(rec["poison"]) if i != 1]
        assert [g[0] for g in good] == [jax_outputs[0], jax_outputs[2],
                                        jax_outputs[0]], rank
        assert all(g[1] is None for g in good), rank
        out, (kind, msg) = rec["poison"][1]
        assert out is None
        assert f"poison on rank {POISON_RANK}" in msg, (rank, msg)
        if rank == POISON_RANK:
            assert kind == "ValueError"
        else:
            assert kind == "RuntimeError"
            assert f"failed on rank {POISON_RANK}" in msg, msg
        # one batch of 4, its 2 good distinct jobs in one all-reduce
        assert rec["poison_batch"] == (4, 4, 1), rank
        assert rec["closed"], rank


def test_idle_service_outlives_the_mesh_timeout(world, jax_outputs):
    """Rank 0's heartbeats keep the followers' batch waits alive through an
    idle spell longer than ``MESH_TIMEOUT_S``; every rank then serves."""
    for rank, ranks in enumerate(world):
        rec = ranks["data4", "idle"]
        assert rec["failure"] is None, (rank, rec["failure"])
        assert rec["outputs"] == jax_outputs, rank


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_unpicklable_job_is_refused_at_submit(world, mesh):
    """Under a mesh a job must pickle to reach the other ranks: rank 0's
    ``submit`` refuses one that does not, and the batch after it (the
    poison case) is served as usual."""
    msg = world[0][mesh, "sync"]["unpicklable_error"]
    assert msg is not None and "does not pickle" in msg, msg


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_submit_on_a_follower_raises(world, mesh):
    assert world[0][mesh, "sync"]["submit_error"] is None
    for ranks in world[1:]:
        msg = ranks[mesh, "sync"]["submit_error"]
        assert msg is not None and "takes no clients" in msg, msg


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_one_allreduce_per_batch(world, mesh):
    """The census of ``run_pending`` sees one all-reduce a batch, where
    the reference issues one a tier and reducer; the batch records agree
    and the all-reduces were timed."""
    for rank, ranks in enumerate(world):
        rec = ranks[mesh, "sync"]
        assert rec["census_allreduces"] == 2, (rank, rec)
        assert [n for _, _, n in rec["batches"][:2]] == [1, 1], rank
        assert all(w > 0 for w in rec["collective_wall_s"]), rank
