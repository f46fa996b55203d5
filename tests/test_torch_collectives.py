"""The port's mesh collectives, their census and the MapReduce shard
accounting at D = 8, held against the JAX package on the CPU.

One gloo world of 8 ranks (spawned, meeting through a ``FileStore`` under
the test's tmp dir) runs every scenario once (the module fixture
``world``) on the reference's tiny multi-pod mesh, (pod 2, data 2, model 2),
and on a ``("data",)`` mesh of 8. The reference runs the same scenarios in
one subprocess on 8 host devices (``XLA_FLAGS`` forces the count): its
collectives inside ``shard_map`` with ``core/hlo_analysis.py``'s census of
the compiled HLO, and ``run_jobs`` on its own data mesh of 8. Rank r's
input is rank r's slice of the reference's input.

- Every collective's census (count, wire bytes in all, inside a pod and
  across pods, by operator) equals the reference's.
- The plain collectives and the hierarchical all-reduce equal the
  reference's values within ``rtol=1e-6`` (sums in another order), and
  the hierarchical all-reduce equals the flat one as closely.
- ``compressed_psum_1d`` equals the port's own ``quantize_block`` /
  ``dequantize_block`` applied rank by rank, bit for bit, and stays within
  ``md_check.py``'s bound, ``max|flat - compressed| <= 0.03 max|flat|``, of
  the flat sum and of the reference's compressed sum (whose traced
  quantizer multiplies by ``f32(1/127)`` where the port divides: ROADMAP
  queue 3).
- ``n_shards``, ``shard_padded_ratio`` and the outputs of ``run_jobs`` at
  D = 8 equal the reference's, on both engines.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
import repro_torch.mapreduce as T  # noqa: E402
from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.core import compression as Q  # noqa: E402
from repro_torch.core import op_census  # noqa: E402
from repro_torch.data import sky  # noqa: E402
from repro_torch.launch.mesh import (make_mesh, make_tiny_mesh,  # noqa: E402
                                     pod_size, spawn_world)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 8
N = 2085                        # per rank; not a multiple of any block
POD = 4                         # ranks per pod of the (2, 2, 2) mesh
PLAIN_OPS = ("psum-data", "psum-pod", "psum-world", "all-gather-data",
             "reduce-scatter-data", "all-to-all-data", "flat", "hier")
COMPRESSED_OPS = ("hier-int8", "compressed-data")
OPS = PLAIN_OPS + COMPRESSED_OPS
ENGINES = ("device", "host")


def _x(rank: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).normal(size=N).astype(np.float32)


def _mr_jobs(mr):
    """``md_check.py``'s batched apps at D = 8: 1200 objects, 0.1 rad, tile
    64. ``mr`` is ``repro.mapreduce`` or ``repro_torch.mapreduce``."""
    part = mr.ZonePartitioner(0.1)
    edges = np.linspace(0.02, 0.1, 5) / sky.ARCSEC
    return [mr.neighbor_search_job(0.1, partitioner=part, tile=64),
            mr.neighbor_statistics_job(edges, partitioner=part, tile=64)]


# The same scenarios in the JAX package, on 8 host devices: each op inside
# shard_map over the (2, 2, 2) mesh, its compiled HLO's collective census,
# its output; then run_jobs on a data mesh of 8. argv: the .npz to write.
_REFERENCE = '''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_collectives import N, OPS, ENGINES, _x, _mr_jobs
import repro.mapreduce as mr
from repro.core import hlo_analysis
from repro.core.collectives import hierarchical_psum_1d
from repro.core.compat import make_mesh, shard_map
from repro.core.compression import compressed_psum_1d
from repro.data import sky
from repro.launch.mesh import make_tiny_mesh, pod_size

mesh = make_tiny_mesh(multi_pod=True)
x = np.concatenate([_x(r) for r in range(8)])
spec = P(("pod", "data", "model"))
ops = {{
    "psum-data": lambda v: jax.lax.psum(v, "data"),
    "psum-pod": lambda v: jax.lax.psum(v, "pod"),
    "psum-world": lambda v: jax.lax.psum(v, ("pod", "data", "model")),
    "all-gather-data": lambda v: jax.lax.all_gather(v, "data",
                                                    tiled=True)[:N],
    "reduce-scatter-data": lambda v: jnp.tile(jax.lax.psum_scatter(
        jnp.pad(v, (0, 1)), "data", tiled=True), 2)[:N],
    "all-to-all-data": lambda v: jax.lax.all_to_all(
        jnp.pad(v, (0, 1)).reshape(2, -1), "data", 0, 0,
        tiled=False).reshape(-1)[:N],
    "flat": lambda v: jax.lax.psum(v, ("pod", "data")),
    "hier": lambda v: hierarchical_psum_1d(v, "data", "pod"),
    "hier-int8": lambda v: hierarchical_psum_1d(v, "data", "pod",
                                                codec="int8"),
    "compressed-data": lambda v: compressed_psum_1d(v, "data"),
}}
census, values = {{}}, {{}}
for name in OPS:
    f = jax.jit(shard_map(ops[name], mesh=mesh, in_specs=spec,
                          out_specs=spec,
                          axis_names=frozenset({{"pod", "data", "model"}})))
    census[name] = hlo_analysis.collective_summary(
        f.lower(x).compile().as_text(), pod_size=pod_size(mesh))
    values[name] = np.asarray(f(x)).reshape(8, N)
mesh8 = make_mesh((8,), ("data",))
runs = {{}}
for engine in ENGINES:
    res = mr.run_jobs(_mr_jobs(mr), sky.make_catalog(1200, 7), mesh=mesh8,
                      engine=engine)
    runs[engine] = {{"outputs": [np.asarray(r.output).tolist() for r in res],
                    "n_shards": res[0].stats.n_shards,
                    "shard_padded_ratio": list(
                        res[0].stats.shard_padded_ratio)}}
np.savez(sys.argv[1], meta=json.dumps({{"census": census, "runs": runs}}),
         **values)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    code = _REFERENCE.format(tests=str(ROOT / "tests"))
    done = subprocess.run([sys.executable, "-c", code, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout + done.stderr
    with np.load(out) as z:
        meta = json.loads(str(z["meta"]))
        meta["values"] = {k: z[k] for k in OPS}
    return meta


def _port_ops(mesh):
    data = Q.axis_group("data", mesh=mesh)
    return {
        "psum-data": lambda v: Q.psum_1d(v, "data", mesh=mesh),
        "psum-pod": lambda v: Q.psum_1d(v, "pod", mesh=mesh),
        "psum-world": lambda v: C.flat_psum(v, ("pod", "data", "model"),
                                            mesh=mesh),
        "all-gather-data": lambda v: Q.all_gather(v, data)[:N],
        "reduce-scatter-data": lambda v: torch.tile(Q.reduce_scatter(
            torch.nn.functional.pad(v, (0, 1)), data), (2,))[:N],
        "all-to-all-data": lambda v: Q.all_to_all(
            torch.nn.functional.pad(v, (0, 1)).reshape(2, -1),
            data).reshape(-1)[:N],
        "flat": lambda v: C.flat_psum(v, ("pod", "data"), mesh=mesh),
        "hier": lambda v: C.hierarchical_psum_1d(v, "data", "pod",
                                                 mesh=mesh),
        "hier-int8": lambda v: C.hierarchical_psum_1d(v, "data", "pod",
                                                      codec="int8",
                                                      mesh=mesh),
        "compressed-data": lambda v: Q.compressed_psum_1d(v, "data",
                                                          mesh=mesh),
    }


def _scenarios(rank, world):
    """-> {"census": {op: summary}, "values": {op: [N]}, "runs": {engine:
    ...}} of this rank."""
    warnings.simplefilter("ignore", FutureWarning)   # torch's renamed calls
    torch.set_num_threads(1)     # the ranks share the machine's cores
    mesh = make_tiny_mesh(multi_pod=True, device_type="cpu")
    x = torch.as_tensor(_x(rank))
    census, values = {}, {}
    for name, fn in _port_ops(mesh).items():
        with op_census.census(pod_size=pod_size(mesh)) as c:
            y = fn(x)
        census[name] = op_census.collective_summary(c)
        values[name] = y.numpy()
    mesh8 = make_mesh((8,), ("data",), device_type="cpu")
    runs = {}
    for engine in ENGINES:
        res = T.run_jobs(_mr_jobs(T), sky.make_catalog(1200, 7), mesh=mesh8,
                         engine=engine, device="cpu")
        runs[engine] = {"outputs": [np.asarray(r.output).tolist()
                                    for r in res],
                        "n_shards": res[0].stats.n_shards,
                        "shard_padded_ratio": list(
                            res[0].stats.shard_padded_ratio)}
    return {"census": census, "values": values, "runs": runs}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    store = tmp_path_factory.mktemp("coll") / "store"
    return spawn_world(_scenarios, WORLD, init_file=str(store),
                       timeout_s=900)


@pytest.mark.parametrize("op", OPS)
def test_collective_census_matches_reference(world, reference, op):
    want = reference["census"][op]
    for rank, got in enumerate(world):
        assert got["census"][op] == want, (rank, op)


@pytest.mark.parametrize("op", PLAIN_OPS)
def test_collective_values_match_reference(world, reference, op):
    want = reference["values"][op]
    for rank, got in enumerate(world):
        np.testing.assert_allclose(got["values"][op], want[rank], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {rank}")


def test_hierarchical_equals_flat(world):
    for rank, got in enumerate(world):
        np.testing.assert_allclose(got["values"]["hier"],
                                   got["values"]["flat"], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {rank}")


def _data_group(rank: int) -> list:
    """The ranks of ``rank``'s data axis on the (2, 2, 2) mesh."""
    pod, model = rank // POD, rank % 2
    return [pod * POD + d * 2 + model for d in (0, 1)]


def test_compressed_psum_is_the_quantizer_rank_by_rank(world):
    """Each rank's row of every member's quantized input, summed in f32,
    quantized again and gathered: bit for bit what the ranks returned."""
    R, m = 2, -(-N // 512) * 256
    rows = {}
    for r in range(WORLD):
        xf = torch.nn.functional.pad(torch.as_tensor(_x(r)),
                                     (0, R * m - N)).reshape(R, m)
        rows[r] = Q.quantize_block(xf)[:2]
    for rank, got in enumerate(world):
        group = _data_group(rank)
        sums = []
        for i in range(R):
            q = torch.stack([rows[j][0][i] for j in group])
            s = torch.stack([rows[j][1][i] for j in group])
            chunk = Q.dequantize_block(q, s, m).sum(dim=0)
            sums.append(Q.quantize_block(chunk)[:2])
        want = Q.dequantize_block(torch.stack([q for q, _ in sums]),
                                  torch.stack([s for _, s in sums]),
                                  m).reshape(-1)[:N]
        np.testing.assert_array_equal(
            got["values"]["compressed-data"].view(np.int32),
            want.numpy().view(np.int32), err_msg=f"rank {rank}")


@pytest.mark.parametrize("op,flat", [("compressed-data", "psum-data"),
                                     ("hier-int8", "flat")])
def test_compressed_within_md_check_bound(world, reference, op, flat):
    for rank, got in enumerate(world):
        scale = np.abs(got["values"][flat]).max()
        for want in (got["values"][flat], reference["values"][op][rank]):
            err = np.abs(got["values"][op] - want).max()
            assert err <= 0.03 * scale, (rank, err, scale)


@pytest.mark.parametrize("engine", ENGINES)
def test_shard_accounting_matches_reference_at_8(world, reference, engine):
    want = reference["runs"][engine]
    for rank, got in enumerate(world):
        assert got["runs"][engine] == want, rank
    assert want["n_shards"] == 8 and len(want["shard_padded_ratio"]) == 8


@pytest.mark.parametrize("n,dtype", [(1000, "float32"), (4096, "float32"),
                                     (777, "bfloat16")])
def test_ef_compress_matches_reference(n, dtype):
    """In process: the same (g, err) through both packages' error-feedback
    step, bit for bit; for f32 ``g``, ``sent + new_err == g + err`` (bf16
    rounds ``sent`` on its way out, in both packages)."""
    rng = np.random.default_rng(n)
    g32 = rng.normal(size=n).astype(np.float32)
    err = (rng.normal(size=n) * 1e-2).astype(np.float32)
    g = torch.as_tensor(g32).to(getattr(torch, dtype))
    sent, new_err = Q.ef_compress(g, torch.as_tensor(err))
    jsent, jerr = jcomp.ef_compress(jnp.asarray(g.float().numpy()).astype(
        getattr(jnp, dtype)), jnp.asarray(err))
    np.testing.assert_array_equal(sent.float().numpy(),
                                  np.asarray(jsent, np.float32))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))
    if dtype == "float32":
        np.testing.assert_allclose(sent.numpy() + new_err.numpy(),
                                   g32 + err, rtol=0, atol=1e-6)
        s0, e0 = Q.ef_compress(g, None)
        np.testing.assert_allclose((s0 + e0).numpy(), g32, rtol=0,
                                   atol=1e-6)
