"""``examples/torch_neighbor_search.py``, the paper's workload from the
command line on the port, run on the CPU: its radius sweep against the JAX
package's ``run_job`` on the same catalog (the device engine through the
plain refs of its Pallas kernels, called eagerly, as
``test_torch_mapreduce.py`` runs it) and against ``sky.brute_force_pairs``;
every other section's count against the sweep or the JAX package; and
``--n 0``, which must run clean, as the reference example does.
``examples/torch_serve_lm.py``, the counterpart of ``examples/serve_lm.py``,
serves every architecture's reduced config on the CPU, and
``examples/torch_train_lm.py``, the counterpart of ``examples/train_lm.py``,
trains its 100M-parameter model a few steps there;
``examples/torch_quickstart.py`` trains the reduced TinyLlama and serves
the result."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.mapreduce as R  # noqa: E402
from repro.data import sky as jsky  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from test_torch_mapreduce import _jobs  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
N = 3000


def _example(name="torch_neighbor_search"):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def counts():
    return _example().main(["--n", str(N), "--device", "cpu"])


def _jax_count(xyz, radius, codec, tile, zones=None):
    """The JAX package's search count at ``radius`` over
    ``ZonePartitioner(zones or radius)``."""
    radii = (radius,) if zones is None else (radius, zones)
    job = _jobs(radii, (1.0,), codec, tile, jax_side=True)[0]
    return R.run_jobs([job], xyz, engine="device")[0].output


def test_radius_sweep_equals_jax_and_brute_force(counts):
    xyz = jsky.make_catalog(N, seed=0)
    sweep = counts["radius_sweep"]
    assert [r for r, _ in sweep] == pytest.approx([0.01, 0.02, 0.04])
    for radius, pairs in sweep:
        assert pairs == _jax_count(xyz, radius, "identity", 256), radius
        assert pairs == jsky.brute_force_pairs(xyz, radius), radius
    assert sweep[0][1] < sweep[1][1] < sweep[2][1]


def test_sections_agree(counts):
    """The exact codec's runs give the sweep's count at the radius; the
    int16 runs (the stage swap, streamed, speculated and served) give the
    JAX package's int16 count; the batched histogram sums to its search."""
    xyz = jsky.make_catalog(N, seed=0)
    at_r = counts["radius_sweep"][1][1]
    swaps = counts["stage_swaps"]
    assert swaps["baseline"] == swaps["batched (buffering analogue)"] == at_r
    assert counts["batched"]["pairs"] == at_r
    assert int(np.sum(counts["batched"]["histogram"])) == at_r
    int16 = _jax_count(xyz, 0.02, "int16", 512)
    assert swaps["int16 shuffle (LZO analogue)"] == int16
    assert counts["streamed"] == int16
    spec = counts["speculation"]
    assert spec["clean"] == spec["straggler"] == int16
    # the service's catalog is zoned at the radius, its r/2 query too
    assert counts["service"] == [int16, _jax_count(xyz, 0.01, "int16", 256,
                                                   zones=0.02)] * 4


def test_empty_catalog_runs_clean():
    got = _example().main(["--n", "0", "--device", "cpu"])
    assert [p for _, p in got["radius_sweep"]] == [0, 0, 0]
    assert set(got["stage_swaps"].values()) == {0}
    assert got["streamed"] == 0 and got["service"] == [0] * 8
    assert got["batched"] == {"pairs": 0, "histogram": [0] * 8}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_example_serves_every_architecture(arch, capsys):
    """6 requests through 4 slots (two re-seated): every one finishes with
    its 5 tokens, each in the padded vocabulary, and the last line printed
    is the run's JSON figures."""
    import json
    argv = ["--arch", arch, "--device", "cpu", "--requests", "6",
            "--max-new", "5"]
    got = _example("torch_serve_lm").main(argv)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {k: got[k] for k in last}
    assert got["finished"] == 6 and got["tokens"] == 30
    assert all(len(o) == 5 and all(0 <= t < ARCHS[arch].vocab_padded
                                   for t in o) for o in got["outputs"])


def test_train_example_trains_and_checkpoints(tmp_path, capsys):
    """4 steps of the 100M-parameter model on the CPU: finite losses, the
    step counter, a checkpoint at the end, the JSON figures last."""
    import json
    got = _example("torch_train_lm").main(
        ["--steps", "4", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt", str(tmp_path)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {k: got[k] for k in last}
    assert got["step"] == 4 and len(got["losses"]) == 4
    assert all(np.isfinite(got["losses"]))
    assert (tmp_path / "step_00000004" / "manifest.json").exists()


def test_quickstart_trains_then_generates():
    """10 steps of the reduced TinyLlama lower the loss; the trained LM
    then serves both requests their 12 tokens."""
    got = _example("torch_quickstart").main(["--steps", "10", "--device",
                                             "cpu"])
    assert len(got["losses"]) == 10 and got["losses"][-1] < got["losses"][0]
    assert [len(o) for o in got["outputs"]] == [12, 12]
