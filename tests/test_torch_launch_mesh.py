"""The command-line entry points' mesh path (``--mesh``), on gloo ranks.

``launch/serve.py`` and ``launch/train.py`` with ``--mesh`` spawn a world
of data x model ranks through ``launch/mesh.py::run_on_mesh``, on the
backend that ``mesh_backend`` picks: gloo on the CPU and wherever the ranks
outnumber the cards, NCCL on one card a rank. Here, at the reduced
TinyLlama with ``--device cpu``:

- the serve CLI on a mesh gives one rank's tokens and step count;
- the train CLI on (2, 2), crashed by ``--inject-failure-at`` and restarted
  from its checkpoint, gives the uninterrupted run's losses on the steps
  both take, and the uninterrupted run starts at one rank's loss (to
  bf16's rounding) and falls;
- ``mesh_backend`` picks the backend without spawning.

The same calls on four H100s over NCCL are ``chip_smoke.py``'s
``cli_cards``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import mesh_backend  # noqa: E402

SERVE = ["--reduced", "--device", "cpu", "--requests", "4", "--slots", "2",
         "--max-new", "4", "--max-len", "32"]
TRAIN = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4",
         "--seq", "16", "--ckpt-every", "2"]
FAIL_AT = 2         # the crash's step: the restart resumes from step 2
# The CLI trains in the config's bf16: a model axis's partial sums are
# rounded to bf16 before the ranks add them, so a (2, 2) loss is one rank's
# to bf16's unit roundoff, not to f32's (the data axis alone: within 1e-6)
BF16_REL = 2.0 ** -8


@pytest.fixture(scope="module")
def one_rank_serve():
    _, reqs, steps, _ = serve.main(SERVE)
    return [r.out for r in reqs], steps


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_serve_cli_on_mesh_gives_one_ranks_tokens(mesh, one_rank_serve):
    backend, reqs, steps, _ = serve.main(SERVE + ["--mesh", mesh])
    assert backend == "gloo"
    assert all(r.done for r in reqs)
    assert ([r.out for r in reqs], steps) == one_rank_serve


def test_train_cli_on_mesh_restarts_to_the_uninterrupted_losses(tmp_path):
    mesh = ["--mesh", "2x2"]
    backend, restarted, _ = train.main(
        TRAIN + mesh + ["--ckpt", str(tmp_path / "crashed"),
                        "--inject-failure-at", str(FAIL_AT)])
    _, whole, _ = train.main(TRAIN + mesh + ["--ckpt",
                                             str(tmp_path / "whole")])
    _, one = train.main(TRAIN)
    assert backend == "gloo"
    assert len(restarted) == len(whole) == 4
    # the restart runs steps 2-5, the uninterrupted run steps 0-3
    np.testing.assert_allclose(restarted[:2], whole[FAIL_AT:], rtol=0,
                               atol=1e-4)
    assert abs(whole[0] - one[0]) <= BF16_REL * abs(one[0])
    assert whole[-1] < whole[0]


@pytest.mark.parametrize("device, ranks, cards, want", [
    ("cpu", 4, 4, "gloo"),          # CPU ranks
    ("cuda", 4, 2, "gloo"),         # ranks that outnumber the cards
    ("cuda", 4, 4, "nccl"),         # one card a rank
    ("cuda", 2, 4, "nccl"),
])
def test_mesh_backend(device, ranks, cards, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh_backend(device, ranks) == want
