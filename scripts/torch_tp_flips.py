"""Where a tensor-parallel train step parts from one rank's after the
first update, on the card.

    python3 scripts/torch_tp_flips.py [arch ...]

For each arch (default mamba2-1.3b and tinyllama-1.1b) at
``chip_smoke.py``'s ``train_tp`` size (``tp_train_cfg``, f32, the same
batch, AdamW at lr 3e-4 after one warm-up step at lr 0), three steps on
(1, 4) gloo ranks sharing the card against one rank's three steps, and
one rank's on the batch rows reversed (the same loss summed in another
order). Prints, one JSON line an arch: the loss's and grad norm's
relative gap by step, and each parameter leaf's gap after the second
step (the first update) in units of lr, with the elements that moved
more than lr/2 apart: AdamW's first step is near lr sign(g), so an
element whose gradient is rounding noise moves up to 2 lr from one
rank's. The card's name and power limit come first. Needs a CUDA device;
imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

LR = 3e-4


def steps(cfg, seed: int, mesh=None, reverse: bool = False) -> tuple:
    """``chip_smoke.MESH_TRAIN_STEPS`` steps of ``cfg`` on ``mesh`` (one
    rank where None) -> (the metrics, the parameter leaves after the
    second step, whole, on the host)."""
    from repro_torch.configs import RunConfig
    from repro_torch.training import init_state, make_train_step
    from repro_torch.training.state import checkpoint_leaves
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (cs.MESH_TRAIN_BATCH, cs.MESH_TRAIN_SEQ))
    batch = {"tokens": torch.as_tensor(toks[::-1].copy() if reverse
                                       else toks, device="cuda")}
    rc = RunConfig(warmup_steps=1, steps=4, learning_rate=LR)
    state = init_state(cfg, rc, seed, mesh, device="cuda",
                       dtype=torch.float32)
    fn = make_train_step(cfg, rc, mesh)
    mets, leaves = [], None
    for i in range(cs.MESH_TRAIN_STEPS):
        state, m = fn(state, batch)
        mets.append({k: v.item() for k, v in m.items()})
        if i == 1:
            leaves = {k: lf.get().detach().cpu().numpy().copy()
                      for k, lf in checkpoint_leaves(state).items()
                      if k.startswith("params/")}
    del state, fn
    torch.cuda.empty_cache()
    return mets, leaves


def rel_by_step(got: list, want: list) -> list:
    return [max(abs(g[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm"))
            for g, w in zip(got, want)]


def compared(tp, one, rev) -> dict:
    """The TP run's and the reversed run's records against one rank's."""
    leaves = []
    for k, w in one[1].items():
        d = np.abs(tp[1][k].astype(np.float64) - w)
        leaves.append({"leaf": k, "elements": int(d.size),
                       "max_diff_over_lr": float(d.max()) / LR,
                       "apart_over_half_lr": int((d > LR / 2).sum())})
    leaves.sort(key=lambda x: -x["max_diff_over_lr"])
    return {"rel_by_step": rel_by_step(tp[0], one[0]),
            "reversed_rel_by_step": rel_by_step(rev[0], one[0]),
            "elements": sum(x["elements"] for x in leaves),
            "apart_over_half_lr": sum(x["apart_over_half_lr"]
                                      for x in leaves),
            "top_leaves": leaves[:8]}


def rank_fn(rank: int, world: int, seed: int, archs: list) -> dict:
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, world), ("data", "model"))
    out = {}
    for arch in archs:
        cfg = cs.tp_train_cfg(arch)
        tp = steps(cfg, seed, mesh)
        if rank == 0:
            out[arch] = compared(tp, steps(cfg, seed),
                                 steps(cfg, seed, reverse=True))
    return out


def main(argv=None) -> int:
    archs = (sys.argv[1:] if argv is None else argv) or [cs.MAMBA,
                                                          cs.TRAIN_ARCH]
    if not torch.cuda.is_available():
        print("torch_tp_flips: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.mesh import spawn_world
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    _build.build(fk.LIBRARY)
    fk.LIBRARY.load()
    with tempfile.TemporaryDirectory(prefix="tp-flips-") as tmp:
        ranks = spawn_world(rank_fn, cs.MESH_WORLD, 0, archs,
                            init_file=str(Path(tmp) / "store"),
                            timeout_s=900)
    for arch, rec in ranks[0].items():
        print(json.dumps({"arch": arch, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
