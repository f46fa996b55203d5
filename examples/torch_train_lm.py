"""Train a ~100M-parameter LM for a few hundred steps on the PyTorch port:
the counterpart of ``examples/train_lm.py``.

Uses the whole training path: the synthetic-token pipeline, the bucketed
AdamW step, checkpointing with replication and checksums, the straggler
monitor. Runs on the card unless ``--device cpu`` (where a step takes
seconds: try ``--steps 20``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
        [--batch 8] [--seq 256] [--ckpt DIR] [--device cpu]

Without ``--ckpt`` the checkpoints go to a temporary directory, removed at
the end. The last line printed is a JSON object of the run's figures
(``main`` returns it, with every step's loss).
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.model import count_params_total  # noqa: E402


def lm_100m():
    """~100M-param llama-family config (a real small LM, not a smoke
    stub)."""
    base = get_arch("tinyllama-1.1b")
    return dataclasses.replace(
        base, name="lm-100m", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=5, head_dim=64, d_ff=1792, vocab=32000)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = lm_100m()
    print(f"== {cfg.name}: {count_params_total(cfg)/1e6:.1f}M params ==")
    rc = RunConfig(arch=cfg.name, steps=args.steps,
                   warmup_steps=max(args.steps // 20, 1),
                   learning_rate=3e-4, remat="none", bucketed_updates=True)
    with tempfile.TemporaryDirectory(prefix="torch-train-lm-") as tmp:
        t0 = time.perf_counter()
        state, losses = train(cfg, rc, batch=args.batch, seq=args.seq,
                              steps=args.steps,
                              ckpt_dir=args.ckpt or tmp,
                              ckpt_every=max(args.steps // 4, 10),
                              log_every=10, device=args.device)
        wall = time.perf_counter() - t0
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    out = {"model": cfg.name, "device": args.device, "steps": args.steps,
           "step": int(state["step"]), "first_loss": losses[0],
           "final_loss": losses[-1], "wall_s": wall}
    print(json.dumps(out), flush=True)
    return {**out, "losses": losses}


if __name__ == "__main__":
    main()
