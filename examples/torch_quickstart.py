"""Quickstart on the PyTorch port: train a tiny llama-family model for 30
steps, then generate from it (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless ``--device cpu``. The trained state's ``params``
is the LM itself, which the serving engine takes as it is. ``main``
returns the losses and the generated tokens.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import RunConfig, get_arch  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch("tinyllama-1.1b").reduced()
    rc = RunConfig(remat="none", steps=args.steps, warmup_steps=3,
                   learning_rate=1e-3)
    print(f"== training {cfg.name} (reduced) for {args.steps} steps ==")
    state, losses = train(cfg, rc, batch=8, seq=64, steps=args.steps,
                          log_every=10, device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")

    print("== generating with the serving engine ==")
    eng = ServeEngine(cfg, rc, state["params"], slots=2, max_len=64,
                      device=args.device)
    reqs = [Request(rid=0, prompt=[1, 2, 3, 4], max_new=12),
            Request(rid=1, prompt=[5, 6, 7], max_new=12)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=40)
    print("generation finished; engine processed both requests.")
    return {"losses": losses, "outputs": [r.out for r in reqs]}


if __name__ == "__main__":
    main()
