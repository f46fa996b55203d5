"""The port's expert-parallel phases alone: ``chip_smoke.py``'s ``moe_ep``,
``train_ep`` and ``train_ep_cards``.

    python3 scripts/torch_ep_phases.py [moe_ep] [train_ep] [train_ep_cards]

Builds the flash-attention library (the training phases launch it), then
runs the named phases (by default ``moe_ep`` and ``train_ep``, which runs
``train_ep_cards`` after itself) and prints their phase lines and their
seconds. ``train_ep_cards`` needs a machine of 4 cards; on fewer it
prints one line saying why it did not run.
Needs a CUDA device; imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402


def main(argv=None) -> int:
    only = (sys.argv[1:] if argv is None else argv) or ["moe_ep",
                                                        "train_ep"]
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    _build.build(fk.LIBRARY)
    fk.LIBRARY.load()
    launches = dict.fromkeys(LAUNCHES, 0)
    if "moe_ep" in only:
        t0 = time.perf_counter()
        cs.moe_ep(0)
        print("moe_ep_s", time.perf_counter() - t0, flush=True)
    if "train_ep" in only:
        t0 = time.perf_counter()
        cs.train_ep(0, launches)
        print("train_ep_s", time.perf_counter() - t0, launches, flush=True)
    if "train_ep_cards" in only:
        t0 = time.perf_counter()
        cs.train_ep_cards(0)
        print("train_ep_cards_s", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
