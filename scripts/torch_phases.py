"""Named phases of ``chip_smoke.py`` alone, on the card.

    python3 scripts/torch_phases.py <phase> [<phase> ...]

e.g. ``moe_ep train_ep train_tp serve_tp`` (``train_ep`` runs
``train_ep_cards`` after itself and ``serve_tp`` ``serve_tp_cards``; each
of those two alone needs a machine of 4 cards and on fewer prints one
line saying why it did not run). Builds the flash-attention and quantize
libraries (the training and serving phases launch both), then calls
``chip_smoke.<phase>`` for each name in order, with the seed 0 and, where
the phase counts launches, one launch table they share, and prints each
phase's lines, its seconds and the launches it counted. Needs a CUDA
device; imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import inspect
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.quantize import kernel as qk  # noqa: E402


def main(argv=None) -> int:
    names = sys.argv[1:] if argv is None else argv
    if not names:
        print(__doc__, file=sys.stderr)
        return 2
    phases = [getattr(cs, n) for n in names]
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    _build.build(fk.LIBRARY, qk.LIBRARY)
    fk.LIBRARY.load()
    qk.LIBRARY.load()
    launches = dict.fromkeys(LAUNCHES, 0)
    for name, phase in zip(names, phases):
        t0 = time.perf_counter()
        if "launches" in inspect.signature(phase).parameters:
            phase(0, launches)
        else:
            phase(0)
        print(f"{name}_s", time.perf_counter() - t0, launches, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
