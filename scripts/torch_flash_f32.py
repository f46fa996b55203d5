"""The f32 flash-attention kernel against another checkout's on the card:
each f32 instance that the port's paths launch, held and timed by
``chip_smoke.flash_timing`` (against ``attention_ref`` within
``FLASH_TOL``, beside the plain version, SDPA and the bound), then both
kernels timed on the same inputs in the order other, this, this, other,
with the SM clock and power read while 200 launches of this tree's run.

    python3 scripts/torch_flash_f32.py DIR

``DIR`` is the other checkout (say the parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists); its flash
library is built from its own source, and ``ptxas``'s registers, shared
memory and spills of its ``flash_fwd_kernel`` instances are printed. One
JSON line per instance. Needs a CUDA device; imports nothing of ``jax`` or
``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

# (B, S, H, Kv, dh, window, softcap, scale) of the f32 launches: the first
# attention layer's prefill of chip_smoke's gemma2-2b (1 x 4,608, its local
# and its global layers) and recurrentgemma-2b (2 x 2,560) phases;
# TinyLlama's layer 0 at phase 24's 8 x 2,048, the instance the f32 mesh
# phases run; internvl2-2b's serve_tp prefill on (1, 2), a rank's 8/4
# heads over 2 x 1,024. No path runs f32 at head dims 16 and 32: those two
# take TinyLlama's heads and prompt.
INSTANCES = {
    "gemma2-2b": (1, 4608, 8, 4, 256, 4096, 50.0, 1 / 16),
    "gemma2-2b global": (1, 4608, 8, 4, 256, 0, 50.0, 1 / 16),
    "recurrentgemma-2b": (2, 2560, 10, 1, 256, 2048, 0.0, None),
    "tinyllama-1.1b f32": (8, 2048, 32, 4, 64, 0, 0.0, None),
    "internvl2-2b serve_tp f32": (2, 1024, 8, 4, 128, 0, 0.0, None),
    "dh 32": (8, 2048, 32, 4, 32, 0, 0.0, None),
    "dh 16": (8, 2048, 32, 4, 16, 0, 0.0, None),
}


def inputs(B, S, H, Kv, dh, seed=0):
    """q, k, v on the card: f32 draws of N(0, 1) from ``seed``."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((B, S, n, dh),
                                                     dtype=np.float32)).cuda()
                 for n in (H, Kv, Kv))


def _declare_f32(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_forward_f32.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, f, p]
    lib.fa_forward_f32.restype = i


def run_f32(lib, q, k, v, causal, window, softcap, scale):
    """One launch of ``lib``'s f32 kernel (``flash_attention_cuda``'s
    call, without its launch count) -> the output."""
    B, S, H, dh = q.shape
    out = torch.empty_like(q)
    err = lib.fa_forward_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B, S, H, k.shape[2], dh, scale,
                             int(causal), int(window), float(softcap),
                             torch.cuda.current_stream().cuda_stream)
    _build.raise_on(err, "fa_forward_f32")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the checkout to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_f32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    other = _build.Library(
        "flash_attention_other",
        (args.other / "src/repro_torch/kernels/flash_attention/csrc"
         / "flash_attention.cu",), _declare_f32)
    _build.build(fk.LIBRARY, other)
    for k in cs.ptxas_summary(other.info["log"]):
        if re.fullmatch(r"flash_fwd_kernel<\d+>", k["kernel"]):
            print(json.dumps({"library": other.name, "ptxas": k}),
                  flush=True)
    lib, old_lib = fk.LIBRARY.load(), other.load()

    for name, (B, S, H, Kv, dh, window, cap, scale) in INSTANCES.items():
        q, k, v = inputs(B, S, H, Kv, dh)
        kw = dict(causal=True, window=window, softcap=cap,
                  scale=scale or 1.0 / math.sqrt(dh))
        row = {"instance": name, "shape": [B, S, H, Kv, dh],
               "window": window, "softcap": cap,
               **cs.flash_timing(q, k, v, **kw)}
        mine = lambda: run_f32(lib, q, k, v, **kw)          # noqa: E731
        old = lambda: run_f32(old_lib, q, k, v, **kw)       # noqa: E731
        row["other_vs_this_max_abs"] = (old() - mine()).abs().max().item()
        times = [cs.cuda_ms(f) for f in (old, mine, mine, old)]
        row.update(other_ms=[times[0], times[3]], this_ms=times[1:3])
        for _ in range(200):              # launches queued while it reads
            mine()
        row["under_load"] = cs.nvidia_smi("clocks.sm,clocks.max.sm,"
                                          "power.draw")
        torch.cuda.synchronize()
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
