"""Build and bind the hand-written CUDA pair kernels (``csrc/zones_pairs.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``, at first use. The library
lands in ``build/repro_torch/`` at the repository root (or under
``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of the sources and flags, so a
fresh checkout builds once and an edited source rebuilds. Nothing here runs
at import: the CPU tests import this module on a machine without ``nvcc``.

Each wrapper checks device, dtype, contiguity and shapes, allocates its
output with ``torch.zeros``, launches on ``torch.cuda.current_stream()``,
raises if the C function reports a CUDA error, and adds one to its launch
count (``LAUNCHES``) where it launches. A tier with no cell launches nothing
and counts nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "zones_pairs.cu",)
# -fmad=false: no FMA contraction anywhere (the __*_rn intrinsics already pin
# the score arithmetic; this keeps any other float expression exact too).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
MAX_EDGES = 4096                # dynamic shared memory: 8 bytes per edge

LAUNCHES = {"pair_count_masked": 0, "pair_hist_masked": 0}
BUILD_INFO: dict = {}           # path, seconds, ptxas log of the last build

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    pkg = Path(__file__).resolve().parents[2]            # src/repro_torch
    root = pkg.parent.parent if pkg.parent.name == "src" else Path.cwd()
    return root / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the zones pair "
                           "kernels are built from source at first use")
    return found


def build() -> Path:
    """Compile the kernels (if this source/flag hash is not built yet) and
    return the shared library's path."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = _build_dir()
    out = out_dir / f"zones_pairs-{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                           *map(str, SOURCES)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent builder sees all or none
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.zp_count_masked.argtypes = [p, p, p, p, i, i, i,
                                            ctypes.c_float, p, p]
            lib.zp_count_masked.restype = i
            lib.zp_hist_masked.argtypes = [p, p, p, p, i, i, i, p, i, p, p]
            lib.zp_hist_masked.restype = i
            _lib = lib
    return _lib


def _check_inputs(a, b, n_a, n_b):
    for name, t, dt in (("a", a, torch.float32), ("b", b, torch.float32),
                        ("n_a", n_a, torch.int32), ("n_b", n_b, torch.int32)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device or n_a.device != a.device or n_b.device != a.device:
        raise ValueError("a, b, n_a and n_b must be on one device")
    if a.dim() != 3 or b.dim() != 3 or a.shape[2] != 3 or b.shape[2] != 3:
        raise ValueError(f"expected a [P,C1,3] and b [P,C2,3], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    P = a.shape[0]
    if b.shape[0] != P or tuple(n_a.shape) != (P,) or tuple(n_b.shape) != (P,):
        raise ValueError(f"partition counts disagree: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, n_a {tuple(n_a.shape)}, "
                         f"n_b {tuple(n_b.shape)}")
    return P, a.shape[1], b.shape[1]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def pair_count_masked_cuda(a, b, n_a, n_b, cos_min) -> torch.Tensor:
    """Masked pair count over a tier -> int64 0-d tensor on the device."""
    P, C1, C2 = _check_inputs(a, b, n_a, n_b)
    out = torch.zeros(1, dtype=torch.int64, device=a.device)
    if P * C1 * C2 == 0:          # no cell, no launch
        return out[0]
    lib = _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.zp_count_masked(a.data_ptr(), b.data_ptr(), n_a.data_ptr(),
                                  n_b.data_ptr(), P, C1, C2,
                                  float(np.float32(float(cos_min))),
                                  out.data_ptr(), stream)
    _raise_on(err, "zp_count_masked")
    LAUNCHES["pair_count_masked"] += 1
    return out[0]


def pair_hist_masked_cuda(a, b, n_a, n_b, cos_edges) -> torch.Tensor:
    """Masked cumulative per-edge counts over a tier -> int64 [NB] on the
    device, in the order of ``cos_edges`` (any order)."""
    P, C1, C2 = _check_inputs(a, b, n_a, n_b)
    edges = torch.as_tensor(cos_edges, dtype=torch.float32,
                            device=a.device).reshape(-1)
    nb = edges.shape[0]
    if not 0 < nb <= MAX_EDGES:
        raise ValueError(f"need 1..{MAX_EDGES} edges, got {nb}")
    desc, order = torch.sort(edges, descending=True)
    desc = desc.contiguous()
    if P * C1 * C2 == 0:          # no cell, no launch
        return torch.zeros(nb, dtype=torch.int64, device=a.device)
    hist = torch.zeros(nb + 1, dtype=torch.int64, device=a.device)
    lib = _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.zp_hist_masked(a.data_ptr(), b.data_ptr(), n_a.data_ptr(),
                                 n_b.data_ptr(), P, C1, C2, desc.data_ptr(),
                                 nb, hist.data_ptr(), stream)
    _raise_on(err, "zp_hist_masked")
    LAUNCHES["pair_hist_masked"] += 1
    # hist[c] counts the cells that pass exactly c edges. With the edges
    # descending those are the c loosest, so edge k counts the cells with
    # c >= nb - k.
    suffix = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    cum_desc = suffix[nb - torch.arange(nb, device=a.device)]
    out = torch.empty_like(cum_desc)
    out[order] = cum_desc
    return out
