"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Each kernel family is a ``Library``: CUDA C++ sources under its ``csrc/``
with a plain C interface, compiled with ``nvcc`` for ``sm_90a`` into a
shared library at first use. Libraries land in ``build/repro_torch/`` at the
repository root (or under ``$REPRO_TORCH_BUILD_DIR``), named by a hash of
the sources and flags, so a fresh checkout builds once and an edited source
or flag rebuilds. Every library compiles with ``NVCC_FLAGS`` and then its
own ``flags``. ``build(*libraries)`` starts one ``nvcc`` per library that is not
built yet, all at once, and waits for them together. Nothing here runs at
import: the CPU tests import every module on a machine without ``nvcc``.
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

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# For a library whose results are held bitwise or exactly: no FMA
# contraction anywhere (the __*_rn intrinsics already pin the arithmetic that
# parity needs; this keeps any other float expression exact too).
NO_FMA = ("-fmad=false",)


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    pkg = Path(__file__).resolve().parents[1]            # src/repro_torch
    root = pkg.parent.parent if pkg.parent.name == "src" else Path.cwd()
    return root / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


class Library:
    """One shared library built from ``sources`` with ``NVCC_FLAGS`` and
    then ``flags``. ``declare(lib)`` sets the ``argtypes``/``restype`` of
    every exported C function."""

    def __init__(self, name: str, sources, declare, flags=()):
        self.name = name
        self.sources = tuple(Path(s) for s in sources)
        self.flags = tuple(flags)
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()
        self.info: dict = {}      # path, seconds, ptxas log of the build

    def path(self) -> Path:
        h = hashlib.sha256()
        for src in self.sources:
            h.update(src.read_bytes())
        h.update(" ".join(self.nvcc_flags()).encode())
        return _build_dir() / f"{self.name}-{h.hexdigest()[:16]}.so"

    def nvcc_flags(self) -> tuple:
        return NVCC_FLAGS + self.flags

    def load(self) -> ctypes.CDLL:
        """Build if needed, then load and declare (once per process)."""
        with self._lock:
            if self._lib is None:
                if self.info.get("path") != str(self.path()):
                    build(self)       # keeps an earlier build()'s log
                lib = ctypes.CDLL(str(self.info["path"]))
                self._declare(lib)
                self._lib = lib
        return self._lib


def build(*libraries: Library) -> list[Path]:
    """Compile every library whose source/flag hash is not built yet, one
    ``nvcc`` each, started together. -> the shared libraries' paths."""
    started = []
    for lib in libraries:
        out = lib.path()
        if out.exists():
            log = out.with_suffix(".log")
            lib.info.update(path=str(out), seconds=0.0, log=log.read_text()
                            if log.exists() else "(cached)")
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *lib.nvcc_flags(), "-o", tmp,
                                 *map(str, lib.sources)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((lib, out, tmp, proc, time.perf_counter()))
    failed = []
    for lib, out, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):\n"
                          f"{log}")
            continue
        out.with_suffix(".log").write_text(log)   # ptxas's report, kept
        os.replace(tmp, out)      # atomic: a concurrent build sees all or none
        lib.info.update(path=str(out), seconds=time.perf_counter() - t0,
                        log=log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [Path(lib.info["path"]) for lib in libraries]


def raise_on(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error (0 = launched)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
