"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) from the
sources in the checkout into ``build/kernels/`` at the root of the repo,
under a name that carries a digest of the sources and flags: an unchanged
source is built once, an edited one is built anew.  The sources expose a
plain C interface (no PyTorch headers), which keeps a build to seconds.

Nothing here runs at import time: the first launch on a CUDA tensor
builds, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_logs", "build_seconds",
           "load_library", "nvcc_path"]

#: repo root / build / kernels (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",          # registers, shared memory and spills per kernel
    "-shared",
    "-Xcompiler", "-fPIC",
)

#: name -> compiler output of the build made in this process
build_logs: dict[str, str] = {}
#: name -> seconds that build took
build_seconds: dict[str, float] = {}

_libs: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}   # one per library: builds of
_locks_guard = threading.Lock()          # two libraries run in parallel


def nvcc_path() -> str:
    """``nvcc`` on PATH, else the one of the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load_library(name: str, sources: Sequence[Path],
                 signatures: dict[str, list],
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (once per source digest) and load ``lib<name>``.

    ``signatures`` maps each exported C function to its ctypes argument
    types; every function returns an ``int`` CUDA error code.  ``flags``
    are the library's own, added to :data:`NVCC_FLAGS`.  Libraries of
    different names build in parallel when called from threads."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        h = hashlib.sha256(" ".join((*NVCC_FLAGS, *flags)).encode())
        for src in sources:
            h.update(Path(src).read_bytes())
        so = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
                   *(str(s) for s in sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name} ({proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            build_logs[name] = proc.stdout + proc.stderr
            build_seconds[name] = time.perf_counter() - t0
            os.replace(tmp, so)   # atomic: a concurrent builder sees all or nothing
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
        return lib
