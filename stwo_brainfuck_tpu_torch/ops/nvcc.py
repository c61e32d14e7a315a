"""Build and load the port's CUDA kernels: each ``csrc/<stem>.cu`` is compiled
by nvcc into a shared library with a plain C interface and bound with ctypes
(no PyTorch headers, so a build takes seconds).

A library is built at first use into the package's ``build/`` directory
(git-ignored), named by a hash of its source, every ``csrc/*.cuh`` header
and the flags: a changed source is rebuilt, an unchanged one is loaded.
``build_all`` starts one nvcc per library at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


class CudaLibrary:
    """One kernel source, its built library and its ctypes binding."""

    def __init__(self, stem: str, bind: Callable[[ctypes.CDLL], None]):
        self.stem = stem
        self.source = CSRC / f"{stem}.cu"
        self._bind = bind
        self._lib = None
        self.build_seconds = None
        self.build_log = ""

    def path(self) -> Path:
        h = hashlib.sha256()
        for f in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(f.name.encode() + b"\0" + f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.stem}-{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            build_all([self])
        return self._lib


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Build (one nvcc process per library, all started together) and load
    every library not loaded yet. Raises if any build fails; no nvcc process
    outlives the call."""
    t0 = time.perf_counter()
    jobs = []
    try:
        for lib in libs:
            if lib._lib is not None:
                continue
            path = lib.path()
            if path.exists():
                jobs.append((lib, path, None, None))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(lib.source)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((lib, path, proc, tmp))
        for lib, path, proc, tmp in jobs:
            if proc is not None:
                lib.build_log = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {lib.source.name} "
                                       f"({proc.returncode}):\n{lib.build_log}")
                os.replace(tmp, path)
            cdll = ctypes.CDLL(str(path))
            lib._bind(cdll)
            lib._lib = cdll
            lib.build_seconds = time.perf_counter() - t0
    finally:
        for _, _, proc, _ in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
