"""ctypes bindings for the repo's native C++ Brainfuck interpreter
(csrc/bf_vm.cpp), built for this package.

Counterpart of ``stwo_brainfuck_tpu/vm/native.py``. The library is built
with g++ at first use into the package's own git-ignored ``build/``
directory, named by the source's content hash; no host-specific flags
(-march=native) are used, so the library runs on any x86-64 host. When no
compiler is found, ``available()`` is False and vm/machine.py runs its
Python interpreter; ``Machine.vm`` records which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "bf_vm.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

BF_OK = 0
BF_ERR_INPUT_EOF = 1
BF_ERR_TRACE_OVERFLOW = 2
BF_ERR_BAD_INSTRUCTION = 3
BF_ERR_MP_RANGE = 4
BF_ERR_OUTPUT_OVERFLOW = 5

_ERROR_MESSAGES = {
    BF_ERR_INPUT_EOF: "I/O operation failed: unexpected EOF on input",
    BF_ERR_TRACE_OVERFLOW: "program exceeded the maximum step count",
    BF_ERR_BAD_INSTRUCTION: "Invalid instruction",
    BF_ERR_MP_RANGE: "memory pointer out of range",
    BF_ERR_OUTPUT_OVERFLOW: "output overflow",
}

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> Optional[Path]:
    """Compile the interpreter; None when there is no source or compiler."""
    if not _SOURCE.exists() or shutil.which("g++") is None:
        return None
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libbf_vm-{digest}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SOURCE)],
        capture_output=True, timeout=120)
    if proc.returncode != 0:
        return None
    os.replace(tmp, lib_path)
    return lib_path


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = _build()
    if path is None:
        _load_failed = True
        return None
    lib = ctypes.CDLL(str(path))
    lib.bf_execute.restype = ctypes.c_int
    lib.bf_execute.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,          # code
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,           # input
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,           # output
        ctypes.POINTER(ctypes.c_int64),                           # output_len
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,          # ram
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,          # trace
        ctypes.POINTER(ctypes.c_int64),                           # trace_len
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def execute(
    code: List[int], input_bytes: bytes, ram_size: int,
    output_cap: int = 1 << 24, max_steps: int = 1 << 26,
) -> Tuple[np.ndarray, bytes, np.ndarray]:
    """Run natively. Two passes: count steps (no trace), then record into an
    exactly-sized buffer. Returns (trace (n,7) uint32, output, ram).
    Raises RuntimeError with the error code message on failure."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native VM unavailable")

    code_arr = np.ascontiguousarray(code, dtype=np.uint32)
    in_arr = np.frombuffer(bytes(input_bytes), dtype=np.uint8) if input_bytes else np.zeros(0, np.uint8)
    out_arr = np.zeros(output_cap, np.uint8)
    out_len = ctypes.c_int64(0)
    tr_len = ctypes.c_int64(0)

    def run(trace_buf, cap):
        ram = np.zeros(ram_size, np.uint32)
        rc = lib.bf_execute(
            code_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(code_arr),
            in_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(in_arr),
            out_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), output_cap,
            ctypes.byref(out_len),
            ram.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), ram_size,
            trace_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)) if trace_buf is not None else None,
            cap, ctypes.byref(tr_len),
        )
        return rc, ram

    # pass 1: count only
    rc, _ = run(None, max_steps)
    if rc not in (BF_OK,):
        raise RuntimeError(_ERROR_MESSAGES.get(rc, f"bf_vm error {rc}"))
    n = tr_len.value
    trace = np.empty((n, 7), np.uint32)
    rc, ram = run(trace, n)
    if rc != BF_OK:
        raise RuntimeError(_ERROR_MESSAGES.get(rc, f"bf_vm error {rc}"))
    return trace, bytes(out_arr[: out_len.value]), ram
