"""The mesh path's elementwise M31 stages: the hand-written Hopper kernel
(``csrc/mesh_stages.cu``) behind the sharded circle FFT's cross-shard
butterflies and the composition's per-size sum, run in place on a shard's
own int32 buffer.

Each stage maps a shard's column x and the partner shard's column y (the
sum: the other addend) to ``out`` (by default x itself):

- ``evaluate_cross``: the lower shard x + t·y, the upper y − t·x;
- ``interpolate_cross``: the lower (x + y)·s, the upper (y − x)·t·s, where
  s is 1 but in the last stage, which folds in the transform's 2^-n;
- ``add_into``: x + y.

A CUDA tensor launches the kernel (one launch a call, counted in
``KERNEL.launches``): a product is widened to 64 bits only in registers, so
no stage allocates. A CPU tensor takes the plain version (``*_plain``:
``core/m31`` arithmetic, exact mod p, written into ``out``), the same values
bit for bit. The library is built with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import m31
from . import nvcc

P = m31.P_INT
# csrc/mesh_stages.cu's ops
EVAL_LOWER, EVAL_UPPER, ADD, ADD_SCALED, SUB_MUL = range(5)

# Calls of the plain versions on CUDA tensors (the public functions never
# make one).
PLAIN_CUDA_CALLS = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    lib.mesh_cross.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_int,
                               ctypes.c_int, ptr]
    lib.mesh_cross.restype = ctypes.c_int


class MeshKernel:
    """The built library and its launch count."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("mesh_stages", _bind)
        self.launches = 0

    def run(self, op: int, x: torch.Tensor, y: torch.Tensor, c: int, out: torch.Tensor) -> None:
        """One launch: out = op(x, y, c) elementwise, on contiguous CUDA
        int32 tensors of one shape (out may be x)."""
        n = x.numel()
        if n == 0:
            return
        lib = self.lib.load()
        vectors = int(all(t.data_ptr() % 16 == 0 for t in (x, y, out)))
        with torch.cuda.device(x.device):  # the card's default stream is the current device's
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.mesh_cross(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, int(c) % P, op,
                                vectors, stream)
        if rc != 0:
            raise RuntimeError(f"mesh stage launch failed: CUDA error {rc}")
        self.launches += 1


KERNEL = MeshKernel()


def _check(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> None:
    for t in (x, y, out):
        if t.dtype != torch.int32:
            raise TypeError(f"the mesh stages take int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the mesh stages take contiguous tensors")
    if not (x.shape == y.shape == out.shape):
        raise ValueError(f"mesh stage shapes differ: {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(out.shape)}")
    if not (x.device == y.device == out.device):
        raise ValueError(f"mesh stage operands on several devices: {x.device}, {y.device}, "
                         f"{out.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mesh stage: unsupported device {x.device}")


def _stage(op: int, x: torch.Tensor, y: torch.Tensor, c: int,
           out: Optional[torch.Tensor]) -> torch.Tensor:
    out = x if out is None else out
    _check(x, y, out)
    if x.is_cuda:
        KERNEL.run(op, x, y, c, out)
    else:
        stage_plain(op, x, y, c, out)
    return out


def evaluate_cross(x: torch.Tensor, y: torch.Tensor, t: int, upper: bool,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An evaluate's cross stage on one column: the lower shard x + t·y,
    the upper y − t·x (x its own values, y its partner's), into `out`
    (default: x, in place). Returns `out`."""
    return _stage(EVAL_UPPER if upper else EVAL_LOWER, x, y, t, out)


def interpolate_cross(x: torch.Tensor, y: torch.Tensor, t_inv: int, upper: bool, scale: int = 1,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An interpolate's cross stage on one column: the lower shard
    (x + y)·scale, the upper (y − x)·t_inv·scale, into `out` (default: x).
    Returns `out`."""
    if upper:
        return _stage(SUB_MUL, x, y, t_inv * scale % P, out)
    return _stage(ADD if scale % P == 1 else ADD_SCALED, x, y, scale, out)


def add_into(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x += y mod p, in place. Returns x."""
    return _stage(ADD, x, y, 1, None)


def stage_plain(op: int, x: torch.Tensor, y: torch.Tensor, c: int,
                out: torch.Tensor) -> torch.Tensor:
    """The plain version of one launch (core/m31 arithmetic), written into
    `out`."""
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    if op == EVAL_LOWER:
        r = m31.add(x, m31.mul(y, c))
    elif op == EVAL_UPPER:
        r = m31.sub(y, m31.mul(x, c))
    elif op == ADD:
        r = m31.add(x, y)
    elif op == ADD_SCALED:
        r = m31.mul(m31.add(x, y), c)
    elif op == SUB_MUL:
        r = m31.mul(m31.sub(y, x), c)
    else:
        raise ValueError(f"unknown mesh stage {op}")
    return out.copy_(r)
