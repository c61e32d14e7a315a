"""The quotient accumulation kernel: the hand-written Hopper kernel
(``csrc/quotients.cu``) behind ``core/quotients.accumulate_range`` on CUDA
tensors.

Counterpart of ``stwo_brainfuck_tpu/core/quotients.py``'s
``_accumulate_all_jit``: the combined OODS quotient of one commitment size,
all point groups in one launch (the JAX package's one fused executable a
size), bit for bit the plain torch version ``core/quotients.accumulate_groups``.

``KERNEL.accumulate(log_size, columns, groups, offset)``: the (4, n) int32
quotient at storage positions offset .. offset + n - 1 of the canonic
domain of size 2^log_size, from M31 columns of n values each (rows of any
tensors, read in place through a table of their pointers) and the point
groups' host constants (``core/quotients._group_constants``, packed by
``pack_groups`` behind the pointers: one small table, copied to the card
from pinned memory without a synchronization). The kernel makes each domain
point from its position (``emulate_points`` replays that on any device,
with the same tables), so no domain-point array exists; the output is its
only allocation.

The wrapper checks what it is given (CUDA, int32, 1-D with unit stride, one
length, one device, column indices in range) before it loads the library,
and raises on what the kernel does not take. The library is built with
nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.circle import points_at_indices
from ..core.m31 import P_INT
from . import nvcc

MAX_LOG_SIZE = 30  # kMaxLogSize: the first index of a canonic domain is 2^(30 - log_size)
LO_LOG = 16  # the tables: G^k for k < 2^16, G^(k * 2^16) for k < 2^15
HI_LOG = 31 - LO_LOG
HEADER_WORDS = 21  # a group: n_members, A, B, dy, dx, vc
MEMBER_WORDS = 5  # a member: column index, weight


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quotients_accumulate.argtypes = [ptr, i32, i32, i64, ptr, ptr, i32, i64, i64, ptr, ptr]
    lib.quotients_accumulate.restype = ctypes.c_int
    lib.quotients_max_log_size.restype = ctypes.c_int
    if lib.quotients_max_log_size() != MAX_LOG_SIZE:
        raise RuntimeError(f"csrc/quotients.cu has kMaxLogSize {lib.quotients_max_log_size()}, "
                           f"the wrapper {MAX_LOG_SIZE}")


def pack_groups(groups) -> np.ndarray:
    """The point groups [(consts (5, 4), weights (C_g, 4), idxs), ...] as the
    kernel reads them: uint32 words, group after group, n_members, A, B,
    dy, dx, vc, then (column index, w[4]) a member."""
    words = []
    for consts, weights, idxs in groups:
        words.append(np.array([len(idxs)], np.uint32))
        words.append(np.asarray(consts, np.uint32).reshape(-1))
        members = np.empty((len(idxs), MEMBER_WORDS), np.uint32)
        members[:, 0] = idxs
        members[:, 1:] = np.asarray(weights, np.uint32).reshape(len(idxs), 4)
        words.append(members.reshape(-1))
    return np.concatenate(words)


@functools.lru_cache(maxsize=None)
def _host_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(2^16, 2) and (2^15, 2) uint32 (x, y) of G^k, k < 2^16, and of
    G^(k * 2^16), k < 2^15 (core/circle.py)."""
    lo = np.stack(points_at_indices(np.arange(1 << LO_LOG, dtype=np.uint64)), axis=1)
    hi = np.stack(points_at_indices(np.arange(1 << HI_LOG, dtype=np.uint64) << np.uint64(LO_LOG)),
                  axis=1)
    return lo, hi


@functools.lru_cache(maxsize=8)
def point_tables(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's point tables as int32 tensors on `device` (cached)."""
    return tuple(torch.as_tensor(t.view(np.int32), device=device) for t in _host_tables())


def emulate_points(log_size: int, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) int64 of the canonic domain of size 2^log_size at storage
    `positions` (int64), made as the kernel makes them: the position
    bit-reversed over log_size bits, j its index in the half coset, k =
    (1 + 4j) * 2^(30 - log_size), G^k = lo[k mod 2^16] * hi[k / 2^16], the
    conjugate (x, -y) in the second half; on the positions' device."""
    if not 1 <= log_size <= MAX_LOG_SIZE:
        raise ValueError(f"quotient points: log_size {log_size} outside 1 .. {MAX_LOG_SIZE}")
    rev = torch.zeros_like(positions)
    for b in range(log_size):
        rev |= ((positions >> b) & 1) << (log_size - 1 - b)
    half = 1 << (log_size - 1)
    second = rev >= half
    j = torch.where(second, rev - half, rev)
    k = (1 + 4 * j) << (MAX_LOG_SIZE - log_size)
    lo, hi = (t.to(torch.int64) for t in point_tables(positions.device))
    p, q = lo[k & ((1 << LO_LOG) - 1)], hi[k >> LO_LOG]
    x = (p[:, 0] * q[:, 0] - p[:, 1] * q[:, 1]) % P_INT
    y = (p[:, 0] * q[:, 1] + p[:, 1] * q[:, 0]) % P_INT
    return x, torch.where(second, (-y) % P_INT, y)


def _check_columns(columns: Sequence[torch.Tensor]) -> Tuple[torch.device, int]:
    """Raise unless the columns are CUDA int32 vectors of one length with
    unit stride on one device; returns the device and the length."""
    if not columns:
        raise ValueError("quotients: no columns")
    for c in columns:
        if not isinstance(c, torch.Tensor):
            raise TypeError(f"quotients: a column is a {type(c).__name__}, not a tensor")
        if c.dtype != torch.int32:
            raise TypeError(f"the quotient kernel takes int32 columns, got {c.dtype}")
        if c.dim() != 1 or c.shape[0] != columns[0].shape[0]:
            raise ValueError(f"quotients: column of shape {tuple(c.shape)}, expected "
                             f"({columns[0].shape[0]},)")
        if c.shape[0] > 1 and c.stride(0) != 1:
            raise ValueError(f"quotients: column stride {c.stride(0)}, the kernel takes 1")
        if not c.is_cuda:
            raise ValueError(f"the quotient kernel takes CUDA tensors, a column is on {c.device}")
        if c.device != columns[0].device:
            raise ValueError(f"quotients: columns on {c.device} and {columns[0].device}")
    return columns[0].device, int(columns[0].shape[0])


class QuotientKernel:
    """The built kernel library and its launch count."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("quotients", _bind)
        self.launches = 0

    def accumulate(self, log_size: int, columns: Sequence[torch.Tensor], groups,
                   offset: int = 0) -> torch.Tensor:
        """(4, n) int32: the combined quotient at storage positions offset ..
        offset + n - 1 of the domain 2^log_size, in one launch (n = the
        columns' length; column c's value at position offset + t is
        columns[c][t])."""
        dev, n = _check_columns(columns)
        if not 1 <= log_size <= MAX_LOG_SIZE or offset < 0 or offset + n > 1 << log_size or not n:
            raise ValueError(f"quotients: positions {offset} .. {offset + n - 1} of a domain "
                             f"of 2^{log_size}")
        if not groups or any(not 0 <= ci < len(columns) for _, _, idxs in groups for ci in idxs):
            raise ValueError(f"quotients: groups {[g[2] for g in groups]} over "
                             f"{len(columns)} columns")
        lib = self.lib.load()
        words = pack_groups(groups)
        ptrs = np.array([c.data_ptr() for c in columns], np.uint64).view(np.uint32)
        host = torch.from_numpy(np.concatenate([ptrs, words]).view(np.int32)).pin_memory()
        out = torch.empty((4, n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            lo, hi = point_tables(dev)
            table = host.to(dev, non_blocking=True)
            rc = lib.quotients_accumulate(
                table.data_ptr(), len(columns), len(groups), words.size, lo.data_ptr(),
                hi.data_ptr(), log_size, offset, n, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quotient kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


KERNEL = QuotientKernel()
