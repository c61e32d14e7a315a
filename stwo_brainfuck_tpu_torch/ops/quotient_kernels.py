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
groups' host constants (``core/quotients.point_groups``, packed by
``pack_groups`` behind the pointers: one small table, copied to the card
from a reused pinned buffer, ``ops/staging.py``, without a
synchronization). The kernel makes each domain point itself, so no
domain-point array exists; the output is its only allocation.

``schedule`` mirrors the launch's schedule (K positions a thread, whether
its points are a walk, the stride) and ``emulate`` replays a launch on any
device: the positions of each thread, the walked or looked-up points
(``emulate_points`` replays the lookup), the K-point batched inversion with
its zero rule, the tails.

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

from ..core import m31, qm31
from ..core.circle import points_at_indices
from ..core.m31 import P_INT
from . import nvcc
from .staging import PinnedRing

MAX_LOG_SIZE = 30  # kMaxLogSize: the first index of a canonic domain is 2^(30 - log_size)
LO_LOG = 16  # the tables: G^k for k < 2^16, G^(k * 2^16) for k < 2^15
HI_LOG = 31 - LO_LOG
HEADER_WORDS = 21  # a group: n_members, A, B, dy, dx, vc
MEMBER_WORDS = 5  # a member: column index, weight
MAX_TABLE_BYTES = 48 << 10  # the table staged in shared memory


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quotients_accumulate.argtypes = [ptr, i32, i32, i64, ptr, ptr, i32, i64, i64, ptr, ptr]
    lib.quotients_accumulate.restype = ctypes.c_int
    lib.quotients_max_log_size.restype = ctypes.c_int
    lib.quotients_schedule.argtypes = [i32, i64, i64, ptr]
    lib.quotients_schedule.restype = ctypes.c_int
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


def schedule(n_groups: int, offset: int, n: int) -> Tuple[int, bool, int]:
    """(K, walk, stride) of the launch of n positions from offset with
    n_groups groups, as csrc/quotients.cu's schedule takes them: K = 8
    positions a thread with one group, 4 with more; the points are a walk
    when n = 2^l, l >= log2 K + 5 and offset is a multiple of n; the stride
    S = n / K there, else ceil(n / K) (thread t0 takes t0 + i * S, i < K,
    those below n)."""
    k = 8 if n_groups == 1 else 4
    k_log = k.bit_length() - 1
    walk = n & (n - 1) == 0 and n >= 1 << (k_log + 5) and offset % n == 0
    return k, walk, (n >> k_log) if walk else -(-n // k)


def _rev(m: int, bits: int) -> int:
    return int(format(m, f"0{bits}b")[::-1], 2) if bits else 0


def _table_point(k: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """G^k (int64 x, y) from the tables, as qm31::table_point."""
    p, q = lo[k & ((1 << LO_LOG) - 1)], hi[k >> LO_LOG]
    return ((p[..., 0] * q[..., 0] - p[..., 1] * q[..., 1]) % P_INT,
            (p[..., 0] * q[..., 1] + p[..., 1] * q[..., 0]) % P_INT)


def _walk_points(log_size: int, offset: int, n: int, k: int, stride: int, device):
    """(x, y) int64 (S, K) of a walk launch's threads, as walk_start makes
    them: the warp's first position's point times G^(rev4(lane / 2) * 2^27),
    conjugated on odd lanes, then K - 1 steps by D = G^(2^(32 - log2 n))."""
    lo, hi = (t.to(torch.int64) for t in point_tables(device))
    t0 = torch.arange(stride, dtype=torch.int64, device=device)
    lane = t0 & 31
    pw = offset + t0 - lane
    r = torch.zeros_like(pw)
    for b in range(log_size):
        r |= ((pw >> b) & 1) << (log_size - 1 - b)
    x, y = _table_point((1 + 4 * r) << (MAX_LOG_SIZE - log_size), lo, hi)
    e = hi[torch.tensor([_rev(v, 4) << 11 for v in range(16)], device=device)][lane >> 1]
    x, y = (x * e[:, 0] - y * e[:, 1]) % P_INT, (x * e[:, 1] + y * e[:, 0]) % P_INT
    odd = (lane & 1).bool()
    dx, dy = _table_point(torch.tensor(1 << (32 - (n.bit_length() - 1)), device=device), lo, hi)
    dy = torch.where(odd, (-dy) % P_INT, dy)
    y = torch.where(odd, (-y) % P_INT, y)
    xs, ys = [x], [y]
    for _ in range(k - 1):
        x, y = (x * dx - y * dy) % P_INT, (x * dy + y * dx) % P_INT
        xs.append(x)
        ys.append(y)
    return torch.stack(xs, 1), torch.stack(ys, 1)


def emulate(log_size: int, columns: Sequence[torch.Tensor], groups,
            offset: int = 0) -> torch.Tensor:
    """What one launch computes, on any device, as the kernel schedules it:
    thread t0 < S takes positions t0 + i * S (i = rev(m) for the m-th walked
    point, i = m with lookups; those at or past n are not live), a group's
    K norms are inverted together (a zero takes 1 into the running product
    and gets 0 out), a point's value is num (A - Bu) conj(den) times its
    norm's inverse. (4, n) int32."""
    dev = columns[0].device
    n = int(columns[0].shape[0])
    k, walk, stride = schedule(len(groups), offset, n)
    k_log = k.bit_length() - 1
    t0 = torch.arange(stride, dtype=torch.int64, device=dev)[:, None]
    idx = torch.tensor([_rev(m, k_log) if walk else m for m in range(k)], device=dev)
    rel = t0 + idx[None, :] * stride                                 # (S, K)
    live = rel < n
    if walk:
        px, py = _walk_points(log_size, offset, n, k, stride, dev)
    else:
        px, py = emulate_points(log_size, offset + rel.clamp(max=n - 1).reshape(-1))
        px, py = px.reshape(rel.shape), py.reshape(rel.shape)
    safe = rel.clamp(max=n - 1)
    acc = torch.zeros((4,) + rel.shape, dtype=torch.int64, device=dev)
    for consts, weights, idxs in groups:
        c = torch.as_tensor(np.asarray(consts, np.int64), device=dev)        # (5, 4)
        w = torch.as_tensor(np.asarray(weights, np.int64), device=dev)       # (C_g, 4)
        wf = (-c[0]).remainder(P_INT)[:, None, None].expand((4,) + rel.shape).clone()
        for j, ci in enumerate(idxs):
            f = torch.where(live, columns[ci].to(torch.int64)[safe], 0)
            wf = (wf + w[j][:, None, None] * f) % P_INT
        num = (wf - c[1][:, None, None] * py) % P_INT
        van = (c[2][:, None, None] * px - c[3][:, None, None] * py + c[4][:, None, None]) % P_INT
        a2r, a2i = ((van[0] + van[1]) * (van[0] - van[1])) % P_INT, 2 * van[0] * van[1] % P_INT
        b2r, b2i = ((van[2] + van[3]) * (van[2] - van[3])) % P_INT, 2 * van[2] * van[3] % P_INT
        den_r, den_i = (a2r - 2 * b2r + b2i) % P_INT, (a2i - b2r - 2 * b2i) % P_INT
        z = torch.where(live, (den_r * den_r + den_i * den_i) % P_INT, 0)
        t = qm31.mul(num, torch.stack([van[0], van[1], (-van[2]) % P_INT, (-van[3]) % P_INT]))
        cr, ci = den_r, (-den_i) % P_INT  # conj(den)
        y = torch.stack([(t[0] * cr - t[1] * ci) % P_INT, (t[0] * ci + t[1] * cr) % P_INT,
                         (t[2] * cr - t[3] * ci) % P_INT, (t[2] * ci + t[3] * cr) % P_INT])
        acc = (acc + y * batch_inv(z)[None] % P_INT) % P_INT
    out = torch.zeros((4, n), dtype=torch.int64, device=dev)
    out[:, rel[live]] = acc[:, live]
    return out.to(torch.int32)


def batch_inv(z: torch.Tensor) -> torch.Tensor:
    """qm31::batch_inv over the last axis (K values a thread): the running
    products with a zero taken as 1, one inversion, two products a value
    back; a zero gets 0. int64."""
    zs = torch.where(z == 0, 1, z)
    run = [zs[..., 0]]
    for m in range(1, z.shape[-1]):
        run.append(run[-1] * zs[..., m] % P_INT)
    t = m31.inv(run[-1])
    inv = [None] * z.shape[-1]
    for m in range(z.shape[-1] - 1, 0, -1):
        inv[m] = t * run[m - 1] % P_INT
        t = t * zs[..., m] % P_INT
    inv[0] = t
    return torch.where(z == 0, 0, torch.stack(inv, -1))


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
        self.staging = PinnedRing()

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
        words = pack_groups(groups)
        ptrs = np.array([c.data_ptr() for c in columns], np.uint64).view(np.uint32)
        if 4 * (ptrs.size + words.size) > MAX_TABLE_BYTES:
            raise ValueError(f"quotients: a table of {4 * (ptrs.size + words.size)} bytes, the "
                             f"kernel stages at most {MAX_TABLE_BYTES}")
        lib = self.lib.load()
        out = torch.empty((4, n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            lo, hi = point_tables(dev)
            table = self.staging.to_card(np.concatenate([ptrs, words]), dev)
            rc = lib.quotients_accumulate(
                table.data_ptr(), len(columns), len(groups), words.size, lo.data_ptr(),
                hi.data_ptr(), log_size, offset, n, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quotient kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


KERNEL = QuotientKernel()
