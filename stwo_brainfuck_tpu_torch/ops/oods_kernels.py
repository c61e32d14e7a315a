"""The OODS sampling kernel: the hand-written Hopper kernel (``csrc/oods.cu``)
behind ``core/poly.sample_groups`` on CUDA tensors.

Counterpart of ``stwo_brainfuck_tpu/core/poly.py``'s ``_sample_tensor_jit``:
every (trace log, shift) group of a prove sampled in one launch (the JAX
package dispatches one small program a group before its one pull), bit for
bit the plain torch version ``core/poly.sample_tensor``.

``KERNEL.sample(groups, shard)``: the (4, total rows) int32 samples of
`groups` ((log_size, point, rows) each, as ``poly.sample_groups`` takes
them). The rows are read in place through a table of their pointers; the
table (the rows' pointers, output columns, lengths and offsets, and each
group's basis factors, ``poly._point_factors``) goes to the card in one
non-blocking copy from a reused pinned buffer (``ops/staging.py``). The
kernel builds the half bases it needs from the factors, so no basis array
crosses PCIe. The output is the launch's only allocation; the 64-bit
scratch of the cross-block sums is kept a device and left zeroed by each
launch.

``schedule`` mirrors the launch's tiles (``oods_schedule`` in the source)
and ``emulate`` replays a launch on any device: the tiles, each thread's
rows and column, the bases as the kernel builds them, the threads' sums,
the blocks' sums and the scratch's sums in an arbitrary order of blocks.

The wrapper checks what it is given (CUDA, int32, 1-D with unit stride, a
power-of-two length dividing 2^log_size, one device) before it loads the
library, and raises on what the kernel does not take. The library is built
with nvcc at first use (``ops/nvcc.py``); at load, its table layout and its
tiles at every (log_size, log_n) must be the wrapper's copies.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from ..core import qm31
from ..core.m31 import P_INT
from ..core.poly import _point_factors
from . import nvcc
from .staging import PinnedRing

MAX_LOG_SIZE = 30
THREADS_LOG = 8   # 256 threads a block
TILE_LOG = 16     # positions a block takes at most
MEMBER_WORDS = 7  # pointer (2 words), log n, offset, first block, output column, group
GROUP_WORDS = 2   # n_g, the word index of its factors


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.oods_sample.argtypes = [ptr, i32, i32, i32, i64, ptr, ptr, ptr]
    lib.oods_sample.restype = ctypes.c_int
    lib.oods_schedule.argtypes = [i32, i32, ptr]
    lib.oods_schedule.restype = ctypes.c_int
    lib.oods_constants.argtypes = [ptr]
    lib.oods_constants.restype = None
    got = (ctypes.c_int * 3)()
    lib.oods_constants(ctypes.addressof(got))
    if tuple(got) != (MAX_LOG_SIZE, MEMBER_WORDS, GROUP_WORDS):
        raise RuntimeError(f"csrc/oods.cu has (kMaxLogSize, kMemberWords, kGroupWords) "
                           f"{tuple(got)}, the wrapper {(MAX_LOG_SIZE, MEMBER_WORDS, GROUP_WORDS)}")
    tile = (ctypes.c_longlong * 5)()
    for log_size in range(1, MAX_LOG_SIZE + 1):
        for log_n in range(log_size + 1):
            if lib.oods_schedule(log_size, log_n, ctypes.addressof(tile)) or \
                    tuple(tile) != tuple(schedule(log_size, log_n)):
                raise RuntimeError(f"csrc/oods.cu tiles a row of 2^{log_n} in a group of "
                                   f"2^{log_size} as {tuple(tile)}, the wrapper as "
                                   f"{tuple(schedule(log_size, log_n))}")


class Tile(NamedTuple):
    """A row's tiles (csrc/oods.cu tile_of): L = 2^lo basis columns, the
    row's (H_n, L_n) matrix, W columns and H_b rows a block, `blocks`
    blocks (stripes of W columns, then bands of H_b rows)."""
    lo: int
    log_ln: int
    log_w: int
    log_hb: int
    blocks: int


def schedule(log_size: int, log_n: int) -> Tile:
    """The tiles of a row of 2^log_n coefficients in a group of trace log
    log_size, as oods_schedule gives them."""
    if not 1 <= log_size <= MAX_LOG_SIZE or not 0 <= log_n <= log_size:
        raise ValueError(f"oods: a row of 2^{log_n} in a group of 2^{log_size}")
    lo = log_size // 2
    log_ln = min(log_n, lo)
    log_w = min(log_ln, THREADS_LOG)
    log_hn = log_n - log_ln
    log_hb = min(log_hn, TILE_LOG - log_w)
    return Tile(lo, log_ln, log_w, log_hb, 1 << (log_ln - log_w + log_hn - log_hb))


class Member(NamedTuple):
    row: torch.Tensor
    log_n: int
    offset: int
    column: int  # output column
    group: int


def members(groups: Sequence[tuple], shard: int = 0) -> list:
    """The launch's sampled columns in output order: (row, log2 of its
    length, offset of its first coefficient, output column, group). A row
    opened at several points is a member a point; None rows are left out
    (their columns stay 0). A row shorter than 2^log_size is chunk
    `shard`."""
    out = []
    col = 0
    for gi, (log_size, _, rows) in enumerate(groups):
        for r in rows:
            if r is not None:
                n = int(r.shape[0])
                offset = shard * n if n < 1 << log_size else 0
                out.append(Member(r, n.bit_length() - 1, offset, col, gi))
            col += 1
    return out


def _check(groups: Sequence[tuple], mem: list) -> torch.device:
    """Raise unless the rows are CUDA int32 vectors with unit stride on one
    device, each 2^k long (k <= log_size) with its chunk inside the row."""
    if not mem:
        raise ValueError("oods: no rows")
    dev = mem[0].row.device
    for m in mem:
        r, log_size = m.row, groups[m.group][0]
        if not isinstance(r, torch.Tensor):
            raise TypeError(f"oods: a row is a {type(r).__name__}, not a tensor")
        if r.dtype != torch.int32:
            raise TypeError(f"the OODS kernel takes int32 rows, got {r.dtype}")
        if not 1 <= log_size <= MAX_LOG_SIZE:
            raise ValueError(f"oods: a group of 2^{log_size} (at most 2^{MAX_LOG_SIZE})")
        n = r.shape[0] if r.dim() == 1 else -1
        if r.dim() != 1 or n < 1 or n & (n - 1) or n > 1 << log_size:
            raise ValueError(f"oods: a row of shape {tuple(r.shape)} in a group of 2^{log_size}")
        if m.offset + n > 1 << log_size:
            raise ValueError(f"oods: chunk at {m.offset} of 2^{m.log_n} outside 2^{log_size}")
        if n > 1 and r.stride(0) != 1:
            raise ValueError(f"oods: row stride {r.stride(0)}, the kernel takes 1")
        if not r.is_cuda:
            raise ValueError(f"the OODS kernel takes CUDA tensors, a row is on {r.device}")
        if r.device != dev:
            raise ValueError(f"oods: rows on {r.device} and {dev}")
    return dev


def pack(groups: Sequence[tuple], mem: list) -> tuple:
    """The launch's table (uint32 words: members, groups, factors) and its
    block count."""
    n_m, n_g = len(mem), len(groups)
    words = np.zeros(MEMBER_WORDS * n_m + GROUP_WORDS * n_g, np.uint32)
    factors = []
    at = words.size
    for gi, (log_size, point, _) in enumerate(groups):
        words[MEMBER_WORDS * n_m + GROUP_WORDS * gi:][:GROUP_WORDS] = (log_size, at)
        f = np.asarray(_point_factors(log_size, point), np.uint32).reshape(-1)
        factors.append(f)
        at += f.size
    first = 0
    for k, m in enumerate(mem):
        ptr = m.row.data_ptr()
        words[MEMBER_WORDS * k:][:MEMBER_WORDS] = (ptr & 0xFFFFFFFF, ptr >> 32, m.log_n,
                                                   m.offset, first, m.column, m.group)
        first += schedule(groups[m.group][0], m.log_n).blocks
    return np.concatenate([words, *factors]), first


def _basis(factors: torch.Tensor, first: int, bits: torch.Tensor) -> torch.Tensor:
    """(4, len(bits)) int64: the product of factors[first + k] over the set
    bits k of each entry of `bits`, in ascending k (csrc/oods.cu basis)."""
    acc = torch.zeros((4,) + bits.shape, dtype=torch.int64, device=bits.device)
    acc[0] = 1
    k = 0
    while bool((bits >> k).any()):
        sel = ((bits >> k) & 1).bool()
        acc = torch.where(sel, qm31.mul(acc, factors[first + k][:, None]), acc)
        k += 1
    return acc


def emulate(groups: Sequence[tuple], shard: int = 0, seed: int = 0) -> torch.Tensor:
    """What one launch computes, on the rows' device, as the kernel
    schedules it: each member's blocks and tiles, thread (r, w)'s rows r,
    r + R, ... of the tile's H_b and its column w of the tile's stripe, the
    rows' b_hi and the column's b_lo built from the group's factors, the
    thread's sum times b_lo, the block's sum; the blocks' sums added into
    the 64-bit scratch in a random order (`seed`), reduced mod p. (4, total)
    int32."""
    mem = members(groups, shard)
    total = sum(len(rows) for _, _, rows in groups)
    dev = mem[0].row.device if mem else torch.device("cpu")
    partials, columns = [], []
    for m in mem:
        log_size, point, _ = groups[m.group]
        t = schedule(log_size, m.log_n)
        hn, ln, w, hb = 1 << (m.log_n - t.log_ln), 1 << t.log_ln, 1 << t.log_w, 1 << t.log_hb
        rstep = (1 << THREADS_LOG) // w
        x = m.row.to(torch.int64).reshape(hn // hb, hb, ln // w, w)      # (bands, H_b, stripes, W)
        # thread r takes the band's rows r, r + R, ...: pad H_b up to R rows
        rows_pad = -(-hb // rstep) * rstep
        xp = torch.zeros((hn // hb, rows_pad, ln // w, w), dtype=torch.int64, device=dev)
        xp[:, :hb] = x
        xs = xp.reshape(hn // hb, rows_pad // rstep, rstep, ln // w, w)  # (bands, k, r, stripes, W)
        h = torch.arange(hn, device=dev, dtype=torch.int64)
        l_glob = (m.offset + torch.arange(ln, device=dev)) & ((1 << t.lo) - 1)
        f = torch.as_tensor(np.asarray(_point_factors(log_size, point), np.int64), device=dev)
        b_hi = _basis(f, t.lo, (m.offset + (h << t.log_ln)) >> t.lo).reshape(4, hn // hb, hb)
        hp = torch.zeros((4, hn // hb, rows_pad), dtype=torch.int64, device=dev)
        hp[:, :, :hb] = b_hi
        hs = hp.reshape(4, hn // hb, rows_pad // rstep, rstep)
        u = (xs[None] * hs[..., None, None] % P_INT).sum(2) % P_INT  # (4, bands, r, stripes, W)
        b_lo = _basis(f, 0, l_glob).reshape(4, ln // w, w)
        v = qm31.mul(u, b_lo[:, None, None])                         # (4, bands, r, stripes, W)
        block = v.sum((2, 4)) % P_INT                                 # (4, bands, stripes)
        partials.append(block.reshape(4, -1).transpose(0, 1))        # blocks in stripe order
        columns += [m.column] * partials[-1].shape[0]
    scratch = torch.zeros((4, total), dtype=torch.int64, device=dev)
    if partials:
        allp = torch.cat(partials)
        order = torch.randperm(allp.shape[0], generator=torch.Generator().manual_seed(seed))
        cols = torch.tensor(columns, device=dev)
        for i in order.tolist():
            scratch[:, cols[i]] += allp[i]
    return (scratch % P_INT).to(torch.int32)


class OodsKernel:
    """The built kernel library, its launch count and each device's 64-bit
    scratch (zeroed once, left zeroed by every launch)."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("oods", _bind)
        self.launches = 0
        self.staging = PinnedRing()
        self._scratch: Dict[torch.device, torch.Tensor] = {}

    def scratch(self, dev: torch.device, total: int) -> torch.Tensor:
        buf = self._scratch.get(dev)
        if buf is None or buf.numel() < 4 * total + 1:
            buf = torch.zeros(max(4 * total + 1, 4096), dtype=torch.int64, device=dev)
            self._scratch[dev] = buf
        return buf

    def sample(self, groups: Sequence[tuple], shard: int = 0) -> torch.Tensor:
        """(4, total rows) int32: poly.sample_groups of CUDA rows in one
        launch."""
        mem = members(groups, shard)
        dev = _check(groups, mem)
        total = sum(len(rows) for _, _, rows in groups)
        words, blocks = pack(groups, mem)
        lib = self.lib.load()
        out = torch.empty((4, total), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            scratch = self.scratch(dev, total)
            table = self.staging.to_card(words, dev)
            rc = lib.oods_sample(table.data_ptr(), len(mem), len(groups), total, blocks,
                                 scratch.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"OODS kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


KERNEL = OodsKernel()
