"""The OODS sampling kernel: the hand-written Hopper kernel (``csrc/oods.cu``)
behind ``core/poly.sample_groups`` on CUDA tensors.

Counterpart of ``stwo_brainfuck_tpu/core/poly.py``'s ``_sample_tensor_jit``:
every (trace log, shift) group of a prove sampled in one launch (the JAX
package dispatches one small program a group before its one pull), bit for
bit the plain torch version ``core/poly.sample_tensor``.

``KERNEL.sample(groups, shard)``: the (4, total rows) int32 samples of
`groups` ((log_size, point, rows) each, as ``poly.sample_groups`` takes
them), one launch for up to MAX_GROUPS groups. The rows are read in place
through a table of their pointers; the table (``plan``: the members' words,
a row opened at two points paired, each group's point, each block's first
member and pair and each slot's member, built with numpy from one pass over
the rows) goes to the card in one non-blocking copy from a reused pinned
buffer (``ops/staging.py``). The kernel builds the groups' basis factors
from their points, so no factor or basis array is computed on the host or
crosses PCIe. The output is the launch's only allocation besides an aligned
copy of a row that does not start on 16 bytes; the 64-bit scratch of the
cross-block sums is kept a device and left zeroed by each launch.

``schedule`` mirrors the persistent grid's spans (``oods_schedule`` in the
source), ``walk`` the rows and slots each block takes, and ``emulate``
replays a launch on any device: the spans, each thread's 4 (big row) or 2
(pair row, both points) coefficients of its rows, the pads, the packed
small rows, the factors as the kernel builds them (``group_factors``), the
flushes a member and block and warp, added into the scratch in a random
order.

The wrapper checks what it is given (CUDA, int32, 1-D with unit stride, a
power-of-two length dividing 2^log_size, one device) before it loads the
library, and raises on what the kernel does not take. The library is built
with nvcc at first use (``ops/nvcc.py``); at load, its constants and its
spans must be the wrapper's copies.
"""

from __future__ import annotations

import ctypes
from contextlib import nullcontext
from itertools import compress, repeat
from operator import attrgetter, is_not
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from .. import tracing
from ..core import qm31
from ..core.m31 import P_INT
from . import nvcc
from .staging import PinnedRing

MAX_LOG_SIZE = 30
MEMBER_WORDS = 9  # pointer (2 words), log n, offset, first row or slot, then the output
                  # column and group at each point (the second 0 for one point)
GROUP_WORDS = 9   # n_g, the point's x (4 words) and y (4 words)
THREADS_LOG = 8   # 256 threads a block
QUAD_LOG = 2      # a small member's slot: 4 coefficients
ROW_LOG = 10      # a big row: 2^10 coefficients, a thread's 4 (one 16-byte load)
PAIR_LOG = 9      # a pair row: 2^9 coefficients at two points, a thread's 2 (8 bytes)
TILE_ROWS = 256   # rows whose pointers and hi values a block builds at once
ROW_CHUNK = 4     # big rows a chunk (a member starts on a chunk)
PAIR_CHUNK = 4    # pair rows a chunk
SMALL_WEIGHT = 2  # a small row's weight in a span (a chunk's: 1)
MAX_GROUPS = 64   # groups a launch
EMULATED_BLOCKS = 7  # emulate's default grid bound (the card's is occupancy x SMs)
CONSTANTS = ("MAX_LOG_SIZE", "MEMBER_WORDS", "GROUP_WORDS", "THREADS_LOG", "QUAD_LOG",
             "ROW_LOG", "PAIR_LOG", "TILE_ROWS", "ROW_CHUNK", "PAIR_CHUNK", "SMALL_WEIGHT",
             "MAX_GROUPS")
# the spans _bind holds the library's against: (small, big, pair rows, blocks)
BIND_CASES = [(s, r, q, b) for s in (0, 1, 40) for r in (0, 20, (1 << 20) + 12)
              for q in (0, 12, 8000) for b in (1, 7, 528) if s or r or q]


def _constants() -> tuple:
    return tuple(globals()[name] for name in CONSTANTS)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.oods_sample.argtypes = [ptr, i32, i32, i32, i32, i64, i64, i64, i64, i32, i32, i64,
                                ptr, ptr, ptr]
    lib.oods_sample.restype = ctypes.c_int
    lib.oods_schedule.argtypes = [i64, i64, i64, i64, i64, ptr]
    lib.oods_schedule.restype = ctypes.c_int
    lib.oods_constants.argtypes = [ptr]
    lib.oods_constants.restype = None
    lib.oods_max_blocks.argtypes = [ptr]
    lib.oods_max_blocks.restype = ctypes.c_int
    lib.oods_attributes.argtypes = [ptr]
    lib.oods_attributes.restype = ctypes.c_int
    got = (ctypes.c_int * len(CONSTANTS))()
    lib.oods_constants(ctypes.addressof(got))
    if tuple(got) != _constants():
        raise RuntimeError(f"csrc/oods.cu has {CONSTANTS} = {tuple(got)}, the wrapper "
                           f"{_constants()}")
    span = (ctypes.c_longlong * 6)()
    for small_rows, big_rows, pair_rows, blocks in BIND_CASES:
        sch = schedule(small_rows, big_rows, pair_rows, blocks)
        for b in range(sch.grid):
            want = tuple(int(v[b]) for v in sch[1:])
            if lib.oods_schedule(b, sch.grid, small_rows, big_rows, pair_rows,
                                 ctypes.addressof(span)) or tuple(span) != want:
                raise RuntimeError(f"csrc/oods.cu gives block {b} of {sch.grid} over "
                                   f"{(small_rows, big_rows, pair_rows)} small, big and pair "
                                   f"rows the span {tuple(span)}, the wrapper {want}")


class Schedule(NamedTuple):
    """The persistent grid (csrc/oods.cu span_of): `grid` blocks, block b
    taking small rows small_lo[b] .. small_hi[b] - 1, big rows big_lo[b] ..
    big_hi[b] - 1 and pair rows pair_lo[b] .. pair_hi[b] - 1 (int64
    arrays)."""
    grid: int
    small_lo: np.ndarray
    small_hi: np.ndarray
    big_lo: np.ndarray
    big_hi: np.ndarray
    pair_lo: np.ndarray
    pair_hi: np.ndarray


def schedule(small_rows: int, big_rows: int, pair_rows: int, max_blocks: int) -> Schedule:
    """The spans of a launch over `small_rows` small rows and `big_rows` big
    and `pair_rows` pair rows (whole chunks) with at most `max_blocks`
    blocks: the b-th of `grid` equal spans of one weighted list (the small
    rows, SMALL_WEIGHT each, then the chunks of big rows, then the chunks of
    pair rows, 1 each), a unit in the span that holds its start; as
    oods_schedule gives them."""
    big, pair = big_rows // ROW_CHUNK, pair_rows // PAIR_CHUNK
    big_at = small_rows * SMALL_WEIGHT
    pair_at = big_at + big
    w = pair_at + pair
    if w < 1 or max_blocks < 1:
        raise ValueError(f"oods: a launch of {(small_rows, big_rows, pair_rows)} small, big and "
                         f"pair rows on {max_blocks} blocks")
    grid = min(max_blocks, w)
    edge = np.arange(grid + 1, dtype=np.int64) * w // grid
    small = np.minimum(small_rows, -(-edge // SMALL_WEIGHT))
    bigs = np.minimum(big, np.maximum(edge - big_at, 0)) * ROW_CHUNK
    pairs = np.minimum(pair, np.maximum(edge - pair_at, 0)) * PAIR_CHUNK
    return Schedule(grid, small[:-1], small[1:], bigs[:-1], bigs[1:], pairs[:-1], pairs[1:])


class Launch(NamedTuple):
    """One launch's table and counts (``plan``). `big`, `pairs` and `small`
    are the members' words as int64 ((k, MEMBER_WORDS), in the table's
    order), `rows` the live rows in output order and `index` the row of
    each member of the table (big, pairs, small)."""
    words: np.ndarray
    n_big: int
    n_pairs: int
    n_small: int
    n_groups: int
    big_rows: int
    pair_rows: int
    small_rows: int
    slots: int
    total: int
    grid: int
    big: np.ndarray
    pairs: np.ndarray
    small: np.ndarray
    rows: list
    index: np.ndarray
    device: torch.device


_DTYPE, _IS_CUDA, _DEVICE = attrgetter("dtype"), attrgetter("is_cuda"), attrgetter("device")


def _rows_of(groups: Sequence[tuple], cuda: bool) -> tuple:
    """(the number of rows, the live rows' columns (None: every row is
    live), the live rows, their data_ptrs, their lengths, their device).
    Raises on a row the kernel does not take. Each check is one pass over
    the rows at C speed (map)."""
    flat = [r for _, _, rows in groups for r in rows]
    present = list(map(is_not, flat, repeat(None)))
    live = list(compress(flat, present))
    if not live:
        raise ValueError("oods: no rows")
    T = torch.Tensor
    if not all(map(isinstance, live, repeat(T))):
        bad = next(r for r in live if not isinstance(r, T))
        raise TypeError(f"oods: a row is a {type(bad).__name__}, not a tensor")
    if set(map(_DTYPE, live)) != {torch.int32}:
        raise TypeError(f"the OODS kernel takes int32 rows, got {set(map(_DTYPE, live))}")
    if set(map(T.dim, live)) != {1} or not all(map(T.is_contiguous, live)):
        bad = next(r for r in live if r.dim() != 1 or not r.is_contiguous())
        raise ValueError(f"oods: a row of shape {tuple(bad.shape)} and stride {bad.stride()}, "
                         f"the kernel takes 1-D rows with unit stride")
    if cuda and not all(map(_IS_CUDA, live)):
        bad = next(r for r in live if not r.is_cuda)
        raise ValueError(f"the OODS kernel takes CUDA tensors, a row is on {bad.device}")
    # CUDA rows differ in their device's index alone
    if len(set(map(T.get_device, live) if cuda else map(_DEVICE, live))) > 1:
        raise ValueError(f"oods: rows on {sorted({str(r.device) for r in live})}")
    ptr = np.fromiter(map(T.data_ptr, live), np.uint64, len(live))
    n = np.fromiter(map(T.numel, live), np.int64, len(live))
    cols = None if len(live) == len(flat) else np.flatnonzero(present)
    return len(flat), cols, live, ptr, n, live[0].device


def plan(groups: Sequence[tuple], shard: int, max_blocks, cuda: bool = True) -> Launch:
    """The launch of `groups` (at most MAX_GROUPS, at least one row) with at
    most `max_blocks` blocks (an int, or a function of the rows' device,
    called once the rows are checked): its table and counts. A row shorter
    than 2^log_size is chunk `shard` (offset shard * n). Raises unless the
    rows are int32 vectors with unit stride on one device (CUDA unless
    `cuda` is False, as emulate takes them), each 2^k long (k <= log_size)
    with its chunk inside the row. Built with numpy from one pass over the
    rows, so its cost is a few dozen array operations whatever the rows."""
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"oods: {len(groups)} groups in a launch (1 to {MAX_GROUPS})")
    log_sizes = np.array([g[0] for g in groups], np.int64)
    if ((log_sizes < 1) | (log_sizes > MAX_LOG_SIZE)).any():
        raise ValueError(f"oods: groups of 2^{log_sizes.tolist()} (at most 2^{MAX_LOG_SIZE})")
    if shard < 0:
        raise ValueError(f"oods: shard {shard}")
    total, cols, rows, ptr, n, dev = _rows_of(groups, cuda)
    group = np.repeat(np.arange(len(groups)), [len(g[2]) for g in groups])
    if cols is not None:
        group = group[cols]
    log_n = np.frexp(n)[1].astype(np.int64) - 1
    log_size = log_sizes[group]
    if n.min() < 1 or (n != np.int64(1) << log_n).any() or (log_n > log_size).any():
        k = int(np.flatnonzero((n < 1) | (n != np.int64(1) << log_n) | (log_n > log_size))[0])
        raise ValueError(f"oods: a row of {int(n[k])} in a group of 2^{int(log_size[k])}")
    offset = np.where(log_n < log_size, shard * n, 0)
    if shard and (offset + n > np.int64(1) << log_size).any():
        raise ValueError(f"oods: a chunk of shard {shard} outside its row")
    col = np.arange(n.size) if cols is None else cols
    # a row at two points (one tensor, length and offset in two groups), 2^9
    # long or longer, is a pair: read once for both (the first two of each
    # run of equal rows, then the next two, ...)
    first_of, second_of = np.zeros(0, np.int64), np.zeros(0, np.int64)
    candidates = np.flatnonzero(n >= 1 << PAIR_LOG)
    if candidates.size > 1:
        # one key a row: its pointer (under 2^48), log n and whether it is a
        # chunk (which sets its offset)
        key = ((ptr[candidates].astype(np.int64) << 6 | log_n[candidates]) << 1 |
               (offset[candidates] > 0))
        o = candidates[np.argsort(key, kind="stable")]
        key = np.sort(key, kind="stable")
        same = key[1:] == key[:-1]
        at = np.arange(o.size)
        run = at - np.maximum.accumulate(np.where(np.r_[True, ~same], at, 0))
        lead = np.flatnonzero((run % 2 == 0) & np.r_[same, False])
        keep = np.argsort(o[lead])  # pairs in the output order of their first row
        first_of, second_of = o[lead][keep], o[lead + 1][keep]
    alone = np.ones(n.size, bool)
    alone[first_of] = alone[second_of] = False
    big = np.flatnonzero(alone & (n >= 1 << ROW_LOG))
    small = np.flatnonzero(alone & (n < 1 << ROW_LOG))
    small = small[np.argsort(-n[small], kind="stable")]  # longest first: slots aligned
    index = np.concatenate([big, first_of, small])
    n_big, n_pairs = big.size, first_of.size
    wide = n_big + n_pairs
    ptr_i = ptr[index]
    if wide and (ptr_i[:wide] % 16).any():  # read 16 or 8 bytes a thread
        rows = list(rows)
        for i in np.flatnonzero(ptr_i[:wide] % 16):
            k = int(index[i])
            rows[k] = rows[k].clone()  # an aligned copy
            ptr_i[i] = rows[k].data_ptr()
    # a member's rows padded to whole chunks
    units = np.concatenate([-(-(n[big] >> ROW_LOG) // ROW_CHUNK) * ROW_CHUNK,
                            -(-(n[first_of] >> PAIR_LOG) // PAIR_CHUNK) * PAIR_CHUNK,
                            np.maximum(n[small] >> QUAD_LOG, 1)])
    end = np.cumsum(units)
    first = end - units
    big_rows = int(end[n_big - 1]) if n_big else 0
    pair_rows = (int(end[wide - 1]) if wide else 0) - big_rows
    slots = (int(end[-1]) if index.size else 0) - big_rows - pair_rows
    first[n_big:wide] -= big_rows  # each kind counts from 0
    first[wide:] -= big_rows + pair_rows
    small_rows = -(-slots // (1 << THREADS_LOG))
    sch = schedule(small_rows, big_rows, pair_rows,
                   max_blocks if isinstance(max_blocks, int) else max_blocks(dev))
    w = np.zeros((index.size, MEMBER_WORDS), np.int64)
    w[:, 0] = ptr_i & np.uint64(0xFFFFFFFF)
    w[:, 1] = ptr_i >> np.uint64(32)
    w[:, 2] = log_n[index]
    w[:, 3] = offset[index]
    w[:, 4] = first
    w[:, 5] = col[index]
    w[:, 6] = group[index]
    w[n_big:wide, 7] = col[second_of]
    w[n_big:wide, 8] = group[second_of]
    block_big = np.searchsorted(first[:n_big], sch.big_lo, side="right") - 1
    block_pair = np.searchsorted(first[n_big:wide], sch.pair_lo, side="right") - 1
    slot_member = np.repeat(np.arange(small.size), units[wide:])
    point = np.array([(0, *pt[0], *pt[1]) for _, pt, _ in groups], np.int64) % P_INT
    point[:, 0] = log_sizes
    words = np.concatenate([w.reshape(-1), point.reshape(-1), np.maximum(block_big, 0),
                            np.maximum(block_pair, 0), slot_member])
    return Launch(words.astype(np.uint32), n_big, n_pairs, small.size, len(groups), big_rows,
                  pair_rows, small_rows, slots, total, sch.grid, w[:n_big], w[n_big:wide],
                  w[wide:], rows, index, dev)


def group_factors(groups: Sequence[tuple]) -> np.ndarray:
    """(groups, max log_size, 4) uint64: each group's basis factors [y, x,
    pi(x), ...] (core/poly.py _point_factors; entries past a group's
    log_size are further doublings), as the kernel builds them: one
    vectorised QM31 doubling chain over the groups."""
    x = np.array([pt[0] for _, pt, _ in groups], dtype=object).T % P_INT
    y = np.array([pt[1] for _, pt, _ in groups], dtype=object).T % P_INT
    x, y = x.astype(np.uint64), y.astype(np.uint64)
    one = np.array([1, 0, 0, 0], np.uint64)[:, None]
    out = [y]
    for _ in range(max(g[0] for g in groups) - 1):
        out.append(x)
        x = qm31.npq_sub(qm31.npq_mul(x, qm31.npq_add(x, x)), one)
    return np.stack(out).transpose(2, 0, 1)


def _basis(factors: torch.Tensor, first: int, bits: torch.Tensor) -> torch.Tensor:
    """(4, len(bits)) int64: the product of factors[first + k] over the set
    bits k of each entry of `bits` (csrc/oods.cu basis)."""
    acc = torch.zeros((4,) + bits.shape, dtype=torch.int64, device=bits.device)
    acc[0] = 1
    k = 0
    while bool((bits >> k).any()):
        sel = ((bits >> k) & 1).bool()
        acc = torch.where(sel, qm31.mul(acc, factors[first + k][:, None]), acc)
        k += 1
    return acc


class Step(NamedTuple):
    """What a block does (``walk``): small row `row` (kind "small"), or rows
    `lo` .. `hi` - 1 of big member or pair `member` (kind "big" or "pair":
    one flush)."""
    block: int
    kind: str
    member: int
    row: int
    lo: int
    hi: int


def walk(lp: Launch) -> List[Step]:
    """Every block's work, in the block's order: its small rows, then its
    big rows, then its pair rows, each split where the member changes (a
    flush each)."""
    sch = schedule(lp.small_rows, lp.big_rows, lp.pair_rows, lp.grid)
    out = []
    for b in range(sch.grid):
        out += [Step(b, "small", -1, int(r), 0, 0)
                for r in range(sch.small_lo[b], sch.small_hi[b])]
        kinds = [("big", lp.big, sch.big_lo[b], sch.big_hi[b]),
                 ("pair", lp.pairs, sch.pair_lo[b], sch.pair_hi[b])]
        for kind, members, g, hi in kinds:
            first = members[:, 4]
            g, hi = int(g), int(hi)
            while g < hi:
                m = int(np.searchsorted(first, g, side="right") - 1)
                end = min(hi, int(first[m + 1]) if m + 1 < len(first) else hi)
                out.append(Step(b, kind, m, -1, g, end))
                g = end
    return out


def _chunks(groups: Sequence[tuple]) -> list:
    """(first output column, groups) of each launch: MAX_GROUPS groups at
    most, and only those with a row."""
    out, col = [], 0
    for g0 in range(0, len(groups), MAX_GROUPS):
        chunk = groups[g0:g0 + MAX_GROUPS]
        if any(r is not None for _, _, rows in chunk for r in rows):
            out.append((col, chunk))
        col += sum(len(rows) for _, _, rows in chunk)
    return out


def _emulate_launch(lp: Launch, groups: Sequence[tuple], col: int, partials: list) -> None:
    """Append the (output column, (4,) int64 sum) of every flush of `lp`."""
    dev = lp.device
    f = torch.as_tensor(group_factors(groups).astype(np.int64), device=dev)  # (G, L, 4)
    one = torch.tensor([1, 0, 0, 0], dtype=torch.int64, device=dev)
    threads = 1 << THREADS_LOG

    def c(fg, count):  # c[i] = {1, f0, f1, f0 f1}[i], (count, 4)
        cs = [one, fg[0]] + ([fg[1], qm31.mul(fg[0], fg[1])] if count > 2 else [])
        return torch.stack(cs[:count])

    for step in walk(lp):
        if step.kind != "small":
            pair = step.kind == "pair"
            w = (lp.pairs if pair else lp.big)[step.member]
            log, at = (PAIR_LOG, 2) if pair else (ROW_LOG, 4)
            row = lp.rows[int(lp.index[step.member + (lp.n_big if pair else 0)])]
            real = 1 << (int(w[2]) - log)  # the member's rows, the rest pads its last chunk
            lo, hi = min(step.lo - int(w[4]), real), min(step.hi - int(w[4]), real)
            x = row.view(-1, threads, at)[lo:hi].to(torch.int64)                 # (rows, t, i)
            h = (int(w[3]) >> log) + torch.arange(lo, hi, device=dev)
            for p in range(2 if pair else 1):
                fg = f[int(w[6 + 2 * p])]
                b_hi = _basis(fg, log, h)                                         # (4, rows)
                q = (x[None] * b_hi[:, :, None, None] % P_INT).sum(1) % P_INT     # (4, t, i)
                ci = c(fg, at)
                s = q[:, :, 0]
                for i in range(1, at):
                    s = qm31.add(s, qm31.mul(q[:, :, i], ci[i][:, None]))
                mid = _basis(fg, log - THREADS_LOG, torch.arange(threads, device=dev))
                v = qm31.mul(s, mid)
                partials += [(col + int(w[5 + 2 * p]), s_)
                             for s_ in (v.view(4, -1, 32).sum(-1) % P_INT).T]
            continue
        first = lp.small[:, 4]
        for m in np.flatnonzero((first >= step.row * threads) & (first < (step.row + 1) * threads)):
            w = lp.small[m]
            fg = f[int(w[6])]
            log_n = int(w[2])
            n_at = 1 << min(log_n, QUAD_LOG)
            x = lp.rows[int(lp.index[lp.n_big + lp.n_pairs + m])].to(torch.int64)
            x = x.view(-1, n_at)                                              # (quads, i)
            u = (x[:, :, None] * c(fg, n_at)[None] % P_INT).sum(1) % P_INT    # (quads, 4)
            j0 = int(w[3]) + (torch.arange(x.shape[0], device=dev) << QUAD_LOG)
            v = qm31.mul(u.T, _basis(fg, 0, j0))                              # (4, quads)
            width = min(x.shape[0], 32)
            partials += [(col + int(w[5]), p) for p in (v.view(4, -1, width).sum(-1) % P_INT).T]


def emulate(groups: Sequence[tuple], shard: int = 0, seed: int = 0,
            max_blocks: int = EMULATED_BLOCKS) -> torch.Tensor:
    """What the launches of `groups` compute, on the rows' device, as the
    kernel schedules them (``walk``, grids of at most `max_blocks`): for a
    big member's rows in a block, thread t's quad t of each row times the
    row's hi value (the basis of the index's bits 10 and up), then sum_i
    c[i] s_i times its mid (bits 2-9), summed over each warp; for a small
    row, each slot's quad times its whole basis, summed over the member's
    lanes of a warp; the factors as ``group_factors`` builds them; every
    flush added into a 64-bit scratch in a random order (`seed`), reduced
    mod p. (4, total) int32."""
    total = sum(len(rows) for _, _, rows in groups)
    partials: list = []
    dev = torch.device("cpu")
    for col, chunk in _chunks(groups):
        lp = plan(chunk, shard, max_blocks, cuda=False)
        dev = lp.device
        _emulate_launch(lp, chunk, col, partials)
    scratch = torch.zeros((4, total), dtype=torch.int64, device=dev)
    order = torch.randperm(len(partials), generator=torch.Generator().manual_seed(seed))
    for i in order.tolist():
        column, p = partials[i]
        scratch[:, column] += p
    return (scratch % P_INT).to(torch.int32)


def _current(dev: torch.device):
    """`dev` made the current device, for the launch (nothing to do when it
    is: the common case, and entering torch.cuda.device costs more than the
    check)."""
    return nullcontext() if torch.cuda.current_device() == dev.index else torch.cuda.device(dev)


class OodsKernel:
    """The built kernel library, its launch count, each device's grid bound
    and 64-bit scratch (zeroed once, left zeroed by every launch)."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("oods", _bind)
        self.launches = 0
        self.staging = PinnedRing()
        self._scratch: Dict[torch.device, torch.Tensor] = {}
        self._max_blocks: Dict[torch.device, int] = {}

    def scratch(self, dev: torch.device, total: int) -> torch.Tensor:
        buf = self._scratch.get(dev)
        if buf is None or buf.numel() < 4 * total + 1:
            buf = torch.zeros(max(4 * total + 1, 4096), dtype=torch.int64, device=dev)
            self._scratch[dev] = buf
        return buf

    def max_blocks(self, dev: torch.device) -> int:
        """The most blocks resident at once on `dev`."""
        got = self._max_blocks.get(dev)
        if got is None:
            out = ctypes.c_int()
            lib = self.lib.load()
            with torch.cuda.device(dev):
                rc = lib.oods_max_blocks(ctypes.byref(out))
            if rc != 0 or out.value < 1:
                raise RuntimeError(f"OODS kernel occupancy query: CUDA error {rc}, "
                                   f"{out.value} blocks")
            got = self._max_blocks[dev] = out.value
        return got

    def attributes(self) -> dict:
        """The built kernel's registers a thread, static shared bytes and
        local (spilled) bytes a thread."""
        out = (ctypes.c_int * 3)()
        rc = self.lib.load().oods_attributes(ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"OODS kernel attributes: CUDA error {rc}")
        return {"registers": out[0], "shared_bytes": out[1], "local_bytes": out[2]}

    def enqueue(self, lp: Launch, table: torch.Tensor, out: torch.Tensor) -> None:
        """Launch `lp` on the current stream of its device (current), its
        table on the card, into `out` ((4, ld) int32, columns 0 .. total - 1
        of a view)."""
        scratch = self.scratch(lp.device, lp.total)
        rc = self.lib.load().oods_sample(
            table.data_ptr(), lp.n_big, lp.n_pairs, lp.n_small, lp.n_groups, lp.big_rows,
            lp.pair_rows, lp.small_rows, lp.slots, lp.total, out.stride(0), lp.grid,
            scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream(lp.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"OODS kernel launch failed: CUDA error {rc}")
        self.launches += 1

    def sample(self, groups: Sequence[tuple], shard: int = 0) -> torch.Tensor:
        """(4, total rows) int32: poly.sample_groups of CUDA rows, one launch
        for each MAX_GROUPS groups (one for a prove's)."""
        if len(groups) <= MAX_GROUPS:
            with tracing.span("oods.plan"):
                lp = plan(groups, shard, self.max_blocks)
                out = torch.empty((4, lp.total), dtype=torch.int32, device=lp.device)
            with tracing.span("oods.kernel"), _current(lp.device):
                self.enqueue(lp, self.staging.to_card(lp.words, lp.device), out)
            return out
        chunks = _chunks(groups)
        if not chunks:
            raise ValueError("oods: no rows")
        plans = [(col, plan(chunk, shard, self.max_blocks)) for col, chunk in chunks]
        dev = plans[0][1].device
        if any(lp.device != dev for _, lp in plans):
            raise ValueError(f"oods: rows on {[str(lp.device) for _, lp in plans]}")
        out = torch.zeros((4, sum(len(rows) for _, _, rows in groups)), dtype=torch.int32,
                          device=dev)
        with _current(dev):
            for col, lp in plans:
                self.enqueue(lp, self.staging.to_card(lp.words, dev), out[:, col:])
        return out


KERNEL = OodsKernel()
