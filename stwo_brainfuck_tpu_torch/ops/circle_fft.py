"""Circle FFT kernel wrapper: the hand-written Hopper kernel
(``csrc/circle_fft.cu``) behind the transforms of ``core/fft.py``.

It replaces the Pallas pair ``stwo_brainfuck_tpu/ops/fft_pallas.py::
_make_pass1`` / ``_make_pass2`` and computes the same function bit for bit.
The kernel runs the butterfly stages in passes (``pass_plan``): a tile pass
of up to TILE_LOG stages on contiguous 2^TILE_LOG-element tiles, then
global passes of up to GLOBAL_STAGES higher stages on 2^S x 2^w strided
tiles (2^w >= 8 consecutive words). Every transform up to 2^24 takes at most
two passes. Inside a pass a thread runs groups of up to R stages in
registers (``tile_groups``, ``thread_elements``); the tile sits in shared
memory between groups, at ``swizzle(e)``.

``extend`` (interpolate, zero-pad, evaluate on a 2^log_blowup times larger
domain) never writes the zero padding: the padded coefficients' top
log_blowup forward stages only copy, so the last inverse pass also runs the
first forward pass of every copy (mode 2 of the kernel), and the remaining
forward passes run on the copies with each copy's twiddle offset
(``launch_plan``). A row that fits one tile is extended in one launch.

Dispatch: a CPU tensor goes to the plain staged version
(``core.fft.evaluate_plain`` / ``interpolate_plain``); a CUDA tensor
launches the kernel or raises. ``emulate`` and ``emulate_extend`` replay
the kernel's launches on the CPU: the pass plan, the block and row
geometry, each thread's elements, the swizzled shared-memory addresses,
the twiddle staging and the 32-bit arithmetic, so the CPU tests check the
schedule.

The library is built with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..core import fft, m31
from . import nvcc

TILE_LOG = 13        # tile pass: 2^13 contiguous elements (32 KB)
GLOBAL_STAGES = 11   # global passes: up to 11 stages ...
MIN_W_LOG = 3        # ... of 2^w >= 8 consecutive words (one 32-byte sector)
THREADS_LOG = 9      # at most 512 threads a block
TARGET_BLOCKS = 1024  # rows are shared out until a launch has about this many blocks
MAX_GRID_Y = 65535
SMEM_LIMIT = 232448  # shared memory one block may use on sm_90
MAX_LOG = 30
MODE_FORWARD, MODE_INVERSE, MODE_EXTEND = 0, 1, 2


def pass_plan(n: int, inverse: bool) -> list:
    """Launch order as (l0, s_count, w_log) triples: stages l0 ..
    l0+s_count-1 on 2^s_count x 2^w_log tiles. The tile pass (l0 = 0) takes
    the low TILE_LOG stages; each global pass takes up to GLOBAL_STAGES
    more, on tiles of at least 2^TILE_LOG elements where l0 allows.
    Forward runs the highest stages first; inverse runs the tile pass
    first."""
    t = min(n, TILE_LOG)
    plan = [(0, t, 0)]
    for l0 in range(t, n, GLOBAL_STAGES):
        s = min(GLOBAL_STAGES, n - l0)
        plan.append((l0, s, min(l0, max(MIN_W_LOG, TILE_LOG - s))))
    return plan if inverse else plan[::-1]


def radix(tile_log: int) -> int:
    """Stages a thread runs in registers (it holds 2^radix elements), so
    that a block has at most 2^THREADS_LOG threads."""
    return max(min(tile_log, 4), tile_log - THREADS_LOG)


def tile_groups(s_count: int, r: int) -> list:
    """(s0, g) groups of tile stages, ascending: full groups of r from the
    bottom, the top group holding the remainder."""
    out = []
    s0 = 0
    while s_count - s0 > r:
        out.append((s0, r))
        s0 += r
    out.append((s0, s_count - s0))
    return out


def swizzle(e):
    """Shared-memory word of tile element e (csrc/circle_fft.cu::swz)."""
    return e ^ ((((e >> 5) ^ (e >> 6)) & 7) << 2)


def thread_elements(tile_log: int, w_log: int, r: int, s0: int, g: int) -> torch.Tensor:
    """(threads, 2^r) int64: the tile element of register k of each thread
    for the group (s0, g) (csrc/circle_fft.cu::run_group). The low F = r - g
    bits of k are tile bits 0 .. F-1, the next g bits the group's stage bits
    w+s0 .., the thread's bits fill the remaining tile bits in order."""
    f = r - g
    gpos = w_log + s0
    a_bits = gpos - f
    tid = torch.arange(1 << (tile_log - r), dtype=torch.int64)[:, None]
    k = torch.arange(1 << r, dtype=torch.int64)[None, :]
    ebase = ((tid & ((1 << a_bits) - 1)) << f) | ((tid >> a_bits) << (gpos + g))
    return ebase | (k & ((1 << f) - 1)) | ((k >> f) << gpos)


def smem_bytes(mode: int, s_count: int, w_log: int) -> int:
    """Dynamic shared memory of one block: the two-tile load ring (and the
    extend's work tile) and the staged twiddles."""
    tiles = 3 if mode == MODE_EXTEND else 2
    return 4 * ((tiles << (s_count + w_log)) + ((2 if mode == MODE_EXTEND else 1) << s_count))


@dataclass(frozen=True)
class Launch:
    """The arguments of one circle_fft_pass call. Buffers are named: "in",
    "out", "coeffs", "ext"."""
    mode: int
    src: str
    dst: str
    n: int
    copies_log: int
    l0: int
    s_count: int
    w_log: int
    rows: int
    rows_per_block: int
    scale: int = 1
    ext: str | None = None

    @property
    def tile_log(self) -> int:
        return self.s_count + self.w_log

    @property
    def radix(self) -> int:
        return radix(self.tile_log)

    def grid(self) -> tuple:
        chunks = -(-self.rows // self.rows_per_block)
        y = chunks << self.copies_log if self.mode == MODE_FORWARD else chunks
        return 1 << (self.n - self.tile_log), y


def _rows_per_block(rows: int, copies: int, positions: int) -> int:
    rpb = max(1, min(rows, rows * copies * positions // TARGET_BLOCKS))
    return max(rpb, -(-rows * copies // MAX_GRID_Y))


def _launch(mode, src, dst, n, rows, copies_log, p, scale=1, ext=None) -> Launch:
    l0, s, w = p
    copies = 1 << copies_log if mode == MODE_FORWARD else 1
    rpb = _rows_per_block(rows, copies, 1 << (n - s - w))
    return Launch(mode, src, dst, n, copies_log, l0, s, w, rows, rpb, scale, ext)


def launch_plan(op: str, n: int, rows: int, log_blowup: int = 0, scale=None) -> list:
    """The kernel launches of one transform of `rows` rows of 2^n:
    "evaluate" (in -> out), "interpolate" (in -> out, the last launch
    multiplying by `scale`, default 2^-n) or "extend" (in -> coeffs, ext
    with 2^log_blowup copies a row)."""
    if op == "evaluate":
        return [_launch(MODE_FORWARD, "in" if i == 0 else "out", "out", n, rows, 0, p)
                for i, p in enumerate(pass_plan(n, False))]
    inv = pass_plan(n, True)
    if op == "interpolate":
        last = fft.inv_pow2(n) if scale is None else scale
        return [_launch(MODE_INVERSE, "in" if i == 0 else "out", "out", n, rows, 0, p,
                        scale=last if i == len(inv) - 1 else 1)
                for i, p in enumerate(inv)]
    if op != "extend":
        raise ValueError(f"unknown circle FFT operation {op!r}")
    out = [_launch(MODE_INVERSE, "in" if i == 0 else "coeffs", "coeffs", n, rows, 0, p)
           for i, p in enumerate(inv[:-1])]
    out.append(_launch(MODE_EXTEND, "in" if len(inv) == 1 else "coeffs", "coeffs", n, rows,
                       log_blowup, inv[-1], scale=fft.inv_pow2(n), ext="ext"))
    out += [_launch(MODE_FORWARD, "ext", "ext", n, rows, log_blowup, p)
            for p in pass_plan(n, False)[1:]]
    return out


@lru_cache(maxsize=64)
def twiddle_table(n: int, inverse: bool, device: str) -> torch.Tensor:
    """The per-stage twiddles of the size-2^n domain, concatenated (stage L
    at offset 2^n - 2^(n-L)) and doubled (2t < 2^32, the kernel's
    m31::mul_doubled operand), as the bits of an int32 tensor on `device`.
    Built without keeping fft.get_twiddles' cached int64 stages."""
    doubled = 2 * torch.cat(fft.twiddle_stages(n, inverse, device))
    return torch.where(doubled >= 1 << 31, doubled - (1 << 32), doubled).to(torch.int32)


@lru_cache(maxsize=256)
def shard_twiddle_table(n: int, n_shards: int, i: int, inverse: bool, device: str) -> torch.Tensor:
    """The kernel's table for shard i's local stages of a 2^n transform
    split into n_shards chunks of 2^local: fft.shard_stages concatenated
    and doubled, which is exactly twiddle_table's layout for a 2^local
    transform (stage L at offset 2^local - 2^(local-L)). Sliced from
    twiddle_table(n, inverse, device)."""
    local = n - (n_shards.bit_length() - 1)
    full = twiddle_table(n, inverse, device)
    return torch.cat([full[(1 << n) - (1 << (n - L)) + (i << (local - 1 - L)):]
                      [: 1 << (local - 1 - L)] for L in range(local)])


def _check(x: torch.Tensor, n: int) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"circle FFT takes int32 M31 values, got {x.dtype}")
    if not 1 <= n <= MAX_LOG or x.shape[-1] != 1 << n:
        raise ValueError(f"circle FFT of size 2^{n} got shape {tuple(x.shape)}")
    if x.dim() not in (1, 2):
        raise ValueError(f"circle FFT takes (N,) or (C, N), got {tuple(x.shape)}")


def _check_blowup(n: int, log_blowup: int) -> None:
    if log_blowup < 1 or n + log_blowup > MAX_LOG:
        raise ValueError(f"circle FFT extend of 2^{n} by 2^{log_blowup} is out of range")


def _bind(lib: ctypes.CDLL) -> None:
    lib.circle_fft_pass.restype = ctypes.c_int
    lib.circle_fft_pass.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


class CircleFFTKernel:
    """The built kernel library and its launch count."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("circle_fft", _bind)
        self.launches = 0

    def run(self, op: str, x: torch.Tensor, n: int, log_blowup: int = 0,
            twiddles: torch.Tensor | None = None, scale=None):
        """One transform of every row of x (CUDA, int32, contiguous):
        "evaluate" and "interpolate" return one tensor, "extend" returns
        (coefficients, extension). `twiddles` replaces the size-2^n
        domain's table of an evaluate or interpolate (a shard's local
        stages: shard_twiddle_table); `scale` replaces the interpolate's
        2^-n (1: unscaled)."""
        _check(x, n)
        if op == "extend":
            _check_blowup(n, log_blowup)
            if twiddles is not None:
                raise ValueError("the fused extend takes no explicit twiddle table")
        if twiddles is not None and (twiddles.dtype != torch.int32 or twiddles.device != x.device
                                     or twiddles.numel() != (1 << n) - 1):
            raise ValueError(f"a twiddle table for 2^{n} is 2^{n} - 1 int32 on {x.device}")
        if not x.is_cuda:
            raise ValueError(f"the circle FFT kernel takes CUDA tensors, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("the circle FFT kernel takes contiguous tensors")
        lib = self.lib.load()
        rows = 1 if x.dim() == 1 else x.shape[0]
        bufs = {"in": x}
        if op == "extend":
            bufs["coeffs"] = torch.empty_like(x)
            bufs["ext"] = torch.empty(x.shape[:-1] + (1 << (n + log_blowup),),
                                      dtype=torch.int32, device=x.device)
        else:
            bufs["out"] = torch.empty_like(x)
        if rows:
            dev = str(x.device)
            tw_inv = tw_fwd = None
            if op != "evaluate":
                tw_inv = twiddles if twiddles is not None else twiddle_table(n, True, dev)
            if op != "interpolate":
                tw_fwd = (twiddles if twiddles is not None
                          else twiddle_table(n + log_blowup, False, dev))
            ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
            stream = torch.cuda.current_stream(x.device).cuda_stream
            for a in launch_plan(op, n, rows, log_blowup, scale):
                rc = lib.circle_fft_pass(
                    ptr(bufs[a.src]), ptr(bufs[a.dst]), ptr(bufs.get(a.ext)), ptr(tw_inv),
                    ptr(tw_fwd), a.mode, a.n, a.copies_log, a.l0, a.s_count, a.w_log,
                    a.radix, a.rows, a.rows_per_block, a.scale, stream)
                if rc != 0:
                    raise RuntimeError(f"circle FFT launch failed: CUDA error {rc}")
                self.launches += 1
        if op == "extend":
            return bufs["coeffs"], bufs["ext"]
        return bufs["out"]


KERNEL = CircleFFTKernel()


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"circle FFT: unsupported device {x.device}")
    return x.device.type


def evaluate(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """Forward circle FFT of each row (coefficients -> bit-reversed values)."""
    if _device_of(coeffs) == "cpu":
        return fft.evaluate_plain(coeffs, n)
    return KERNEL.run("evaluate", coeffs, n)


def interpolate(values: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse circle FFT of each row (bit-reversed values -> coefficients)."""
    if _device_of(values) == "cpu":
        return fft.interpolate_plain(values, n)
    return KERNEL.run("interpolate", values, n)


def extend(values: torch.Tensor, n: int, log_blowup: int):
    """(coefficients, evaluation on the 2^log_blowup times larger domain)
    of each row. A CPU tensor takes the plain interpolate -> zero-pad ->
    evaluate (fft.extend_plain); a CUDA tensor the fused kernel, which
    writes no padding."""
    if _device_of(values) == "cpu":
        _check(values, n)
        _check_blowup(n, log_blowup)
        return fft.extend_plain(values, n, log_blowup)
    return KERNEL.run("extend", values, n, log_blowup)


def shard_evaluate(x: torch.Tensor, n: int, n_shards: int, i: int) -> torch.Tensor:
    """The local forward stages of shard i (x: its 2^local chunk, rows on
    the last axis) of a 2^n evaluate split into n_shards chunks: the
    kernel with the shard's table, or on the CPU the plain version with
    the shard's stages."""
    local = n - (n_shards.bit_length() - 1)
    if _device_of(x) == "cpu":
        return fft.evaluate_plain(x, local, fft.shard_stages(n, n_shards, i, False, "cpu"))
    return KERNEL.run("evaluate", x, local,
                      twiddles=shard_twiddle_table(n, n_shards, i, False, str(x.device)))


def shard_interpolate(x: torch.Tensor, n: int, n_shards: int, i: int) -> torch.Tensor:
    """The local inverse stages of shard i of a 2^n interpolate, unscaled
    (the 2^-n comes after the cross-shard stages)."""
    local = n - (n_shards.bit_length() - 1)
    if _device_of(x) == "cpu":
        return fft.interpolate_plain(x, local, fft.shard_stages(n, n_shards, i, True, "cpu"),
                                     scale=1)
    return KERNEL.run("interpolate", x, local, scale=1,
                      twiddles=shard_twiddle_table(n, n_shards, i, True, str(x.device)))


# ---------------------------------------------------------------------------
# CPU replay of the kernel's launches
# ---------------------------------------------------------------------------

_MASK = (1 << 32) - 1
_P = m31.P_INT


def _reduce_once(r):
    return torch.minimum(r, (r - _P) & _MASK)


def _add(a, b):
    return _reduce_once((a + b) & _MASK)


def _sub(a, b):
    d = (a - b) & _MASK
    return torch.minimum(d, (d + _P) & _MASK)


def _mul(a, b):
    prod = a * b                              # < 2^62: exact in int64
    lo, hi = prod & _MASK, prod >> 32
    return _reduce_once((lo & _P) + (((hi << 1) & _MASK) | (lo >> 31)))


def _mul_doubled(a, t2):
    prod = a * t2                             # < 2^63: exact in int64
    return _reduce_once(((prod >> 32) + ((prod & _MASK) >> 1)) & _MASK)


def _block_rows(a: Launch) -> list:
    """(physical row, copy) of every row the launch's blocks take, in block
    order, as fft_pass computes them; each appears once."""
    out = []
    copies = 1 << a.copies_log
    for y in range(a.grid()[1]):
        copy = y & (copies - 1) if a.mode == MODE_FORWARD else 0
        r0 = (y >> a.copies_log if a.mode == MODE_FORWARD else y) * a.rows_per_block
        shift = a.copies_log if a.mode == MODE_FORWARD else 0
        for i in range(min(a.rows_per_block, a.rows - r0)):
            out.append((((r0 + i) << shift) + copy, copy))
    return out


def _stage_twiddles(table, big, copies, a: Launch, high):
    """(copies, positions, 2^S - 1) twiddles as stage_twiddles stages them."""
    s_all = 1 << a.s_count
    i = torch.arange(s_all - 1, dtype=torch.int64)
    rest = s_all - 1 - i
    lg = torch.tensor([int(v).bit_length() - 1 for v in rest.tolist()], dtype=torch.int64)
    s = a.s_count - 1 - lg
    one = torch.ones_like(s)
    m = i - (s_all - (one << (a.s_count - s)))
    L = a.l0 + s
    c = torch.as_tensor(copies, dtype=torch.int64)[:, None, None]
    idx = (((1 << big) - (one << (big - L))) + (c << (a.n - 1 - L))
           + (high[None, :, None] << (a.s_count - 1 - s)) + m)
    return table[idx]


def _transform(tile, tw, a: Launch, inverse: bool, out=None):
    """transform<R, inverse> on (rows, positions, 2^T) swizzled tiles with
    (rows or 1, positions, 2^S - 1) staged twiddles; the first group reads
    `tile`, every group writes `out` (default: in place)."""
    out = tile if out is None else out
    r = a.radix
    groups = tile_groups(a.s_count, r)
    for gi, (s0, g) in enumerate(groups if inverse else groups[::-1]):
        src = tile if gi == 0 else out
        f = r - g
        e = thread_elements(a.tile_log, a.w_log, r, s0, g)       # (threads, K)
        addr = swizzle(e).reshape(-1)
        x = src[..., addr].reshape(src.shape[:-1] + e.shape)
        ebase = e[:, :1]                                         # register 0
        k = torch.arange(1 << r, dtype=torch.int64)
        for j in (range(g) if inverse else reversed(range(g))):
            s = s0 + j
            seg = (1 << a.s_count) - (1 << (a.s_count - s))
            lo = k[(k >> (f + j)) & 1 == 0]
            hi = lo | (1 << (f + j))
            tidx = seg + ((ebase >> (a.w_log + s + 1)) | ((lo >> f) >> (j + 1))[None, :])
            t = tw[..., tidx.reshape(-1)].reshape(tw.shape[:-1] + tidx.shape)
            u, v = x[..., lo], x[..., hi]
            if inverse:
                x[..., lo], x[..., hi] = _add(u, v), _mul_doubled(_sub(u, v), t)
            else:
                tv = _mul_doubled(v, t)
                x[..., lo], x[..., hi] = _add(u, tv), _sub(u, tv)
        out[..., addr] = x.reshape(x.shape[:-2] + (-1,))
    return out


def _replay(a: Launch, bufs: dict, tw_inv, tw_fwd) -> None:
    """One launch of fft_pass on flat int64 buffers (rows of 2^n)."""
    for name in (a.src, a.dst, a.ext):
        if name is not None and bufs[name].shape[-1] != 1 << a.n:
            raise AssertionError("replay buffers are rows of 2^n")
    positions = 1 << (a.n - a.tile_log)
    pos = torch.arange(positions, dtype=torch.int64)
    chunk_log = a.l0 - a.w_log
    high = pos >> chunk_log
    base = (high << (a.l0 + a.s_count)) + ((pos & ((1 << chunk_log) - 1)) << a.w_log)
    e = torch.arange(1 << a.tile_log, dtype=torch.int64)
    offset = base[:, None] + ((e >> a.w_log) << a.l0) + (e & ((1 << a.w_log) - 1))
    order = torch.argsort(swizzle(e))            # tile word -> element
    rows = _block_rows(a)
    phys = torch.tensor([r for r, _ in rows], dtype=torch.int64)
    copies = [c for _, c in rows]
    src = bufs[a.src][phys][:, offset]           # (rows, positions, 2^T), by element
    tile = src[..., order]                       # by shared-memory word
    if a.mode == MODE_FORWARD:
        tw = _stage_twiddles(tw_fwd, a.n + a.copies_log, copies, a, high)
        result = _transform(tile, tw, a, inverse=False)
    else:
        tw = _stage_twiddles(tw_inv, a.n, [0], a, high)
        result = _transform(tile, tw, a, inverse=True)
        if a.scale != 1:
            result = _mul(result, torch.full_like(result, a.scale))
    for r, row in enumerate(phys.tolist()):
        bufs[a.dst][row, offset.reshape(-1)] = result[r][..., swizzle(e)].reshape(-1)
    if a.mode == MODE_EXTEND:
        for c in range(1 << a.copies_log):
            tw = _stage_twiddles(tw_fwd, a.n + a.copies_log, [c], a, high)
            work = _transform(result, tw, a, inverse=False, out=torch.empty_like(result))
            for r, row in enumerate(phys.tolist()):
                bufs[a.ext][(row << a.copies_log) + c, offset.reshape(-1)] = \
                    work[r][..., swizzle(e)].reshape(-1)


def _emulate(op: str, x: torch.Tensor, n: int, log_blowup: int = 0, twiddles=None, scale=None):
    _check(x, n)
    rows = x.reshape(-1, 1 << n)
    c = rows.shape[0]
    bufs = {"in": m31.wide(rows).clone(), "out": torch.zeros(c, 1 << n, dtype=torch.int64),
            "coeffs": torch.zeros(c, 1 << n, dtype=torch.int64),
            "ext": torch.zeros(c << log_blowup, 1 << n, dtype=torch.int64)}
    if twiddles is None:
        tw_inv, tw_fwd = twiddle_table(n, True, "cpu"), twiddle_table(n + log_blowup, False, "cpu")
    else:
        tw_inv = tw_fwd = twiddles
    tw_inv, tw_fwd = tw_inv.to(torch.int64) & _MASK, tw_fwd.to(torch.int64) & _MASK
    for a in launch_plan(op, n, c, log_blowup, scale):
        if smem_bytes(a.mode, a.s_count, a.w_log) > SMEM_LIMIT or a.grid()[1] > MAX_GRID_Y:
            raise AssertionError(f"launch out of the card's limits: {a}")
        _replay(a, bufs, tw_inv, tw_fwd)
    lead = x.shape[:-1]
    if op == "extend":
        return (bufs["coeffs"].reshape(x.shape).to(torch.int32),
                bufs["ext"].reshape(lead + (1 << (n + log_blowup),)).to(torch.int32))
    return bufs["out"].reshape(x.shape).to(torch.int32)


def emulate(x: torch.Tensor, n: int, inverse: bool, twiddles=None, scale=None) -> torch.Tensor:
    """The kernel's evaluate (or interpolate) launches replayed on the CPU,
    with run's `twiddles` and `scale` (a shard's local stages: its
    shard_twiddle_table and scale 1)."""
    return _emulate("interpolate" if inverse else "evaluate", x, n, twiddles=twiddles, scale=scale)


def emulate_extend(x: torch.Tensor, n: int, log_blowup: int):
    """The kernel's fused extend replayed on the CPU: (coeffs, extension)."""
    _check_blowup(n, log_blowup)
    return _emulate("extend", x, n, log_blowup)
