"""Circle FFT kernel wrapper: the hand-written Hopper kernel
(``csrc/circle_fft.cu``) behind the transforms of ``core/fft.py``.

It replaces the Pallas pair ``stwo_brainfuck_tpu/ops/fft_pallas.py::
_make_pass1`` / ``_make_pass2`` and computes the same function bit for bit.
The kernel runs the butterfly stages in passes (``pass_plan``): a tile pass
of up to TILE_LOG stages on contiguous 2^TILE_LOG-element tiles, and global
passes of up to TILE_LOG - 5 higher stages on 2^S x 32 strided tiles. It is
bound by device-memory bandwidth (8 bytes per element per pass), so a 2^24
transform costs 3 round trips.

Dispatch: a CPU tensor goes to the plain staged version
(``core.fft.evaluate_plain`` / ``interpolate_plain``); a CUDA tensor
launches the kernel or raises. ``emulate`` replays the kernel's schedule
and index arithmetic with torch ops, so the CPU tests check the schedule.

The library is built with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..core import fft, m31
from . import nvcc

TILE_LOG = 12      # shared-memory tile: 2^12 uint32 = 16 KB
GLOBAL_W_LOG = 5   # global passes load 32 consecutive elements per mid
MAX_LOG = 30


def pass_plan(n: int, inverse: bool) -> list:
    """Launch order as (l0, s_count, w_log) triples: stages l0 ..
    l0+s_count-1 on 2^s_count x 2^w_log tiles of at most 2^TILE_LOG
    elements. Forward runs the highest stages first; inverse runs the tile
    pass first."""
    t = min(n, TILE_LOG)
    plan = [(0, t, 0)]
    step = TILE_LOG - GLOBAL_W_LOG
    for l0 in range(t, n, step):
        plan.append((l0, min(step, n - l0), GLOBAL_W_LOG))
    return plan if inverse else plan[::-1]


@lru_cache(maxsize=64)
def twiddle_table(n: int, inverse: bool, device: str) -> torch.Tensor:
    """The per-stage twiddles of fft.get_twiddles(n, inverse), concatenated (stage L at
    offset 2^n - 2^(n-L)), as an int32 tensor on `device`."""
    return torch.cat(fft.get_twiddles(n, inverse, device)).to(torch.int32)


def _check(x: torch.Tensor, n: int) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"circle FFT takes int32 M31 values, got {x.dtype}")
    if not 1 <= n <= MAX_LOG or x.shape[-1] != 1 << n:
        raise ValueError(f"circle FFT of size 2^{n} got shape {tuple(x.shape)}")
    if x.dim() not in (1, 2):
        raise ValueError(f"circle FFT takes (N,) or (C, N), got {tuple(x.shape)}")


def _bind(lib: ctypes.CDLL) -> None:
    lib.circle_fft_pass.restype = ctypes.c_int
    lib.circle_fft_pass.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


class CircleFFTKernel:
    """The built kernel library and its launch count."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("circle_fft", _bind)
        self.launches = 0

    def run(self, x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
        """One transform of every row of x (CUDA, int32, contiguous)."""
        _check(x, n)
        if not x.is_cuda:
            raise ValueError(f"the circle FFT kernel takes CUDA tensors, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("the circle FFT kernel takes contiguous tensors")
        lib = self.lib.load()
        cols = 1 if x.dim() == 1 else x.shape[0]
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        tw = twiddle_table(n, inverse, str(x.device))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        plan = pass_plan(n, inverse)
        src = x
        for i, (l0, s_count, w_log) in enumerate(plan):
            scale = fft.inv_pow2(n) if inverse and i == len(plan) - 1 else 1
            rc = lib.circle_fft_pass(src.data_ptr(), out.data_ptr(), tw.data_ptr(),
                                     cols, n, l0, s_count, w_log, int(inverse),
                                     scale, stream)
            if rc != 0:
                raise RuntimeError(f"circle FFT launch failed: CUDA error {rc}")
            self.launches += 1
            src = out
        return out


KERNEL = CircleFFTKernel()


def _transform(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return (fft.interpolate_plain if inverse else fft.evaluate_plain)(x, n)
    if x.device.type != "cuda":
        raise ValueError(f"circle FFT: unsupported device {x.device}")
    return KERNEL.run(x, n, inverse)


def evaluate(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """Forward circle FFT of each row (coefficients -> bit-reversed values)."""
    return _transform(coeffs, n, inverse=False)


def interpolate(values: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse circle FFT of each row (bit-reversed values -> coefficients)."""
    return _transform(values, n, inverse=True)


def emulate(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """The kernel's schedule in torch: every pass of pass_plan, with the
    block/element/pair index arithmetic of stages_kernel evaluated for all
    blocks at once (gather a tile, run its stages, scatter it back)."""
    _check(x, n)
    dev = x.device
    rows = x.reshape(-1, 1 << n)
    cols = rows.shape[0]
    flat = m31.wide(rows).reshape(-1).clone()
    tw = twiddle_table(n, inverse, str(dev)).to(torch.int64)
    plan = pass_plan(n, inverse)
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=dev)  # noqa: E731
    for i, (l0, s_count, w_log) in enumerate(plan):
        tile_log = s_count + w_log
        chunk_log = l0 - w_log
        high_log = n - l0 - s_count
        b = ar(cols << (n - tile_log))[:, None]               # blockIdx.x
        chunk = b & ((1 << chunk_log) - 1)
        high = (b >> chunk_log) & ((1 << high_log) - 1)
        col = b >> (chunk_log + high_log)
        base = (col << n) + (high << (l0 + s_count)) + (chunk << w_log)
        e = ar(1 << tile_log)[None, :]
        gidx = base + ((e >> w_log) << l0) + (e & ((1 << w_log) - 1))
        tile = flat[gidx]                                     # (blocks, E)
        p = ar(1 << (tile_log - 1))[None, :]
        for j in range(s_count):
            s = j if inverse else s_count - 1 - j
            L = l0 + s
            tw_l = tw[(1 << n) - (1 << (n - L)):]
            lo = p & ((1 << w_log) - 1)
            m = p >> w_log
            mblock = m >> s
            mid0 = (mblock << (s + 1)) + (m & ((1 << s) - 1))
            e0 = ((mid0 << w_log) + lo).expand(tile.shape[0], -1)
            e1 = e0 + (1 << (s + w_log))
            t = tw_l[(high << (s_count - s - 1)) + mblock]
            u = tile.gather(1, e0)
            v = tile.gather(1, e1)
            if inverse:
                r0, r1 = (u + v) % m31.P, (u - v) % m31.P * t % m31.P
            else:
                tv = v * t % m31.P
                r0, r1 = (u + tv) % m31.P, (u - tv) % m31.P
            tile = tile.scatter(1, e0, r0).scatter(1, e1, r1)
        if inverse and i == len(plan) - 1:
            tile = tile * fft.inv_pow2(n) % m31.P
        flat[gidx] = tile
    return flat.reshape(x.shape).to(torch.int32)
