"""The FRI fold kernel: the hand-written Hopper kernel (``csrc/fri_fold.cu``)
behind ``core/fri.fold_step`` on CUDA tensors.

Counterpart of ``stwo_brainfuck_tpu/core/fri.py``'s ``_fold_jit``,
``_fold2_jit`` and ``_fold_add_jit``: one launch goes from a committed FRI
layer to the next (``core/fri.FoldStep``: zero, one or two folds, the
injected circle inputs between and after them), bit for bit the plain torch
version ``core/fri.fold_step_plain``. Every array is int32 in and out; no
int64 buffer and no chunking exist.

``KERNEL.fold(values, step, inject_a, inject_b, offset)``: the (4, n) int32
output positions offset .. offset + n - 1 of the step's output level (a
mesh shard's chunk; its inputs are the matching chunks). The twiddles are
read where ``fri.fold_twiddles`` says: the circle FFT's doubled int32
tables (``ops/circle_fft.twiddle_table``), which every prove already keeps
on the card, inverted in the kernel in batches (the int32 inverse tables
``fri._fold_itw`` are the plain version's twiddles). The output is the
launch's only allocation.

``emulate`` replays a launch on any device: the outputs a thread takes, the
twiddles it reads for them (the table offsets of the step and the chunk),
their batched inversion with its zero rule, and the folds and injections.

The wrapper checks what it is given (CUDA, int32, (4, m) with unit stride
along a row, the shapes of the step, one device, outputs within the
kernel's 32-bit indices) before it loads the library, and raises on what
the kernel does not take. The library is built
with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
import numpy as np
import torch

from ..core import fri, qm31
from ..core.m31 import P_INT
from . import nvcc
from .quotient_kernels import batch_inv

OUTPUTS_PER_THREAD = 4  # kK


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fri_fold.argtypes = [i32, ptr, i64, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, ptr,
                             i64, ptr, ptr]
    lib.fri_fold.restype = ctypes.c_int
    lib.fri_fold_outputs_per_thread.restype = ctypes.c_int
    if lib.fri_fold_outputs_per_thread() != OUTPUTS_PER_THREAD:
        raise RuntimeError(f"csrc/fri_fold.cu takes {lib.fri_fold_outputs_per_thread()} "
                           f"outputs a thread, the wrapper {OUTPUTS_PER_THREAD}")


def pairs_per_output(step: fri.FoldStep, use: str) -> int:
    """The twiddles a use reads for each output: two for the first of two
    folds and for inject_a (pairs 2t and 2t + 1), one otherwise."""
    return 2 if use == "inject_a" or (use == "fold1" and step.folds == 2) else 1


def twiddle_reads(step: fri.FoldStep, n: int, offset: int, has_a: bool, has_b: bool,
                  device) -> dict:
    """use -> (table, index of the chunk's pair 0 in it, pairs read) for
    each twiddle use of the step: the chunk's output t reads pair width * t
    + k of it (width = pairs_per_output)."""
    out = {}
    for use, kind, log in step.twiddles(has_a, has_b):
        width = pairs_per_output(step, use)
        table, start = fri.fold_twiddles(kind, log, step.top, device)
        out[use] = (table, start + width * offset, width * n)
    return out


def _check(values, step: fri.FoldStep, inject_a, inject_b, offset: int) -> int:
    """Raise unless the arrays are CUDA int32 (4, m) tensors with unit
    stride along a row on one device, m as the step needs; returns n."""
    if not isinstance(values, torch.Tensor):
        raise TypeError(f"fri fold: values are a {type(values).__name__}, not a tensor")
    if step.folds not in (0, 1, 2) or (step.circle and step.folds != 1):
        raise ValueError(f"fri fold: {step.folds} folds (circle {step.circle})")
    if not step.folds and inject_b is None:
        raise ValueError("fri fold: a step of no fold adds inject_b")
    if inject_a is not None and step.folds != 2:
        raise ValueError("fri fold: inject_a lands between two folds")
    m = values.shape[1] if values.dim() == 2 else 0
    n = m >> step.folds
    if n << max(step.folds, 1) > 1 << 32:
        raise ValueError(f"fri fold: {n} outputs of {step.folds} folds index past 32 bits")
    if n < 1 or n << step.folds != m or offset < 0 or (offset + n) << step.folds > 1 << step.level:
        raise ValueError(f"fri fold: values of shape {tuple(values.shape)} at offset {offset} "
                         f"of level {step.level}")
    for name, x, want in (("values", values, m), ("inject_a", inject_a, 4 * n),
                          ("inject_b", inject_b, 2 * n)):
        if x is None:
            continue
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"fri fold: {name} is a {type(x).__name__}, not a tensor")
        if x.dtype != torch.int32:
            raise TypeError(f"the fold kernel takes int32 arrays, {name} is {x.dtype}")
        if x.dim() != 2 or tuple(x.shape) != (4, want):
            raise ValueError(f"fri fold: {name} of shape {tuple(x.shape)}, expected (4, {want})")
        if x.stride(1) != 1:
            raise ValueError(f"fri fold: {name} has stride {x.stride(1)} along a row")
        if not x.is_cuda:
            raise ValueError(f"the fold kernel takes CUDA tensors, {name} is on {x.device}")
        if x.device != values.device:
            raise ValueError(f"fri fold: {name} on {x.device}, values on {values.device}")
    return n


def _betas(step: fri.FoldStep) -> np.ndarray:
    return np.array([int(v) % P_INT for b in (step.beta, step.beta2, step.beta0) for v in b],
                    np.uint32)


def _fold(a, b, itw, beta):
    """The fold on int64 (4, k) arrays and (k,) inverses, as the kernel's."""
    s = (a + b) % P_INT * fri._INV2 % P_INT
    d = (a - b) % P_INT * itw % P_INT
    return (s + qm31.mul(qm31.const(beta, a.device), d)) % P_INT


def emulate(values: torch.Tensor, step: fri.FoldStep, inject_a=None, inject_b=None,
            offset: int = 0) -> torch.Tensor:
    """What one launch computes, on the values' device, as the kernel
    schedules it: thread t0 < S = ceil(n / K) takes outputs t0 + i S (i <
    K; those at or past n are not live), reads each live output's twiddles
    at the step's table offsets (the doubled FFT twiddles reduced mod p),
    inverts the thread's K x T twiddles together (zero in, zero out; dead
    outputs read 0), then folds and injects. (4, n) int32."""
    dev = values.device
    n = values.shape[1] >> step.folds
    k = OUTPUTS_PER_THREAD
    s = -(-n // k)
    t = torch.arange(s, device=dev)[:, None] + torch.arange(k, device=dev)[None, :] * s  # (S, K)
    live = t < n
    tl = t.clamp(max=n - 1)
    reads = twiddle_reads(step, n, offset, inject_a is not None, inject_b is not None, dev)
    cols, names = [], []
    for use, (table, start, _) in reads.items():
        table = table.to(torch.int64) & 0xFFFFFFFF  # the doubled twiddles fill 32 bits
        width = pairs_per_output(step, use)
        for j in range(width):
            cols.append(torch.where(live, table[start + width * tl + j], 0))
            names.append((use, j))
    z = torch.stack(cols, -1)                                   # (S, K, T)
    z = torch.where(z >= P_INT, z - P_INT, z)
    z = batch_inv(z.reshape(s, -1)).reshape(z.shape)
    itw = {name: z[..., c][live] for c, name in enumerate(names)}  # (live outputs,)
    pos = tl[live]
    src = values.to(torch.int64)
    x = None
    if step.folds == 0:
        x = src[:, pos]
    elif step.folds == 1:
        x = _fold(src[:, 2 * pos], src[:, 2 * pos + 1], itw[("fold1", 0)], step.beta)
    else:
        u = [_fold(src[:, 4 * pos + 2 * j], src[:, 4 * pos + 2 * j + 1], itw[("fold1", j)],
                   step.beta) for j in range(2)]
        if inject_a is not None:
            a = inject_a.to(torch.int64)
            u = [(u[j] + _fold(a[:, 4 * pos + 2 * j], a[:, 4 * pos + 2 * j + 1],
                               itw[("inject_a", j)], step.beta0)) % P_INT for j in range(2)]
        x = _fold(u[0], u[1], itw[("fold2", 0)], step.beta2)
    if inject_b is not None:
        b = inject_b.to(torch.int64)
        x = (x + _fold(b[:, 2 * pos], b[:, 2 * pos + 1], itw[("inject_b", 0)], step.beta0)) % P_INT
    out = torch.zeros((4, n), dtype=torch.int64, device=dev)
    out[:, pos] = x
    return out.to(torch.int32)


class FoldKernel:
    """The built kernel library and its launch count."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("fri_fold", _bind)
        self.launches = 0

    def fold(self, values: torch.Tensor, step: fri.FoldStep, inject_a=None, inject_b=None,
             offset: int = 0) -> torch.Tensor:
        """(4, n) int32: fri.fold_step of CUDA arrays in one launch."""
        n = _check(values, step, inject_a, inject_b, offset)
        dev = values.device
        reads = twiddle_reads(step, n, offset, inject_a is not None, inject_b is not None, dev)
        ptrs = {}
        for use, (table, start, count) in reads.items():
            if table.dtype != torch.int32 or table.device != dev or start + count > table.numel():
                raise ValueError(f"fri fold: {use} reads {count} twiddles at {start} of a "
                                 f"{table.dtype} table of {table.numel()} on {table.device}")
            ptrs[use] = table.data_ptr() + 4 * start
        lib = self.lib.load()
        out = torch.empty((4, n), dtype=torch.int32, device=dev)
        betas = _betas(step)
        stride = lambda x: 0 if x is None else x.stride(0)  # noqa: E731
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        with torch.cuda.device(dev):
            rc = lib.fri_fold(step.folds, values.data_ptr(), values.stride(0),
                              ptr(inject_a), stride(inject_a), ptr(inject_b), stride(inject_b),
                              ptrs.get("fold1"), ptrs.get("inject_a"), ptrs.get("fold2"),
                              ptrs.get("inject_b"), betas.ctypes.data, n, out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fold kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


KERNEL = FoldKernel()
