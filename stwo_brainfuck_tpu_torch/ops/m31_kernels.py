"""Elementwise M31 kernels: the hand-written Hopper kernels
(``csrc/m31_kernels.cu``) behind ``mul``, ``mul_add`` and ``mul_chain``, and
the M31 multiply throughput measurement.

Counterpart of ``stwo_brainfuck_tpu/ops/m31_pallas.py``; the kernels replace
its Pallas kernels ``_mul_kernel``, ``_mul_add_kernel`` and
``_mul_chain_kernel`` and compute the same functions bit for bit. They are
bound by device-memory bandwidth (12 bytes per element for ``mul`` and
``mul_chain``, 16 for ``mul_add``); see the source's note.

Each public function takes int32 tensors holding canonical M31 values and
returns one. A CPU tensor goes to the plain version beside it
(``mul_plain`` etc., ``core/m31`` arithmetic); a CUDA tensor launches the
kernel or raises. Shapes broadcast as in torch, and the kernel takes the
broadcast inputs made contiguous: no shape sends a CUDA tensor to the plain
version. ``emulate`` replays the kernel's per-element arithmetic (32-bit
product halves, fold, conditional subtract) on int64 tensors, so the CPU
tests check the reduction.

The library is built with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import m31
from . import nvcc

P = m31.P_INT
KINDS = ("mul", "mul_add", "mul_chain")
CHAIN = 8  # the chain length of throughput_benchmark (unrolled in the kernel)

# Calls of the plain versions on CUDA tensors. The public functions never
# make one (CUDA tensors go to the kernels); chip_smoke.py checks that.
PLAIN_CUDA_CALLS = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, n, stream = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p
    lib.m31_mul.argtypes = [ptr, ptr, ptr, n, stream]
    lib.m31_mul_add.argtypes = [ptr, ptr, ptr, ptr, n, stream]
    lib.m31_mul_chain.argtypes = [ptr, ptr, ptr, n, ctypes.c_int, stream]
    for fn in (lib.m31_mul, lib.m31_mul_add, lib.m31_mul_chain):
        fn.restype = ctypes.c_int


class M31Kernels:
    """The built kernel library and one launch count per kernel."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("m31_kernels", _bind)
        self.launches = dict.fromkeys(KINDS, 0)

    def run(self, kind: str, *xs: torch.Tensor, chain: int = CHAIN) -> torch.Tensor:
        """One launch of `kind` on CUDA int32 tensors (broadcast first)."""
        dev = _device_of(xs)
        if dev.type != "cuda":
            raise ValueError(f"the M31 kernels take CUDA tensors, got {dev}")
        xs = [_aligned(x.contiguous()) for x in torch.broadcast_tensors(*xs)]
        out = torch.empty_like(xs[0], memory_format=torch.contiguous_format)
        n = out.numel()
        if n == 0:
            return out
        lib = self.lib.load()
        ptrs = [x.data_ptr() for x in xs]
        with torch.cuda.device(dev):  # the card's default stream is the current device's
            stream = torch.cuda.current_stream(dev).cuda_stream
            if kind == "mul":
                rc = lib.m31_mul(*ptrs, out.data_ptr(), n, stream)
            elif kind == "mul_add":
                rc = lib.m31_mul_add(*ptrs, out.data_ptr(), n, stream)
            else:
                rc = lib.m31_mul_chain(*ptrs, out.data_ptr(), n, chain, stream)
        if rc != 0:
            raise RuntimeError(f"M31 {kind} launch failed: CUDA error {rc}")
        self.launches[kind] += 1
        return out


KERNELS = M31Kernels()


def _device_of(xs) -> torch.device:
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
            raise TypeError("the M31 kernels take int32 tensors of canonical values, got "
                            f"{type(x).__name__ if not isinstance(x, torch.Tensor) else x.dtype}")
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"M31 operands on several devices: {sorted(map(str, devs))}")
    return devs.pop()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a fresh copy when its data does not start on 16 bytes (a view
    at an offset): the kernel loads 16-byte vectors."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _dispatch(kind: str, plain, xs, **kw) -> torch.Tensor:
    dev = _device_of(xs)
    if dev.type == "cpu":
        return plain(*xs, **kw)
    if dev.type != "cuda":
        raise ValueError(f"M31 {kind}: unsupported device {dev}")
    return KERNELS.run(kind, *xs, **kw)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise M31 product a*b."""
    return _dispatch("mul", mul_plain, (a, b))


def mul_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c mod p, fused."""
    return _dispatch("mul_add", mul_add_plain, (a, b, c))


def mul_chain(a: torch.Tensor, b: torch.Tensor, chain: int = CHAIN) -> torch.Tensor:
    """((a*b)*b)*... `chain` times, in registers."""
    if chain < 0:
        raise ValueError(f"mul_chain: chain must be >= 0, got {chain}")
    return _dispatch("mul_chain", mul_chain_plain, (a, b), chain=chain)


# ---------------------------------------------------------------------------
# Plain versions (core/m31 arithmetic in int64; the kernels' reference)
# ---------------------------------------------------------------------------

def _note_plain_call(x: torch.Tensor) -> None:
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _note_plain_call(a)
    return m31.mul(a, b).to(torch.int32)


def mul_add_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    _note_plain_call(a)
    return m31.add(m31.mul(a, b), c).to(torch.int32)


def mul_chain_plain(a: torch.Tensor, b: torch.Tensor, chain: int = CHAIN) -> torch.Tensor:
    _note_plain_call(a)
    x = a
    for _ in range(chain):
        x = m31.mul(x, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return x.to(torch.int32).broadcast_to(shape).contiguous()


def emulate(kind: str, a: torch.Tensor, b: torch.Tensor, c=None,
            chain: int = CHAIN) -> torch.Tensor:
    """The kernels' per-element arithmetic (csrc/m31.cuh) on int64 tensors:
    the 64-bit product's 32-bit halves, the Mersenne fold of x >> 31 and
    lo & p, and the conditional subtract min(r, (r - p) mod 2^32)."""
    mask = (1 << 32) - 1

    def reduce_once(r):
        return torch.minimum(r, (r - P) & mask)

    def mul_(x, y):
        prod = x * y                      # < 2^62: exact in int64
        lo, hi = prod & mask, prod >> 32
        return reduce_once((lo & P) + (((hi << 1) & mask) | (lo >> 31)))

    a, b = m31.wide(a), m31.wide(b)
    if kind == "mul":
        return mul_(a, b)
    if kind == "mul_add":
        return reduce_once(mul_(a, b) + m31.wide(c))
    if kind == "mul_chain":
        x = a
        for _ in range(chain):
            x = mul_(x, b)
        return x
    raise ValueError(f"unknown M31 kernel {kind!r}")


# ---------------------------------------------------------------------------
# Throughput measurement
# ---------------------------------------------------------------------------

def _elapsed_s(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def throughput_benchmark(log_n: int = 24, k_lo: int = 64, k_hi: int = 256) -> dict:
    """Sustained M31 multiply throughput (mul/s) of the chain kernel and of
    its plain version on the card, as the JAX package measures it:
    chain * (k_hi - k_lo) * n / (t(k_hi) - t(k_lo)), where t(k) is the best
    of 3 runs of k back-to-back chain-of-8 steps on 2^log_n elements, timed
    with CUDA events. The slope cancels the fixed cost of a run.

    Also returns how many kernel launches and plain calls it made
    (``kernel_launches``, ``plain_calls``). Raises without a CUDA device: it
    never reports a CPU number."""
    if not torch.cuda.is_available():
        raise RuntimeError("the M31 throughput benchmark needs a CUDA device")
    n = 1 << log_n
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.integers(0, P, n, dtype=np.uint32).astype(np.int32), device="cuda")
    b = torch.as_tensor(rng.integers(0, P, n, dtype=np.uint32).astype(np.int32), device="cuda")
    bodies = {"kernel": lambda x: mul_chain(x, b, CHAIN),
              "plain": lambda x: mul_chain_plain(x, b, CHAIN)}
    calls = dict.fromkeys(bodies, 0)
    out = {}
    for name, body in bodies.items():
        def run(k, body=body, name=name):
            x = a
            for _ in range(k):
                x = body(x)
            calls[name] += k

        times = {}
        for k in (k_lo, k_hi):
            run(k)  # warm
            times[k] = min(_elapsed_s(lambda k=k: run(k)) for _ in range(3))
        out[name] = CHAIN * (k_hi - k_lo) * n / (times[k_hi] - times[k_lo])
    out["kernel_launches"] = calls["kernel"]
    out["plain_calls"] = calls["plain"]
    return out
