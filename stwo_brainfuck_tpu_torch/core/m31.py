"""M31 (Mersenne-31, p = 2^31 - 1) field arithmetic on torch tensors.

Counterpart of ``stwo_brainfuck_tpu/core/m31.py``. Field elements are stored
as ``int32`` tensors (canonical values < p fit) and computed in ``int64``:
a product of two canonical values is < 2^62, so ``(a * b) % p`` is exact and
no limb split is needed. Every device op accepts int32 or int64 tensors (or
Python ints) and returns a canonical int64 tensor; callers narrow to int32
with ``.to(torch.int32)`` where a value is kept.

The host mirrors (``np_*``) are copies of the JAX package's numpy versions.
"""

from __future__ import annotations

import numpy as np
import torch

P_INT = 2**31 - 1
P = P_INT


def wide(x):
    """int64 view of a field tensor (Python ints pass through)."""
    if isinstance(x, torch.Tensor) and x.dtype != torch.int64:
        return x.to(torch.int64)
    return x


def add(a, b):
    return (wide(a) + wide(b)) % P


def sub(a, b):
    return (wide(a) - wide(b)) % P


def neg(a):
    return (-wide(a)) % P


def mul(a, b):
    return (wide(a) * wide(b)) % P


def square(a):
    return mul(a, a)


def pow_const_sq(a, n: int):
    """a^(2^n): n repeated squarings."""
    for _ in range(n):
        a = square(a)
    return a


def inv(a):
    """a^(p-2) = a^-1, with 0 mapping to 0 (the VM's mvi convention).
    Same addition chain as the JAX package (p - 2 = (2^29 - 1)·4 + 1)."""
    x1 = wide(a)
    x2 = mul(pow_const_sq(x1, 1), x1)
    x4 = mul(pow_const_sq(x2, 2), x2)
    x5 = mul(pow_const_sq(x4, 1), x1)
    x10 = mul(pow_const_sq(x5, 5), x5)
    x20 = mul(pow_const_sq(x10, 10), x10)
    x29 = mul(pow_const_sq(x20, 9), mul(pow_const_sq(x5, 4), x4))
    return mul(pow_const_sq(x29, 2), x1)


# ---------------------------------------------------------------------------
# Host-side (numpy, uint64) mirrors: used by the VM, table builders, the
# verifier and tests.
# ---------------------------------------------------------------------------

def np_add(a, b):
    return ((np.asarray(a, np.uint64) + np.asarray(b, np.uint64)) % np.uint64(P_INT)).astype(np.uint32)


def np_sub(a, b):
    return ((np.asarray(a, np.uint64) + np.uint64(P_INT) - np.asarray(b, np.uint64)) % np.uint64(P_INT)).astype(np.uint32)


def np_mul(a, b):
    return ((np.asarray(a, np.uint64) * np.asarray(b, np.uint64)) % np.uint64(P_INT)).astype(np.uint32)


def np_inv(a):
    """Elementwise inverse on host via Fermat's little theorem (0 -> 0)."""
    a = np.asarray(a, np.uint64)
    result = np.ones_like(a)
    base = a.copy()
    e = P_INT - 2
    while e:
        if e & 1:
            result = (result * base) % P_INT
        base = (base * base) % P_INT
        e >>= 1
    return np.where(a == 0, 0, result).astype(np.uint32)
