"""Polynomial utilities: out-of-domain evaluation and vanishing values.

Counterpart of ``stwo_brainfuck_tpu/core/poly.py``: the OODS samples of
committed coefficient rows (tensor-product basis split, host half-bases)
and the vanishing polynomial of a canonic domain, on the host and on a
device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import qm31
from .m31 import P_INT
from .quotients import domain_points_storage

# Bound on the int64 elements of one (C, H, L) product chunk in
# sample_tensor (512 MB).
_SAMPLE_CHUNK = 1 << 26


def _point_factors(log_size: int, point) -> list:
    """Host: the per-bit basis factors [y, x, pi(x), ...] at a QM31 point
    (list of QM31 tuples; bit k of a basis index selects factors[k])."""
    x, y = point
    factors = [y]
    cur = x
    for _ in range(log_size - 1):
        factors.append(cur)
        cur = qm31.h_sub(qm31.h_mul(cur, qm31.h_add(cur, cur)), qm31.ONE)  # 2c^2-1
    return factors


def half_bases_at_point(log_size: int, point) -> Tuple[np.ndarray, np.ndarray]:
    """Tensor-product split of the circle-FFT basis at a QM31 point.

    basis_j(point) = y^{j0} x^{j1} pi(x)^{j2} ... is a product basis, so it
    factors exactly: basis[j] = b_lo[j % 2^lo] * b_hi[j >> lo] with
    lo = log_size // 2. Returns host uint32 arrays (4, 2^lo), (4, 2^hi):
    at most 2^12 host h_mul calls, so the device work per group is two
    small modular contractions (sample_tensor)."""
    factors = _point_factors(log_size, point)
    lo = log_size // 2

    def build(fs):
        basis = [qm31.ONE]
        for f in fs:
            basis += [qm31.h_mul(b, f) for b in basis]
        return np.array(basis, np.uint32).T.copy()  # (4, 2^len(fs))

    return build(factors[:lo]), build(factors[lo:])


def sample_tensor(rows: Sequence[torch.Tensor], b_lo: np.ndarray,
                  b_hi: np.ndarray, offset: int = 0) -> torch.Tensor:
    """Evaluate C coefficient rows (each (N,) int32, N = 2^log) at one QM31
    point via the tensor-product basis split:
    out[:, c] = sum_hi b_hi * (sum_lo rows[c].(H, L) * b_lo). Exact mod p, so
    bit-identical to the direct basis dot. Returns (4, C) int64.

    With `offset`, the rows are the coefficients [offset, offset + n) of
    longer rows (one shard's chunk, n and offset multiples of the same
    power of two) and the result is their part of the sum: the parts of
    all chunks add up mod p to the whole rows' values."""
    dev = rows[0].device
    n = rows[0].shape[0]
    big_l = b_lo.shape[1]
    w = min(n, big_l)                                            # lo terms a row of m3 takes
    lo = torch.as_tensor(b_lo[:, offset % big_l:][:, :w].astype(np.int64), device=dev)
    hi = torch.as_tensor(b_hi[:, offset // big_l:][:, :max(1, n // big_l)].astype(np.int64),
                         device=dev)
    step = max(1, _SAMPLE_CHUNK // n)
    outs = []
    for c0 in range(0, len(rows), step):
        mat = torch.stack(list(rows[c0:c0 + step])).to(torch.int64)
        m3 = mat.reshape(mat.shape[0], -1, w)                    # (C, H, L)
        t = torch.stack([(m3 * lo[k] % P_INT).sum(-1) % P_INT for k in range(4)])
        outs.append(qm31.mul(t, hi[:, None, :]).sum(-1) % P_INT)  # (4, C)
    return torch.cat(outs, dim=1)


def vanishing_at_point(log_size: int, point) -> tuple:
    """V_n(z) for the canonic circle domain of size 2^log_size:
    pi^(log_size-1)(x(z)) (host QM31)."""
    x = point[0]
    for _ in range(log_size - 1):
        x = qm31.h_sub(qm31.h_mul(x, qm31.h_add(x, x)), qm31.ONE)
    return x


def vanishing_on_domain(log_size: int, eval_log_size: int, device) -> torch.Tensor:
    """V_{log_size} on the canonic domain of size 2^eval_log_size
    (bit-reversed storage), int64 on `device`. Nonzero everywhere
    (canonic domains of different sizes are disjoint)."""
    x, _ = domain_points_storage(eval_log_size, device)
    for _ in range(log_size - 1):
        x = (2 * (x * x % P_INT) + P_INT - 1) % P_INT
    return x
