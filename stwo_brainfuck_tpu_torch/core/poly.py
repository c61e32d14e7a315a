"""Polynomial utilities: out-of-domain evaluation and vanishing values.

Counterpart of ``stwo_brainfuck_tpu/core/poly.py``: the OODS samples of
committed coefficient rows (tensor-product basis split: the half bases on
the host for the plain version; the OODS kernel, ``ops/oods_kernels.py``,
builds each group's basis factors from its point on the card) and the
vanishing polynomial of a canonic domain, on the host and on a device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from . import qm31
from .circle import M31_CIRCLE_LOG_ORDER, point_at_index
from .m31 import P_INT
from .quotients import domain_points_storage

# Bound on the int64 elements of one (C, H, L) product chunk in
# sample_tensor (512 MB).
_SAMPLE_CHUNK = 1 << 26

# Plain sample_tensor calls on CUDA tensors (the OODS kernel is the only
# path there).
PLAIN_CUDA_CALLS = 0


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
    lo = log_size // 2. Returns host uint32 arrays (4, 2^lo), (4, 2^hi).
    Each doubling step is one vectorised QM31 product of the whole half
    built so far by the next factor (qm31.npq_mul), so a half costs
    log_size // 2 numpy products, not 2^lo host h_mul calls."""
    factors = _point_factors(log_size, point)
    lo = log_size // 2

    def build(fs):
        basis = np.zeros((4, 1), np.uint64)
        basis[0] = 1
        for f in fs:
            basis = np.concatenate([basis, qm31.npq_mul(basis, np.array(f, np.uint64)[:, None])],
                                   axis=1)
        return basis.astype(np.uint32)  # (4, 2^len(fs))

    return build(factors[:lo]), build(factors[lo:])


def sample_tensor(rows: Sequence[torch.Tensor], b_lo: np.ndarray,
                  b_hi: np.ndarray, offset: int = 0) -> torch.Tensor:
    """Evaluate C coefficient rows (each (N,) int32, N = 2^log) at one QM31
    point via the tensor-product basis split:
    out[:, c] = sum_hi b_hi * (sum_lo rows[c].(H, L) * b_lo). Exact mod p, so
    bit-identical to the direct basis dot. Returns (4, C) int64. The plain
    version of the OODS kernel (ops/oods_kernels.py).

    With `offset`, the rows are the coefficients [offset, offset + n) of
    longer rows (one shard's chunk, n and offset multiples of the same
    power of two) and the result is their part of the sum: the parts of
    all chunks add up mod p to the whole rows' values."""
    global PLAIN_CUDA_CALLS
    dev = rows[0].device
    PLAIN_CUDA_CALLS += dev.type == "cuda"
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


def sample_groups(groups: Sequence[tuple], shard: int = 0) -> torch.Tensor:
    """Every OODS group of a prove in one call: `groups` lists (log_size,
    point, rows), a (trace log, shift) group's coefficient rows and its
    QM31 point. Returns the (4, total rows) int32 samples, group after
    group, a row's column in the order given (air.sampling_plan order).

    A row may be None (its column is 0) or shorter than 2^log_size: then it
    is chunk `shard` of its row (coefficients shard * n .. (shard + 1) * n
    - 1) and its column is that chunk's part of the sum (sample_tensor's
    offset); the parts of all chunks add up mod p to the row's value.

    On CUDA rows this is one launch of the OODS kernel (a table of the rows'
    pointers and the groups' points in one small copy, the rows read in
    place, a row at two points read once); on CPU rows the plain version,
    sample_groups_plain."""
    first = next((r for _, _, rows in groups for r in rows if r is not None), None)
    if first is None:
        raise ValueError("sample_groups: no rows")
    if first.is_cuda:
        from ..ops import oods_kernels

        return oods_kernels.KERNEL.sample(groups, shard)
    return sample_groups_plain(groups, shard)


def sample_groups_plain(groups: Sequence[tuple], shard: int = 0) -> torch.Tensor:
    """The plain version of sample_groups on any device: sample_tensor, one
    call a group and row length. (4, total rows) int32."""
    live = [r for _, _, rows in groups for r in rows if r is not None]
    total = sum(len(rows) for _, _, rows in groups)
    out = torch.zeros((4, total), dtype=torch.int64, device=live[0].device)
    col = 0
    for log_size, point, rows in groups:
        b_lo, b_hi = half_bases_at_point(log_size, point)
        by_len: dict = {}
        for k, r in enumerate(rows):
            if r is not None:
                by_len.setdefault(int(r.shape[0]), []).append(k)
        for n, ks in by_len.items():
            offset = shard * n if n < 1 << log_size else 0
            vals = sample_tensor([rows[k] for k in ks], b_lo, b_hi, offset)
            out[:, [col + k for k in ks]] = vals
        col += len(rows)
    return out.to(torch.int32)


def vanishing_at_point(log_size: int, point) -> tuple:
    """V_n(z) for the canonic circle domain of size 2^log_size:
    pi^(log_size-1)(x(z)) (host QM31)."""
    x = point[0]
    for _ in range(log_size - 1):
        x = qm31.h_sub(qm31.h_mul(x, qm31.h_add(x, x)), qm31.ONE)
    return x


@lru_cache(maxsize=64)
def vanishing_inverse_blocks(log_size: int, log_blowup: int) -> Tuple[int, ...]:
    """V_log_size^-1 on the canonic domain of size 2^(log_size + log_blowup)
    in bit-reversed storage, as the 2^log_blowup values it takes (host
    ints): value h at storage positions h 2^log_size .. (h + 1) 2^log_size
    - 1. Position i holds the point G^(2^(30 - e) (1 + 4j)) or its
    conjugate, e = log_size + log_blowup, j = bitrev_e(i) mod 2^(e - 1);
    log_size - 1 doublings take it to G^(2^(29 - log_blowup) (1 + 4j)),
    which depends on j mod 2^log_blowup alone: the top log_blowup bits of i."""
    e = log_size + log_blowup
    out = []
    for h in range(1 << log_blowup):
        j = int(f"{h << log_size:0{e}b}"[::-1], 2) % (1 << (e - 1))
        x = point_at_index((1 + 4 * j) << (M31_CIRCLE_LOG_ORDER - 1 - e))[0]
        for _ in range(log_size - 1):
            x = (2 * x * x - 1) % P_INT
        out.append(pow(x, P_INT - 2, P_INT))
    return tuple(out)


def vanishing_on_domain(log_size: int, eval_log_size: int, device) -> torch.Tensor:
    """V_{log_size} on the canonic domain of size 2^eval_log_size
    (bit-reversed storage), int64 on `device`. Nonzero everywhere
    (canonic domains of different sizes are disjoint)."""
    x, _ = domain_points_storage(eval_log_size, device)
    for _ in range(log_size - 1):
        x = (2 * (x * x % P_INT) + P_INT - 1) % P_INT
    return x
