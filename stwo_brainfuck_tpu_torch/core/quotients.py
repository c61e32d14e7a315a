"""OODS quotients: reduce "column f equals v at z" claims to a low-degree
test, batched per commitment-domain size for FRI.

For a committed M31 column f and a sampled value v = f(z) at the QM31 point z,
let zb = phi(z) (Frobenius conjugate; f(zb) = phi(v) for free since f has M31
coefficients). The line l through (z, v), (zb, phi(v)) and the pair-vanishing

    V(p) = (p.x - z.x)(zb.y - z.y) - (p.y - z.y)(zb.x - z.x)

(the line through z and zb, which cuts the circle exactly at {z, zb}) give the
quotient q(p) = (f(p) - l(p)) / V(p) — a polynomial iff v is correct. All
quotients of one commitment size are combined with powers of the channel
coefficient alpha; the per-size combinations feed FRI.

Counterpart of ``stwo_brainfuck_tpu/core/quotients.py``: the prover's
accumulation on a device (host-channel form) and the verifier's batched
host reconstruction (a copy). On a CUDA device a size's accumulation is one
launch of the quotient kernel (``ops/quotient_kernels.py``); on the CPU it
is the plain torch version, ``accumulate_groups``. This mirrors stwo's
quotient/pair-vanishing machinery (internal to its prover; entry at
brainfuck_air/mod.rs:732) with the QM31 Frobenius in place of stwo's CM31
complex conjugation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from . import qm31
from .circle import (M31_CIRCLE_LOG_ORDER, CanonicCoset, _gen_doublings, half_odds,
                     points_at_indices)
from .fft import bit_reverse_indices, coset_points
from .m31 import P_INT

# Calls of the plain accumulation on CUDA tensors. The prover never makes
# one (CUDA tensors go to the kernel); chip_smoke.py checks that.
PLAIN_CUDA_CALLS = 0


@dataclass
class QuotientClaim:
    """One (column, sample point) pair: the column's extended evaluation (for
    the prover) or its decommitted values (verifier), the point, the value."""

    point: tuple        # (x, y) host QM31 circle point
    value: tuple        # claimed f(z), host QM31
    alpha_index: int    # global batching power


@lru_cache(maxsize=32)
def domain_points_storage(log_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) of the canonic domain of size 2^log_size in bit-reversed
    storage order, int64 on `device` (cached): the natural order is
    [half_coset, -half_coset], the negation being the conjugate (x, -y)."""
    half = CanonicCoset(log_size).circle_domain().half_coset
    hx, hy = coset_points(half.initial_index, half.log_size, device)
    xs = torch.cat([hx, hx])
    ys = torch.cat([hy, (-hy) % P_INT])
    rev = bit_reverse_indices(log_size, device)
    return xs[rev], ys[rev]


def points_storage_range(log_size: int, offset: int, n: int, device) -> Tuple[torch.Tensor,
                                                                             torch.Tensor]:
    """(x, y) int64 of storage positions offset .. offset + n - 1 of the
    canonic domain of size 2^log_size on `device`, built from those
    positions alone (points_at_storage_batch's index arithmetic and
    points_at_indices' doubling ladder, in torch): a range's points for the
    plain version without the whole domain."""
    pos = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(pos)
    for b in range(log_size):
        rev |= ((pos >> b) & 1) << (log_size - 1 - b)
    half = 1 << (log_size - 1)
    hc = half_odds(log_size - 1)
    order = 1 << M31_CIRCLE_LOG_ORDER
    base = (hc.initial_index + torch.where(rev < half, rev, rev - half) * hc.step) % order
    idx = torch.where(rev < half, base, (order - base) % order)
    del pos, rev, base
    x = torch.ones_like(idx)
    y = torch.zeros_like(idx)
    for k, (dx, dy) in enumerate(_gen_doublings()):
        sel = ((idx >> k) & 1).bool()
        x, y = (torch.where(sel, (x * dx - y * dy) % P_INT, x),
                torch.where(sel, (x * dy + y * dx) % P_INT, y))
    return x, y


def points_at_storage_batch(log_size: int, positions) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) uint32 arrays of the canonic domain of size 2^log_size at
    many bit-reversed storage positions, without materializing the domain."""
    pos = np.asarray(positions, np.uint64)
    # bit-reverse each position (log_size bits)
    rev = np.zeros_like(pos)
    v = pos.copy()
    for _ in range(log_size):
        rev = (rev << np.uint64(1)) | (v & np.uint64(1))
        v >>= np.uint64(1)
    half = np.uint64(1 << (log_size - 1))
    hc = half_odds(log_size - 1)
    order = np.uint64(1 << M31_CIRCLE_LOG_ORDER)
    base = (np.uint64(hc.initial_index)
            + np.where(rev < half, rev, rev - half) * np.uint64(hc.step)) % order
    idx = np.where(rev < half, base, (order - base) % order)
    return points_at_indices(idx)


def _group_claims(claims: Sequence[Sequence[QuotientClaim]]) -> dict:
    """point -> [(column index, claim)] in claim order."""
    groups: dict = {}
    for ci, col_claims in enumerate(claims):
        for c in col_claims:
            key = (tuple(c.point[0]), tuple(c.point[1]))
            groups.setdefault(key, []).append((ci, c))
    return groups


def alpha_powers(by_point: dict, alpha: tuple) -> list:
    """alpha^0 .. alpha^k for the largest alpha_index k of the grouped
    claims (_group_claims): one h_mul a power."""
    n_pows = 1 + max((c.alpha_index for ms in by_point.values() for _ci, c in ms), default=0)
    powers = [qm31.ONE]
    for _ in range(n_pows - 1):
        powers.append(qm31.h_mul(powers[-1], alpha))
    return powers


def _group_constants(members, alpha: tuple, powers: list = None):
    """Host constants of one point group: (consts (5, 4) = [A, B, dy, dx, vc],
    weights (C_g, 4), member column indices). `powers` optionally carries the
    precomputed alpha-power ladder (one incremental h_mul per index instead
    of an h_pow per claim). The per-claim line coefficients are computed as
    one vectorized (4, C) batch — the group shares its point, so dy/dx/vc
    and the single QM31 inverse are computed once."""
    point = members[0][1].point
    zx, zy = point
    zbx, zby = qm31.h_frobenius(zx), qm31.h_frobenius(zy)
    dy = qm31.h_sub(zby, zy)
    dx = qm31.h_sub(zbx, zx)
    dy_inv = qm31.h_inv(dy)
    vc = qm31.h_sub(qm31.h_mul(zy, dx), qm31.h_mul(zx, dy))

    n = len(members)
    vals = np.array([c.value for _ci, c in members], np.uint64).T % P_INT
    aw = np.array(
        [(powers[c.alpha_index] if powers is not None
          else qm31.h_pow(alpha, c.alpha_index)) for _ci, c in members],
        np.uint64)                                            # (C, 4)
    vb = qm31.npq_frobenius(vals)
    s_arr = qm31.npq_mul(qm31.npq_sub(vb, vals), qm31.npq_const(dy_inv, n))
    l0 = qm31.npq_sub(vals, qm31.npq_mul(qm31.npq_const(zy, n), s_arr))
    aw_t = aw.T                                               # (4, C)
    a_const = qm31.npq_mul(aw_t, l0).sum(axis=1) % P_INT
    b_const = qm31.npq_mul(aw_t, s_arr).sum(axis=1) % P_INT

    consts = np.array([a_const, b_const,
                       np.array(dy, np.uint64), np.array(dx, np.uint64),
                       np.array(vc, np.uint64)], np.uint64).astype(np.uint32)
    idxs = tuple(ci for ci, _c in members)
    return consts, aw.astype(np.uint32), idxs


def _point_group_quotient(wf, consts, px, py):
    """inv_V(p) * (wf(p) - A - B*p.y) for one sample point: wf (4, N) the
    weighted column combination, consts (5, 4) = [A, B, dy, dx, vc]
    (host), px/py (N,) M31."""
    c = torch.as_tensor(consts.astype(np.int64), device=wf.device)[:, :, None]
    num = (wf - (c[0] + c[1] * py % P_INT)) % P_INT
    van = (c[2] * px % P_INT - c[3] * py % P_INT + c[4]) % P_INT
    return qm31.mul(num, qm31.inv(van))


def accumulate_quotients(
    log_size: int,
    columns: Sequence[torch.Tensor],
    claims: Sequence[Sequence[QuotientClaim]],
    alpha: tuple,
    ops=None,
) -> torch.Tensor:
    """Prover: combined quotient evaluation on the commitment domain
    2^log_size (QM31, (4, N) int32).

    Claims are grouped by sample point: all columns sampled at the same z
    share the pair-vanishing V and the line structure, so
        sum_k a^k (f_k - l_k)/V  =  (1/V) * (sum_k a^k f_k - A - B*p.y)
    with scalar A = sum a^k l0_k, B = sum a^k s_k. With `ops` (the mesh
    backend, parallel/prove.ShardedOps) the accumulation runs sharded."""
    with tracing.span("quotients.constants"):
        by_point = _group_claims(claims)
        powers = alpha_powers(by_point, alpha)
        groups = [_group_constants(members, alpha, powers) for members in by_point.values()]
    with tracing.span("quotients.launch"):
        if ops is not None:
            return ops.accumulate_all(log_size, columns, groups)
        return accumulate_range(log_size, columns, groups)


def accumulate_range(log_size: int, columns: Sequence[torch.Tensor], groups,
                     offset: int = 0) -> torch.Tensor:
    """The combined quotient at storage positions offset .. offset + n - 1
    of the domain 2^log_size ((4, n) int32; n the columns' length, a
    shard's chunk or the whole domain): on CUDA tensors one launch of the
    quotient kernel, on the CPU accumulate_groups at the cached domain
    points."""
    if columns[0].is_cuda:
        from ..ops import quotient_kernels

        return quotient_kernels.KERNEL.accumulate(log_size, columns, groups, offset)
    n = columns[0].shape[-1]
    px, py = domain_points_storage(log_size, columns[0].device)
    return accumulate_groups(columns, groups, px[offset:offset + n], py[offset:offset + n])


def accumulate_plain(log_size: int, columns: Sequence[torch.Tensor], groups,
                     offset: int = 0) -> torch.Tensor:
    """What the quotient kernel computes, on any device: accumulate_groups
    at the points of positions offset .. offset + n - 1 alone
    (points_storage_range), so that a large domain is checked range by
    range."""
    n = columns[0].shape[-1]
    return accumulate_groups(columns, groups,
                             *points_storage_range(log_size, offset, n, columns[0].device))


def accumulate_groups(columns: Sequence[torch.Tensor], groups, px: torch.Tensor,
                      py: torch.Tensor) -> torch.Tensor:
    """The plain version: the combined quotient at the domain points (px,
    py) (any run of them: a shard's chunk) from the columns' values there
    and the point groups' host constants (_group_constants). (4, n) int32."""
    global PLAIN_CUDA_CALLS
    dev = columns[0].device
    if dev.type == "cuda":
        PLAIN_CUDA_CALLS += 1
    acc = None
    for consts, weights, idxs in groups:
        w = torch.as_tensor(weights.astype(np.int64), device=dev)   # (C_g, 4)
        wf = torch.zeros((4, px.shape[0]), dtype=torch.int64, device=dev)
        for j, ci in enumerate(idxs):
            wf = (wf + w[j][:, None] * columns[ci].to(torch.int64)) % P_INT
        q = _point_group_quotient(wf, consts, px, py)
        acc = q if acc is None else (acc + q) % P_INT
    return acc.to(torch.int32)


def prepare_point_groups(claims: Sequence[Sequence[QuotientClaim]], alpha: tuple):
    """Verifier-side prep. Claims sampled at the same point share the
    vanishing line, so precompute once per point group: (A, B, dy, dx, vc, [(column index, alpha^k)]) with
    A = sum a^k l0_k, B = sum a^k s_k — exactly the prover's grouping
    (accumulate_quotients), so the verifier evaluates
        (sum a^k f_k - A - B*p.y) / V
    per group: one inverse per (group, position) instead of per claim."""
    groups = _group_claims(claims)
    powers = alpha_powers(groups, alpha)
    out = []
    for members in groups.values():
        consts, weights, idxs = _group_constants(members, alpha, powers)
        out.append((
            tuple(tuple(int(x) for x in c) for c in consts),
            [(ci, tuple(int(x) for x in w)) for ci, w in zip(idxs, weights)],
        ))
    return out


def quotient_values_batch(log_size: int, positions, column_values: np.ndarray,
                          prepared) -> dict:
    """Verifier: the combined quotient at many storage positions at once
    (vectorized host math). column_values: (C, n_pos) decommitted values in
    claim-column order at `positions`. Returns {position: QM31 tuple},
    the prover's accumulate_quotients value at each position."""
    positions = list(positions)
    n = len(positions)
    if n == 0:
        return {}
    xs, ys = points_at_storage_batch(log_size, positions)
    px = np.zeros((4, n), np.uint64)
    py = np.zeros((4, n), np.uint64)
    px[0] = xs
    py[0] = ys
    vals = np.asarray(column_values, np.uint64) % P_INT   # (C, n)
    acc = np.zeros((4, n), np.uint64)
    for consts_t, members in prepared:
        a_const, b_const, dy, dx, vc = (qm31.npq_const(c, n) for c in consts_t)
        aw = np.array([w for _ci, w in members], np.uint64)   # (C_g, 4)
        sel = vals[[ci for ci, _w in members]]                # (C_g, n)
        # sum_c aw[c] * f_c: per-coordinate products reduced mod p, then a
        # plain sum (C_g terms < 2^31 each — no u64 overflow below C ~ 2^33)
        wf = ((aw.T[:, :, None] * sel[None, :, :]) % P_INT).sum(axis=1) % P_INT
        num = qm31.npq_sub(wf, qm31.npq_add(a_const, qm31.npq_mul(b_const, py)))
        van = qm31.npq_add(
            qm31.npq_sub(qm31.npq_mul(dy, px), qm31.npq_mul(dx, py)), vc)
        acc = qm31.npq_add(acc, qm31.npq_mul(num, qm31.npq_inv(van)))
    return {p: tuple(int(acc[k, i]) for k in range(4))
            for i, p in enumerate(positions)}
