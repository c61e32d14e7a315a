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

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Sequence, Tuple

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


def alpha_ladder(alpha: tuple, n: int) -> np.ndarray:
    """alpha^0 .. alpha^(n - 1) as a (4, n) uint64 array: alpha^r for r < m
    and alpha^(m j) for j < ceil(n / m), m = ceil(sqrt(n)), one h_mul each,
    and alpha^(m j + r) their products in one npq_mul. Counted in
    `quotients.powers`."""
    tracing.count("quotients.powers", n)
    m = math.isqrt(n - 1) + 1 if n else 1
    lo = [qm31.ONE]
    for _ in range(m):
        lo.append(qm31.h_mul(lo[-1], alpha))
    hi = [qm31.ONE]
    for _ in range(-(-n // m) - 1):
        hi.append(qm31.h_mul(hi[-1], lo[m]))
    lo_t, hi_t = np.array(lo[:m], np.uint64).T, np.array(hi, np.uint64).T
    return qm31.npq_mul(np.repeat(hi_t, m, axis=1), np.tile(lo_t, (1, len(hi))))[:, :n]


def point_groups(claims_by_size: Dict[int, Sequence[Sequence[QuotientClaim]]],
                 alpha: tuple) -> Dict[int, list]:
    """Every size's point groups in one vectorised pass: for each size the
    list [(consts (5, 4) = [A, B, dy, dx, vc], weights (C_g, 4), member
    column indices), ...] (uint32), a group a distinct sample point of that
    size's claims in order of first appearance, its members in claim
    order. claims_by_size: size -> one claim list a column. One alpha
    ladder serves every size; dy, dx, vc and the inverse of dy are computed
    once a distinct point, the line coefficients s, l0 once a claim, and
    A = sum a^k l0_k, B = sum a^k s_k reduced a group."""
    points: dict = {}    # point -> its index among the distinct points
    keys: dict = {}      # (size, point index) -> group index
    first = {}           # size -> its first group index
    gid, pid, col, vals, aidx = [], [], [], [], []
    for size, claims in claims_by_size.items():
        first[size] = len(keys)
        for ci, col_claims in enumerate(claims):
            for c in col_claims:
                p = points.setdefault((tuple(c.point[0]), tuple(c.point[1])), len(points))
                gid.append(keys.setdefault((size, p), len(keys)))
                pid.append(p)
                col.append(ci)
                vals.append(c.value)
                aidx.append(c.alpha_index)
    if not vals:
        return {size: [] for size in claims_by_size}
    z = np.array(list(points), np.uint64) % P_INT                 # (P, 2, 4)
    zx, zy = z[:, 0].T, z[:, 1].T                                 # (4, P)
    dy = qm31.npq_sub(qm31.npq_frobenius(zy), zy)
    dx = qm31.npq_sub(qm31.npq_frobenius(zx), zx)
    vc = qm31.npq_sub(qm31.npq_mul(zy, dx), qm31.npq_mul(zx, dy))
    dy_inv = np.array([qm31.h_inv(tuple(d)) for d in dy.T.tolist()], np.uint64).T
    pid = np.array(pid)
    v = np.array(vals, np.uint64).T % P_INT                       # (4, n)
    s = qm31.npq_mul(qm31.npq_sub(qm31.npq_frobenius(v), v), dy_inv[:, pid])
    l0 = qm31.npq_sub(v, qm31.npq_mul(zy[:, pid], s))
    aw = alpha_ladder(alpha, max(aidx) + 1)[:, aidx]              # (4, n)
    # the claims by group, in claim order inside each: a group's members
    # are a contiguous run, and each run's a^k l0_k and a^k s_k one reduceat
    order = np.argsort(np.array(gid), kind="stable")
    runs = np.flatnonzero(np.diff(np.array(gid)[order], prepend=-1))
    terms = qm31.npq_mul(aw[:, None], np.stack([l0, s], 1))[:, :, order]   # (4, 2, n)
    ab = np.add.reduceat(terms, runs, axis=2) % P_INT                       # (4, 2, G)
    gp = [p for _size, p in keys]                                 # each group's point
    consts = np.ascontiguousarray(
        np.stack([ab[:, 0], ab[:, 1], dy[:, gp], dx[:, gp], vc[:, gp]]).transpose(2, 0, 1),
        np.uint32)
    weights = np.split(np.ascontiguousarray(aw[:, order].T, np.uint32), runs[1:])
    idxs = np.split(np.array(col)[order], runs[1:])
    groups = [(consts[g], weights[g], tuple(idxs[g].tolist())) for g in range(len(keys))]
    ends = list(first.values())[1:] + [len(keys)]
    return {size: groups[a:b] for (size, a), b in zip(first.items(), ends)}


def _point_group_quotient(wf, consts, px, py):
    """inv_V(p) * (wf(p) - A - B*p.y) for one sample point: wf (4, N) the
    weighted column combination, consts (5, 4) = [A, B, dy, dx, vc]
    (host), px/py (N,) M31."""
    c = torch.as_tensor(consts.astype(np.int64), device=wf.device)[:, :, None]
    num = (wf - (c[0] + c[1] * py % P_INT)) % P_INT
    van = (c[2] * px % P_INT - c[3] * py % P_INT + c[4]) % P_INT
    return qm31.mul(num, qm31.inv(van))


def accumulate_quotients(
    inputs: Dict[int, Tuple[Sequence[torch.Tensor], Sequence[Sequence[QuotientClaim]]]],
    alpha: tuple,
    ops=None,
) -> Dict[int, torch.Tensor]:
    """Prover: the combined quotient evaluation of every commitment size,
    size -> (4, 2^size) int32, from size -> (columns, one claim list a
    column).

    Claims are grouped by sample point: all columns sampled at the same z
    share the pair-vanishing V and the line structure, so
        sum_k a^k (f_k - l_k)/V  =  (1/V) * (sum_k a^k f_k - A - B*p.y)
    with scalar A = sum a^k l0_k, B = sum a^k s_k. Every size's constants
    come from one pass (point_groups); then the sizes are launched back to
    back, the largest first, so that its kernel runs while the host issues
    the others. With `ops` (the mesh backend, parallel/prove.ShardedOps)
    the accumulation runs sharded."""
    with tracing.span("quotients.constants"):
        groups = point_groups({size: claims for size, (_cols, claims) in inputs.items()}, alpha)
    with tracing.span("quotients.launch"):
        launch = accumulate_range if ops is None else ops.accumulate_all
        return {size: launch(size, inputs[size][0], groups[size])
                for size in sorted(inputs, reverse=True)}


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
    and the point groups' host constants (point_groups). (4, n) int32."""
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


def verifier_groups(groups) -> list:
    """A size's point groups (point_groups) as the verifier keeps them:
    [((A, B, dy, dx, vc), [(column index, alpha^k)]), ...] in host QM31
    tuples."""
    return [(tuple(tuple(int(x) for x in c) for c in consts),
             [(ci, tuple(int(x) for x in w)) for ci, w in zip(idxs, weights)])
            for consts, weights, idxs in groups]


def prepare_point_groups(claims: Sequence[Sequence[QuotientClaim]], alpha: tuple):
    """Verifier-side prep of one size. Claims sampled at the same point
    share the vanishing line, so precompute once per point group: (A, B,
    dy, dx, vc, [(column index, alpha^k)]) with A = sum a^k l0_k, B = sum
    a^k s_k — exactly the prover's grouping (point_groups), so the verifier
    evaluates
        (sum a^k f_k - A - B*p.y) / V
    per group: one inverse per (group, position) instead of per claim."""
    return verifier_groups(point_groups({0: claims}, alpha)[0])


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
