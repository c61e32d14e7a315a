"""Circle group over M31 and QM31: points, cosets, canonic circle domains.

Host-side equivalent of stwo's ``core::circle`` / ``core::poly::circle``
(used by every table builder, e.g.
crates/brainfuck_prover/src/components/memory/table.rs:16 and
crates/brainfuck_prover/src/brainfuck_air/mod.rs:480-484).

The circle C(M31) = {(x, y): x^2 + y^2 = 1} is cyclic of order 2^31 with
generator G = (2, 1268011823). A ``CirclePointIndex`` is an exponent
i ∈ Z/2^31; the subgroup of size 2^n is generated by index 2^(31-n).

Canonic domain of size 2^n ("standard position"): the odd multiples of
G_{n+1} = G^(2^(30-n)), i.e. indices ≡ 2^(30-n) (mod 2^(31-n)) together with
their negations. It is stored as half_coset ∪ -half_coset; evaluations are
kept in bit-reversed order so that positions 2m / 2m+1 hold f(p), f(-p).

Host-side module (python ints / numpy); device FFT lives in fft.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .m31 import P_INT
from . import qm31

M31_CIRCLE_LOG_ORDER = 31
M31_CIRCLE_GEN = (2, 1268011823)  # order 2^31 (verified in tests)


# ---------------------------------------------------------------------------
# M31 points (host scalar + vectorized numpy)
# ---------------------------------------------------------------------------

def point_add(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P_INT,
        (a[0] * b[1] + a[1] * b[0]) % P_INT,
    )


def point_neg(a):
    """Inverse in the group = conjugate (x, -y)."""
    return (a[0], (P_INT - a[1]) % P_INT)


def point_double(a):
    return point_add(a, a)


@lru_cache(maxsize=None)
def _gen_doublings():
    """[G, 2G, 4G, ... 2^30 G] as python-int tuples."""
    out = [M31_CIRCLE_GEN]
    for _ in range(M31_CIRCLE_LOG_ORDER - 1):
        out.append(point_double(out[-1]))
    return out


def point_at_index(index: int):
    """G^index (index mod 2^31)."""
    index %= 1 << M31_CIRCLE_LOG_ORDER
    acc = (1, 0)
    for k, dbl in enumerate(_gen_doublings()):
        if (index >> k) & 1:
            acc = point_add(acc, dbl)
    return acc


def points_at_indices(indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized G^indices -> (x, y) uint32 arrays (host, uint64 math)."""
    indices = np.asarray(indices, dtype=np.uint64)
    x = np.ones_like(indices)
    y = np.zeros_like(indices)
    for k, (dx, dy) in enumerate(_gen_doublings()):
        sel = ((indices >> np.uint64(k)) & np.uint64(1)).astype(bool)
        nx = (x * dx + (P_INT - dy) * y) % P_INT  # x*dx - y*dy
        ny = (x * dy + y * dx) % P_INT
        x = np.where(sel, nx, x)
        y = np.where(sel, ny, y)
    return x.astype(np.uint32), y.astype(np.uint32)


# ---------------------------------------------------------------------------
# Cosets and domains (index arithmetic)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Coset:
    """{G^(initial_index + k * step)} for k in [0, 2^log_size)."""

    initial_index: int
    log_size: int

    @property
    def step(self) -> int:
        return 1 << (M31_CIRCLE_LOG_ORDER - self.log_size)

    @property
    def size(self) -> int:
        return 1 << self.log_size

    def index_at(self, i: int) -> int:
        return (self.initial_index + i * self.step) % (1 << M31_CIRCLE_LOG_ORDER)

    def at(self, i: int):
        return point_at_index(self.index_at(i))

    def indices(self) -> np.ndarray:
        k = np.arange(self.size, dtype=np.uint64)
        return (np.uint64(self.initial_index) + k * np.uint64(self.step)) % np.uint64(
            1 << M31_CIRCLE_LOG_ORDER
        )

    def conjugate(self) -> "Coset":
        ini = (-self.initial_index) % (1 << M31_CIRCLE_LOG_ORDER)
        return Coset((ini - (self.size - 1) * self.step) % (1 << M31_CIRCLE_LOG_ORDER), self.log_size)


def half_odds(log_size: int) -> Coset:
    """Half-coset of the canonic circle domain of size 2^(log_size+1):
    indices q(1 + 4k) with q = 2^(29-log_size). Disjoint from its negation
    (which is q(3 + 4k)); their union is the full canonic coset of odd
    multiples of q."""
    return Coset(1 << (M31_CIRCLE_LOG_ORDER - (log_size + 2)), log_size)


@dataclass(frozen=True)
class CircleDomain:
    """half_coset ∪ -half_coset; natural order = [half, conjugated half]."""

    half_coset: Coset

    @property
    def log_size(self) -> int:
        return self.half_coset.log_size + 1

    @property
    def size(self) -> int:
        return 1 << self.log_size

    def index_at(self, i: int) -> int:
        half = self.half_coset.size
        if i < half:
            return self.half_coset.index_at(i)
        return (-self.half_coset.index_at(i - half)) % (1 << M31_CIRCLE_LOG_ORDER)

    def at(self, i: int):
        return point_at_index(self.index_at(i))

    def indices(self) -> np.ndarray:
        h = self.half_coset.indices()
        neg = (np.uint64(1 << M31_CIRCLE_LOG_ORDER) - h) % np.uint64(1 << M31_CIRCLE_LOG_ORDER)
        return np.concatenate([h, neg])

    def points(self) -> tuple[np.ndarray, np.ndarray]:
        return points_at_indices(self.indices())


@dataclass(frozen=True)
class CanonicCoset:
    """The canonic coset of size 2^log_size (odd multiples of G_{log_size+1});
    its circle_domain() is the standard evaluation domain of the same size."""

    log_size: int

    def coset(self) -> Coset:
        return Coset(1 << (M31_CIRCLE_LOG_ORDER - self.log_size - 1), self.log_size)

    def circle_domain(self) -> CircleDomain:
        return CircleDomain(half_odds(self.log_size - 1))

    def step_index(self) -> int:
        """Index of the subgroup generator of size 2^log_size (the step of
        the LogUp prefix-sum's shifted mask point)."""
        return 1 << (M31_CIRCLE_LOG_ORDER - self.log_size)


# ---------------------------------------------------------------------------
# QM31 ("secure field") points for out-of-domain sampling
# ---------------------------------------------------------------------------

def secure_point_add(a, b):
    ax, ay = a
    bx, by = b
    return (
        qm31.h_sub(qm31.h_mul(ax, bx), qm31.h_mul(ay, by)),
        qm31.h_add(qm31.h_mul(ax, by), qm31.h_mul(ay, bx)),
    )


def secure_point_neg(a):
    return (a[0], qm31.h_neg(a[1]))


def secure_point_double(a):
    return secure_point_add(a, a)


def secure_point_from_m31(p):
    return ((p[0], 0, 0, 0), (p[1], 0, 0, 0))


def secure_point_mul_index(index: int):
    """G^index embedded in the QM31 circle."""
    return secure_point_from_m31(point_at_index(index))


def point_from_t(t):
    """Rational parametrization (stwo CirclePoint::get_point /
    Channel::draw random point): t ∈ QM31 ->
    ((1-t^2)/(1+t^2), 2t/(1+t^2))."""
    t2 = qm31.h_mul(t, t)
    one = qm31.ONE
    denom_inv = qm31.h_inv(qm31.h_add(one, t2))
    x = qm31.h_mul(qm31.h_sub(one, t2), denom_inv)
    y = qm31.h_mul(qm31.h_add(t, t), denom_inv)
    return (x, y)
