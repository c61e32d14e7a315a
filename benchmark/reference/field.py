"""M31, QM31 and circle-group arithmetic on the host (Python ints and numpy).

A frozen copy of the host halves of the port's core/m31.py, core/qm31.py and
core/circle.py, kept here so that the reference shares no code with the
program it judges.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

P_INT = 2**31 - 1


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


# QM31 host values: tuples (a, b, c, d) of Python ints < P.

def h_add(x, y):
    return tuple((a + b) % P_INT for a, b in zip(x, y))


def h_neg(x):
    return tuple((P_INT - a) % P_INT for a in x)


def h_sub(x, y):
    return h_add(x, h_neg(y))


def _h_cm_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P_INT, (a[0] * b[1] + a[1] * b[0]) % P_INT)


def h_mul(x, y):
    A, B = (x[0], x[1]), (x[2], x[3])
    C, D = (y[0], y[1]), (y[2], y[3])
    ac = _h_cm_mul(A, C)
    bd = _h_cm_mul(B, D)
    ad = _h_cm_mul(A, D)
    bc = _h_cm_mul(B, C)
    rbd = ((2 * bd[0] - bd[1]) % P_INT, (bd[0] + 2 * bd[1]) % P_INT)
    return ((ac[0] + rbd[0]) % P_INT, (ac[1] + rbd[1]) % P_INT,
            (ad[0] + bc[0]) % P_INT, (ad[1] + bc[1]) % P_INT)


def _h_cm_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % P_INT
    ni = pow(norm, P_INT - 2, P_INT)
    return ((a[0] * ni) % P_INT, ((P_INT - a[1]) * ni) % P_INT)


def h_inv(x):
    A, B = (x[0], x[1]), (x[2], x[3])
    a2 = _h_cm_mul(A, A)
    b2 = _h_cm_mul(B, B)
    rb2 = ((2 * b2[0] - b2[1]) % P_INT, (b2[0] + 2 * b2[1]) % P_INT)
    den = ((a2[0] - rb2[0]) % P_INT, (a2[1] - rb2[1]) % P_INT)
    di = _h_cm_inv(den)
    o01 = _h_cm_mul(A, di)
    o23 = _h_cm_mul(((P_INT - B[0]) % P_INT, (P_INT - B[1]) % P_INT), di)
    return (o01[0], o01[1], o23[0], o23[1])


def h_pow(x, e: int):
    result = (1, 0, 0, 0)
    base = x
    while e > 0:
        if e & 1:
            result = h_mul(result, base)
        base = h_mul(base, base)
        e >>= 1
    return result


ZERO = (0, 0, 0, 0)
ONE = (1, 0, 0, 0)

# Vectorized host QM31 arrays: shape (4, n) np.uint64, canonical < P.


def npq_add(x, y):
    return (x + y) % P_INT


def npq_sub(x, y):
    return (x + (P_INT - y)) % P_INT


def _npq_cm_mul(ar, ai, br, bi):
    rr = (ar * br + (P_INT - ai % P_INT) * (bi % P_INT)) % P_INT
    ri = (ar * bi + ai * br) % P_INT
    return rr, ri


def npq_mul(x, y):
    ac_r, ac_i = _npq_cm_mul(x[0], x[1], y[0], y[1])
    bd_r, bd_i = _npq_cm_mul(x[2], x[3], y[2], y[3])
    ad_r, ad_i = _npq_cm_mul(x[0], x[1], y[2], y[3])
    bc_r, bc_i = _npq_cm_mul(x[2], x[3], y[0], y[1])
    rbd_r = (2 * bd_r + (P_INT - bd_i)) % P_INT
    rbd_i = (bd_r + 2 * bd_i) % P_INT
    return np.stack([(ac_r + rbd_r) % P_INT, (ac_i + rbd_i) % P_INT,
                     (ad_r + bc_r) % P_INT, (ad_i + bc_i) % P_INT])


def _npq_cm_inv(ar, ai):
    norm = (ar * ar + ai * ai) % P_INT
    ni = np_inv(norm).astype(np.uint64)
    return (ar * ni) % P_INT, ((P_INT - ai) * ni) % P_INT


def npq_inv(x):
    a2_r, a2_i = _npq_cm_mul(x[0], x[1], x[0], x[1])
    b2_r, b2_i = _npq_cm_mul(x[2], x[3], x[2], x[3])
    rb2_r = (2 * b2_r + (P_INT - b2_i)) % P_INT
    rb2_i = (b2_r + 2 * b2_i) % P_INT
    den_r = (a2_r + (P_INT - rb2_r)) % P_INT
    den_i = (a2_i + (P_INT - rb2_i)) % P_INT
    di_r, di_i = _npq_cm_inv(den_r, den_i)
    o0, o1 = _npq_cm_mul(x[0], x[1], di_r, di_i)
    o2, o3 = _npq_cm_mul((P_INT - x[2]) % P_INT, (P_INT - x[3]) % P_INT,
                         di_r, di_i)
    return np.stack([o0, o1, o2, o3])


def npq_const(v, n: int):
    """Broadcast a host QM31 tuple to a (4, n) uint64 array."""
    return np.broadcast_to(
        np.array(v, np.uint64)[:, None], (4, n)).copy()



def h_recombine(coords):
    """Reassemble a QM31 value from the QM31-valued samples of its 4 M31
    coordinate polynomials: v = c0 + c1*i + c2*u + c3*iu."""
    i = (0, 1, 0, 0)
    u = (0, 0, 1, 0)
    iu = (0, 0, 0, 1)
    out = coords[0]
    out = h_add(out, h_mul(coords[1], i))
    out = h_add(out, h_mul(coords[2], u))
    out = h_add(out, h_mul(coords[3], iu))
    return out


def _compute_frobenius_c():
    """c = (2+i)^((p-1)/2) in CM31: the twist factor of the Frobenius map
    phi(a + b u) = conj(a) + conj(b) * c * u (since phi(i) = -i and
    phi(u) = u^p = (u^2)^((p-1)/2) u = c u)."""
    base = (2, 1)
    e = (P_INT - 1) // 2
    result = (1, 0)
    while e:
        if e & 1:
            result = _h_cm_mul(result, base)
        base = _h_cm_mul(base, base)
        e >>= 1
    return result


_FROB_C = _compute_frobenius_c()


def h_frobenius(x):
    """phi(x) = x^p — the generator of Gal(QM31/M31). For a polynomial f with
    M31 coefficients: f(phi(z)) = phi(f(z)), which gives the second
    (conjugate) sample point of each OODS quotient for free."""
    a_conj = (x[0], (P_INT - x[1]) % P_INT)
    b_conj = (x[2], (P_INT - x[3]) % P_INT)
    bc = _h_cm_mul(b_conj, _FROB_C)
    return (a_conj[0], a_conj[1], bc[0], bc[1])


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

    def index_at(self, i: int) -> int:
        return (self.initial_index + i * self.step) % (1 << M31_CIRCLE_LOG_ORDER)

    def at(self, i: int):
        return point_at_index(self.index_at(i))


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


@dataclass(frozen=True)
class CanonicCoset:
    """The canonic coset of size 2^log_size (odd multiples of G_{log_size+1});
    its circle_domain() is the standard evaluation domain of the same size."""

    log_size: int

    def circle_domain(self) -> CircleDomain:
        return CircleDomain(half_odds(self.log_size - 1))


# ---------------------------------------------------------------------------
# QM31 ("secure field") points for out-of-domain sampling
# ---------------------------------------------------------------------------

def secure_point_add(a, b):
    ax, ay = a
    bx, by = b
    return (
        h_sub(h_mul(ax, bx), h_mul(ay, by)),
        h_add(h_mul(ax, by), h_mul(ay, bx)),
    )




def secure_point_from_m31(p):
    return ((p[0], 0, 0, 0), (p[1], 0, 0, 0))



def point_from_t(t):
    """Rational parametrization (stwo CirclePoint::get_point /
    Channel::draw random point): t ∈ QM31 ->
    ((1-t^2)/(1+t^2), 2t/(1+t^2))."""
    t2 = h_mul(t, t)
    one = ONE
    denom_inv = h_inv(h_add(one, t2))
    x = h_mul(h_sub(one, t2), denom_inv)
    y = h_mul(h_add(t, t), denom_inv)
    return (x, y)
