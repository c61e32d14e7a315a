"""CM31 and QM31 (secure field) arithmetic on torch tensors.

Counterpart of ``stwo_brainfuck_tpu/core/qm31.py``. Tower: CM31 =
M31[i]/(i^2 + 1), QM31 = CM31[u]/(u^2 - (2 + i)).

Layout: a QM31 tensor has shape ``(4, ...)`` — the leading axis holds the 4
coordinates (re0, im0, re1, im1), the same layout as the JAX package, so
arrays convert one to one (``convert.py``). Device ops return canonical
int64 tensors; the host helpers (``h_*`` on tuples of ints, ``npq_*`` on
(4, n) uint64 numpy arrays) are copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import m31
from .m31 import P_INT


def from_m31(x) -> torch.Tensor:
    """Embed an M31 tensor into QM31 (shape (4, ...))."""
    x = m31.wide(x)
    z = torch.zeros_like(x)
    return torch.stack([x, z, z, z])


def const(v, device, ndim: int = 1) -> torch.Tensor:
    """A host QM31 tuple as a (4, 1, ...) int64 tensor that broadcasts
    against (4, N, ...) arrays."""
    return torch.tensor([int(c) % P_INT for c in v], dtype=torch.int64,
                        device=device).reshape((4,) + (1,) * ndim)


def add(x, y):
    return m31.add(x, y)


def sub(x, y):
    return m31.sub(x, y)


def neg(x):
    return m31.neg(x)


def _cm_mul(ar, ai, br, bi):
    """CM31 product: (ar + ai·i)(br + bi·i), inputs canonical int64."""
    return (ar * br - ai * bi) % m31.P, (ar * bi + ai * br) % m31.P


def mul(x, y) -> torch.Tensor:
    """QM31 product. (A + Bu)(C + Du) = AC + (2+i)BD + (AD + BC)u."""
    x = m31.wide(x)
    y = m31.wide(y)
    a_r, a_i, b_r, b_i = x[0], x[1], x[2], x[3]
    c_r, c_i, d_r, d_i = y[0], y[1], y[2], y[3]
    ac_r, ac_i = _cm_mul(a_r, a_i, c_r, c_i)
    bd_r, bd_i = _cm_mul(b_r, b_i, d_r, d_i)
    ad_r, ad_i = _cm_mul(a_r, a_i, d_r, d_i)
    bc_r, bc_i = _cm_mul(b_r, b_i, c_r, c_i)
    # (2+i)·BD = (2·bd_r - bd_i) + (bd_r + 2·bd_i) i
    out0 = (ac_r + 2 * bd_r - bd_i) % m31.P
    out1 = (ac_i + bd_r + 2 * bd_i) % m31.P
    out2 = (ad_r + bc_r) % m31.P
    out3 = (ad_i + bc_i) % m31.P
    return torch.stack([out0, out1, out2, out3])


def pow_const(x, e: int) -> torch.Tensor:
    """x^e for a Python exponent (square-and-multiply), x of shape (4, ...)."""
    result = None
    base = m31.wide(x)
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        base = mul(base, base)
        e >>= 1
    if result is None:
        return from_m31(torch.ones_like(base[0]))
    return result


def mul_m31(x, s) -> torch.Tensor:
    """QM31 × M31 (scalar or tensor broadcast over the 4 coordinates)."""
    s = m31.wide(s)
    if isinstance(s, torch.Tensor):
        s = s.unsqueeze(0)
    return m31.mul(x, s)


def _cm_inv(ar, ai):
    """CM31 inverse via conjugate / norm."""
    norm = (ar * ar + ai * ai) % m31.P
    ninv = m31.inv(norm)
    return (ar * ninv) % m31.P, ((-ai) % m31.P * ninv) % m31.P


def inv(x) -> torch.Tensor:
    """QM31 inverse: (A + Bu)^-1 = (A - Bu) / (A^2 - (2+i) B^2); 0 -> 0."""
    x = m31.wide(x)
    a_r, a_i, b_r, b_i = x[0], x[1], x[2], x[3]
    a2_r, a2_i = _cm_mul(a_r, a_i, a_r, a_i)
    b2_r, b2_i = _cm_mul(b_r, b_i, b_r, b_i)
    den_r = (a2_r - 2 * b2_r + b2_i) % m31.P
    den_i = (a2_i - b2_r - 2 * b2_i) % m31.P
    di_r, di_i = _cm_inv(den_r, den_i)
    out0, out1 = _cm_mul(a_r, a_i, di_r, di_i)
    out2, out3 = _cm_mul((-b_r) % m31.P, (-b_i) % m31.P, di_r, di_i)
    return torch.stack([out0, out1, out2, out3])


# ---------------------------------------------------------------------------
# Host-side helpers (python ints / numpy) for the channel and verifier.
# A host QM31 value is a tuple (a, b, c, d) of python ints < P.
# ---------------------------------------------------------------------------

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


# Vectorized host QM31 arrays (shape (4, n) np.uint64, canonical < P):
# the verifier's batched quotient reconstruction (quotients.py) works on
# all query positions of a size at once instead of per-position tuple math.


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
    ni = m31.np_inv(norm).astype(np.uint64)
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


def npq_frobenius(x):
    """Vectorized h_frobenius on a (4, n) uint64 array (canonical out)."""
    c_r, c_i = _FROB_C
    b_r = x[2]
    b_i = (P_INT - x[3]) % P_INT
    o2 = (b_r * c_r + ((P_INT - b_i) % P_INT) * c_i) % P_INT
    o3 = (b_r * c_i + b_i * c_r) % P_INT
    return np.stack([x[0] % P_INT, (P_INT - x[1]) % P_INT, o2, o3])


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
