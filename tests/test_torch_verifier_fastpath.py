"""The port verifier's point-wise fast paths against the full-domain forms
they stand for (a drift here is a soundness or completeness bug), and
against the JAX package's:

- fft.bitrev_int vs the bit_reverse_indices permutation;
- quotients.points_at_storage_batch vs quotients.domain_points_storage;
- fri._circle_itw_host / _line_itw_host vs the full fold-twiddle tables
  the prover folds with (fri._fold_itw);
- quotients.prepare_point_groups + quotient_values_batch vs the naive
  per-claim sum  sum_k alpha^k (f_k - l_k(p)) / V_k(p).
"""

import numpy as np
import pytest

from stwo_brainfuck_tpu.core import fri as jfri
from stwo_brainfuck_tpu.core import quotients as jquotients
from stwo_brainfuck_tpu_torch.core import fft, fri, qm31, quotients
from stwo_brainfuck_tpu_torch.core.m31 import P_INT


@pytest.mark.parametrize("bits", [1, 4, 9])
def test_bitrev_int_matches_permutation_array(bits):
    rev = fft.bit_reverse_indices(bits, "cpu").tolist()
    assert [fft.bitrev_int(i, bits) for i in range(1 << bits)] == rev


@pytest.mark.parametrize("log_size", [4, 8, 12])
def test_points_at_storage_batch_matches_full_domain(log_size):
    xs, ys = quotients.domain_points_storage(log_size, "cpu")
    pos = np.random.default_rng(5).integers(0, 1 << log_size, 16)
    bx, by = quotients.points_at_storage_batch(log_size, pos)
    np.testing.assert_array_equal(np.asarray(bx, np.int64), xs.numpy()[pos])
    np.testing.assert_array_equal(np.asarray(by, np.int64), ys.numpy()[pos])
    for p, x, y in zip(pos, bx, by):
        assert (int(x), int(y)) == jquotients.point_at_storage(log_size, int(p))


@pytest.mark.parametrize("log_size", [4, 9, 13])
def test_circle_itw_host_matches_stack(log_size):
    full = fri._fold_itw("c", log_size, "cpu")
    for t in np.random.default_rng(7).integers(0, 1 << (log_size - 1), 8):
        assert fri._circle_itw_host(log_size, int(t)) == int(full[t])
        assert fri._circle_itw_host(log_size, int(t)) == jfri._circle_itw_host(log_size, int(t))


@pytest.mark.parametrize("line_log", [3, 8, 12])
def test_line_itw_host_matches_stack(line_log):
    full = fri._fold_itw("l", line_log, "cpu")
    for t in np.random.default_rng(9).integers(0, 1 << (line_log - 1), 8):
        assert fri._line_itw_host(line_log, int(t)) == int(full[t])
        assert fri._line_itw_host(line_log, int(t)) == jfri._line_itw_host(line_log, int(t))


def _rand_qm31(rng):
    return tuple(int(v) for v in rng.integers(0, P_INT, 4, dtype=np.int64))


def test_prepared_quotient_matches_naive_per_claim_sum():
    """The grouped evaluation (one inverse a point group) equals the naive
    per-claim sum at every position asked for."""
    rng = np.random.default_rng(11)
    log_size = 6
    z1 = (_rand_qm31(rng), _rand_qm31(rng))
    z2 = (_rand_qm31(rng), _rand_qm31(rng))
    # 3 columns; columns 0 and 2 sampled at z1 and z2, column 1 only at z1
    claims = [
        [quotients.QuotientClaim(z1, _rand_qm31(rng), 0),
         quotients.QuotientClaim(z2, _rand_qm31(rng), 1)],
        [quotients.QuotientClaim(z1, _rand_qm31(rng), 2)],
        [quotients.QuotientClaim(z1, _rand_qm31(rng), 3),
         quotients.QuotientClaim(z2, _rand_qm31(rng), 4)],
    ]
    alpha = _rand_qm31(rng)
    positions = [0, 5, 63]
    col_vals = rng.integers(0, P_INT, (3, len(positions)), dtype=np.int64)
    got = quotients.quotient_values_batch(log_size, positions, col_vals.astype(np.uint64),
                                          quotients.prepare_point_groups(claims, alpha))
    xs, ys = quotients.points_at_storage_batch(log_size, positions)
    for i, position in enumerate(positions):
        # naive: sum_k alpha^k (f_k - l_k(p)) / V_k(p), claim by claim, with
        # the line through (z, v) and (conj z, conj v) and V(p) the
        # vanishing line of z and conj z
        px, py = (int(xs[i]), 0, 0, 0), (int(ys[i]), 0, 0, 0)
        acc = qm31.ZERO
        for col, col_claims in enumerate(claims):
            fq = (int(col_vals[col, i]), 0, 0, 0)
            for c in col_claims:
                (zx, zy), v = c.point, c.value
                czx, czy, cv = (qm31.h_frobenius(a) for a in (zx, zy, v))
                dy = qm31.h_sub(czy, zy)
                slope = qm31.h_mul(qm31.h_sub(cv, v), qm31.h_inv(dy))
                line = qm31.h_add(v, qm31.h_mul(slope, qm31.h_sub(py, zy)))
                dx = qm31.h_sub(czx, zx)
                van = qm31.h_sub(qm31.h_mul(dy, qm31.h_sub(px, zx)),
                                 qm31.h_mul(dx, qm31.h_sub(py, zy)))
                q = qm31.h_mul(qm31.h_sub(fq, line), qm31.h_inv(van))
                acc = qm31.h_add(acc, qm31.h_mul(qm31.h_pow(alpha, c.alpha_index), q))
        assert got[position] == acc, position
    jclaims = [[jquotients.QuotientClaim(c.point, c.value, c.alpha_index) for c in cl]
               for cl in claims]
    assert got == jquotients.quotient_values_batch(
        log_size, positions, col_vals.astype(np.uint64),
        jquotients.prepare_point_groups(jclaims, alpha))
