"""M31 / QM31 / circle arithmetic of the torch port vs the JAX package,
elementwise on random and edge inputs (0, 1, p-1). Bit-identical."""

import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import circle as jcircle
from stwo_brainfuck_tpu.core import m31 as jm31
from stwo_brainfuck_tpu.core import qm31 as jqm31
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.core import circle as tcircle
from stwo_brainfuck_tpu_torch.core import m31 as tm31
from stwo_brainfuck_tpu_torch.core import qm31 as tqm31

torch.set_num_threads(1)
P = tm31.P_INT
EDGE = np.array([0, 1, 2, P - 1, P - 2, 2**30, 2**16 - 1, 2**16, 65537], np.uint32)


def _operands(seed, n=1024):
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.repeat(EDGE, len(EDGE)), rng.integers(0, P, n, dtype=np.uint32)])
    b = np.concatenate([np.tile(EDGE, len(EDGE)), rng.integers(0, P, n, dtype=np.uint32)])
    return a, b


def _t(x):
    return convert.to_torch(x)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_m31_binary_ops_match_jax(op):
    a, b = _operands(1)
    got = convert.to_numpy(getattr(tm31, op)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, np.asarray(getattr(jm31, op)(a, b)))


def test_m31_unary_ops_match_jax():
    a, _ = _operands(2)
    np.testing.assert_array_equal(convert.to_numpy(tm31.neg(_t(a))), np.asarray(jm31.neg(a)))
    np.testing.assert_array_equal(convert.to_numpy(tm31.inv(_t(a))), np.asarray(jm31.inv(a)))


def test_m31_host_mirrors_are_the_same():
    a, b = _operands(3)
    for name in ("np_add", "np_sub", "np_mul"):
        np.testing.assert_array_equal(getattr(tm31, name)(a, b), getattr(jm31, name)(a, b))
    np.testing.assert_array_equal(tm31.np_inv(a), jm31.np_inv(a))


def _qm_operands(seed, n=256):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, (4, n), dtype=np.uint32)
    y = rng.integers(0, P, (4, n), dtype=np.uint32)
    x[:, :len(EDGE)] = EDGE
    y[:, :len(EDGE)] = EDGE[::-1]
    x[:, 0] = 0  # inverse of zero maps to zero
    return x, y


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_qm31_binary_ops_match_jax(op):
    x, y = _qm_operands(4)
    got = convert.to_numpy(getattr(tqm31, op)(_t(x), _t(y)))
    np.testing.assert_array_equal(got, np.asarray(getattr(jqm31, op)(x, y)))


def test_qm31_unary_and_scalar_ops_match_jax():
    x, y = _qm_operands(5)
    np.testing.assert_array_equal(convert.to_numpy(tqm31.inv(_t(x))), np.asarray(jqm31.inv(x)))
    np.testing.assert_array_equal(convert.to_numpy(tqm31.neg(_t(x))), np.asarray(jqm31.neg(x)))
    np.testing.assert_array_equal(convert.to_numpy(tqm31.mul_m31(_t(x), _t(y[0]))),
                                  np.asarray(jqm31.mul_m31(x, y[0])))
    np.testing.assert_array_equal(convert.to_numpy(tqm31.from_m31(_t(y[1]))),
                                  np.asarray(jqm31.from_m31(y[1])))


def test_qm31_host_helpers_match_jax():
    rng = np.random.default_rng(6)
    for _ in range(20):
        a = tuple(int(v) for v in rng.integers(0, P, 4))
        b = tuple(int(v) for v in rng.integers(0, P, 4))
        for name in ("h_add", "h_sub", "h_mul"):
            assert getattr(tqm31, name)(a, b) == getattr(jqm31, name)(a, b)
        assert tqm31.h_inv(a) == jqm31.h_inv(a)
        assert tqm31.h_frobenius(a) == jqm31.h_frobenius(a)
        assert tqm31.h_pow(a, 1000) == jqm31.h_pow(a, 1000)
    x, y = (v.astype(np.uint64) for v in _qm_operands(7))
    np.testing.assert_array_equal(tqm31.npq_mul(x, y), jqm31.npq_mul(x, y))
    np.testing.assert_array_equal(tqm31.npq_inv(x), jqm31.npq_inv(x))
    np.testing.assert_array_equal(tqm31.npq_frobenius(x), jqm31.npq_frobenius(x))


def test_circle_points_and_domains_match_jax():
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 1 << 31, 64, dtype=np.uint64)
    for got, want in zip(tcircle.points_at_indices(idx), jcircle.points_at_indices(idx)):
        np.testing.assert_array_equal(got, want)
    for log in (1, 4, 9):
        d_t = tcircle.CanonicCoset(log).circle_domain()
        d_j = jcircle.CanonicCoset(log).circle_domain()
        np.testing.assert_array_equal(d_t.indices(), d_j.indices())
    t = tuple(int(v) for v in rng.integers(0, P, 4))
    assert tcircle.point_from_t(t) == jcircle.point_from_t(t)


def test_convert_round_trips():
    x, _ = _qm_operands(9)
    np.testing.assert_array_equal(convert.to_numpy(convert.to_torch(x)), x)
    words = np.random.default_rng(10).integers(0, 1 << 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    t = convert.digests_to_torch(words)
    assert t.shape == (8, 5) and t.dtype == torch.int32
    np.testing.assert_array_equal(convert.digests_to_numpy(t), words)
    with pytest.raises(ValueError):
        convert.to_torch(np.array([1 << 31], np.uint32))
