"""The reference-API surface of the JAX package's tests/test_api_parity.py
in the port, each name against the JAX function on the same inputs: the
instruction conversions (to_u32, is_instruction), the circle-point group
ops (point_neg, secure_point_neg, secure_point_double,
secure_point_mul_index), CanonicCoset.step_index, the components' column
counts, and the M31 / QM31 tensor powers (pow_const)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.components import defs as jdefs
from stwo_brainfuck_tpu.core import circle as jcircle
from stwo_brainfuck_tpu.core import m31 as jm31
from stwo_brainfuck_tpu.core import qm31 as jqm31
from stwo_brainfuck_tpu.vm import instruction as jinstruction
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES
from stwo_brainfuck_tpu_torch.core import circle, m31, qm31
from stwo_brainfuck_tpu_torch.vm import instruction

P = 2**31 - 1


def test_instruction_conversions():
    """instruction.rs:15-127: u8 <-> enum, to_u32, the validity predicate,
    the TryFrom error path; every byte as the JAX package has it."""
    for ch in "><+-.,[]":
        assert instruction.is_instruction(ord(ch))
        ins = instruction.from_u8(ord(ch))
        assert ins.to_u32() == ord(ch) == jinstruction.from_u8(ord(ch)).to_u32()
        assert isinstance(ins, instruction.InstructionType)
    for ch in "xyz#\n0":
        assert not instruction.is_instruction(ord(ch))
        with pytest.raises(instruction.InstructionError) as exc:
            instruction.from_u8(ord(ch))
        assert exc.value.value == ord(ch)
    assert [instruction.is_instruction(b) for b in range(256)] == \
        [jinstruction.is_instruction(b) for b in range(256)]
    assert set(instruction.VALID_INSTRUCTIONS_BF) == set("><+-.,[]")


def test_point_group_ops():
    """neg is the group inverse, double = add(self, self), mul_index is the
    embedded generator power, on M31 and QM31 points, as in the JAX package."""
    g = circle.M31_CIRCLE_GEN
    assert circle.point_add(g, circle.point_neg(g)) == (1, 0)
    sg = circle.secure_point_from_m31(g)
    assert circle.secure_point_double(sg) == circle.secure_point_add(sg, sg)
    assert circle.secure_point_add(sg, circle.secure_point_neg(sg)) == ((1, 0, 0, 0), (0, 0, 0, 0))
    assert circle.secure_point_mul_index(5) == circle.secure_point_from_m31(circle.point_at_index(5))
    rng = np.random.default_rng(3)
    for idx in rng.integers(0, 1 << 31, 6):
        p = circle.point_at_index(int(idx))
        assert circle.point_neg(p) == jcircle.point_neg(p)
        assert circle.secure_point_mul_index(int(idx)) == jcircle.secure_point_mul_index(int(idx))
        q = tuple(tuple(int(v) for v in rng.integers(0, P, 4)) for _ in range(2))
        assert circle.secure_point_neg(q) == jcircle.secure_point_neg(q)
        assert circle.secure_point_double(q) == jcircle.secure_point_double(q)


@pytest.mark.parametrize("lg", [4, 7, 12])
def test_canonic_coset_step_index(lg):
    """step_index = the index of the subgroup generator of size 2^log (the
    step of the LogUp prefix-sum's shifted mask point)."""
    c = circle.CanonicCoset(lg)
    assert c.step_index() == 1 << (31 - lg) == jcircle.CanonicCoset(lg).step_index()
    # stepping the coset by step_index lands on its next element
    assert c.coset().index_at(1) == (c.coset().index_at(0) + c.step_index()) % (1 << 31)


def test_component_column_counts():
    """TraceColumn::count (components/mod.rs:138-144): main columns =
    len(columns), interaction = relations + the prefix sum."""
    assert [c.name for c in COMPONENT_CLASSES] == [c.name for c in jdefs.COMPONENT_CLASSES]
    for cls, jcls in zip(COMPONENT_CLASSES, jdefs.COMPONENT_CLASSES):
        comp, jcomp = cls(4), jcls(4)
        assert comp.n_main_columns == len(comp.columns) == jcomp.n_main_columns
        assert comp.n_interaction_columns == comp.relation_count() + 1 \
            == jcomp.n_interaction_columns


@pytest.mark.parametrize("e", [0, 1, 2, 13, 2**31 - 3])
def test_pow_const_matches_jax(e):
    """M31 and QM31 square-and-multiply powers on tensors against the JAX
    package's on the same values (edge values included) and the host
    power."""
    rng = np.random.default_rng(e % 1000)
    a = np.concatenate([[0, 1, 2, P - 1], rng.integers(0, P, 12)]).astype(np.uint32)
    got = m31.pow_const(torch.as_tensor(a.astype(np.int64)), e)
    want = np.asarray(jm31.pow_const(jnp.asarray(a), e))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    x = rng.integers(0, P, (4, 5)).astype(np.uint32)
    x[:, 0] = [3, 1, 4, 1]
    got = qm31.pow_const(torch.as_tensor(x.astype(np.int64)), e)
    want = np.asarray(jqm31.pow_const(jnp.asarray(x), e))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert tuple(int(v) for v in got[:, 0]) == qm31.h_pow((3, 1, 4, 1), e)
