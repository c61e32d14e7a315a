"""The port's constraint framework vs the JAX package's, for every one of
the 13 component classes: interaction columns and claimed sums from real
tables, composition contributions on random extended columns, and the
verifier's point evaluation. Bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.components import defs as jdefs
from stwo_brainfuck_tpu.components import tables as jtables
from stwo_brainfuck_tpu.framework import component as jfw
from stwo_brainfuck_tpu.vm.compiler import compile_program
from stwo_brainfuck_tpu.vm.machine import create_test_machine
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.components import defs as tdefs
from stwo_brainfuck_tpu_torch.framework import component as tfw

torch.set_num_threads(1)
P = 2**31 - 1
NAMES = [c.name for c in jdefs.COMPONENT_CLASSES]
T_CLASSES = {c.name: c for c in tdefs.COMPONENT_CLASSES}
J_CLASSES = {c.name: c for c in jdefs.COMPONENT_CLASSES}


def _elements(cls_mod, seed):
    rng = np.random.default_rng(seed)

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    return {k: cls_mod.LookupElements(z=felt(), alpha=felt(), size=s)
            for k, s in jdefs.ELEMENT_SIZES.items()}


@pytest.fixture(scope="module")
def tables():
    m = create_test_machine(compile_program("+++>,<[>+.<-]"), b"\x01")
    m.execute()
    return jtables.all_tables(m.trace(), m.program())


def test_component_classes_and_counts_match_jax():
    assert [c.name for c in tdefs.COMPONENT_CLASSES] == NAMES
    assert tdefs.ELEMENT_SIZES == jdefs.ELEMENT_SIZES
    for name in NAMES:
        tc, jc = T_CLASSES[name](5), J_CLASSES[name](5)
        assert tc.columns == jc.columns
        assert tc.relation_count() == jc.relation_count()
        assert tc.constraint_count() == jc.constraint_count()


@pytest.mark.parametrize("name", NAMES)
def test_interaction_trace_matches_jax(name, tables):
    cols = tables[name]
    log = int(np.log2(len(next(iter(cols.values())))))
    els_j, els_t = _elements(jfw, 1), _elements(tfw, 1)
    want, claimed_j = jfw.build_interaction_trace(
        J_CLASSES[name](log), {c: jnp.asarray(v) for c, v in cols.items()}, els_j)
    got, claimed_t = tfw.build_interaction_trace(
        T_CLASSES[name](log), {c: convert.to_torch(v) for c, v in cols.items()}, els_t)
    assert claimed_t == claimed_j
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("name", NAMES)
def test_composition_contribution_matches_jax(name):
    log, blow = 4, 1
    n = 1 << (log + blow)
    rng = np.random.default_rng(NAMES.index(name))
    tc, jc = T_CLASSES[name](log), J_CLASSES[name](log)
    main = {c: rng.integers(0, P, n, dtype=np.uint32) for c in jc.columns}
    inter = [rng.integers(0, P, (4, n), dtype=np.uint32) for _ in range(jc.relation_count() + 1)]
    s_prev = rng.integers(0, P, (4, n), dtype=np.uint32)
    is_first = rng.integers(0, P, n, dtype=np.uint32)
    v_inv = rng.integers(1, P, n, dtype=np.uint32)
    claimed = tuple(int(v) for v in rng.integers(0, P, 4))
    alpha = tuple(int(v) for v in rng.integers(0, P, 4))
    want, off_j = jfw.composition_contribution(
        jc, {c: jnp.asarray(v) for c, v in main.items()}, [jnp.asarray(q) for q in inter],
        jnp.asarray(s_prev), jnp.asarray(is_first), claimed, _elements(jfw, 2), alpha, 7,
        jnp.asarray(v_inv))
    got, off_t = tfw.composition_contribution(
        tc, {c: convert.to_torch(v) for c, v in main.items()},
        [convert.to_torch(q) for q in inter], convert.to_torch(s_prev),
        convert.to_torch(is_first), claimed, _elements(tfw, 2), alpha, 7,
        convert.to_torch(v_inv))
    assert off_t == off_j
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_point_evaluation_matches_jax(name):
    rng = np.random.default_rng(100 + NAMES.index(name))

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    jc = J_CLASSES[name](6)
    main = {c: felt() for c in jc.columns}
    inter = [felt() for _ in range(jc.relation_count() + 1)]
    args = (main, inter, felt(), felt(), felt())
    assert tfw.evaluate_constraints_at_point(T_CLASSES[name](6), *args, _elements(tfw, 3)) \
        == jfw.evaluate_constraints_at_point(jc, *args, _elements(jfw, 3))
