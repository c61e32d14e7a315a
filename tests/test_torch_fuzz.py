"""The port's verifier and constraints held to the JAX package's negative
tests, on the CPU with the small program.

- tests/test_fuzz_proof.py's contract, with its mutation helpers and seeds:
  at least 150 seeded semantic mutations of a valid proof raise the port's
  VerificationError; type mutations never crash it (VerificationError, or a
  clean verify of a value-preserving coercion); every top-level field
  replaced by junk is rejected, an unknown extra key is ignored.
- tests/test_components.py's mutated trace cells (its parametrised matrix,
  read from that test) and its LogUp tampers, evaluated through the port's
  component code (framework/component.py's Evaluator over
  components/tables.py's tables): the named constraint fires.
"""

import copy
import json
import random

import numpy as np
import pytest
import torch

import test_components as jax_components
import test_fuzz_proof as jax_fuzz
from stwo_brainfuck_tpu_torch import air, convert
from stwo_brainfuck_tpu_torch.components import tables
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES, ELEMENT_SIZES
from stwo_brainfuck_tpu_torch.core import fft, qm31
from stwo_brainfuck_tpu_torch.framework import component as fw
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

torch.set_num_threads(1)
P = 2**31 - 1
SMALL = ("+++>,<[>+.<-]", b"\x01")
CLASSES = {c.name: c for c in COMPONENT_CLASSES}
# (component, column, row or row finder, delta, constraint index), as
# tests/test_components.py::test_mutations_violate_constraints runs them
MUTATIONS = next(m for m in jax_components.test_mutations_violate_constraints.pytestmark
                 if m.name == "parametrize").args[1]


def _verify(proof):
    air.verify_brainfuck(proof, device="cpu")


@pytest.fixture(scope="module")
def proof():
    m = create_test_machine(compile_program(SMALL[0]), SMALL[1])
    m.execute()
    p = air.prove_brainfuck(m, device="cpu")
    _verify(p)
    return p


def test_fuzz_semantic_mutations_all_rejected(proof):
    rng = random.Random(0xC57A2)
    sites = [(path, v) for path, v in jax_fuzz._paths(proof) if path]
    rng.shuffle(sites)
    tried = 0
    for path, _v in sites:
        if tried >= 220:
            break
        p = copy.deepcopy(proof)
        label = jax_fuzz._mutate_semantic(rng, p, path, jax_fuzz._get(p, path))
        if label is None:
            continue
        if json.dumps(p, sort_keys=True) == json.dumps(proof, sort_keys=True):
            continue  # a no-op mutation (a swap of equal values)
        tried += 1
        with pytest.raises(air.VerificationError):
            _verify(p)
    assert tried >= 150, f"only {tried} semantic mutations exercised"


def test_fuzz_type_mutations_never_crash(proof):
    rng = random.Random(0xF00D)
    sites = [(path, v) for path, v in jax_fuzz._paths(proof)
             if path and not isinstance(v, (dict, list))]
    rng.shuffle(sites)
    crashes = []
    for path, _v in sites[:120]:
        repl = rng.choice(jax_fuzz.TYPE_REPLACEMENTS)
        p = copy.deepcopy(proof)
        try:
            p2 = json.loads(json.dumps(jax_fuzz._apply(p, path, repl)))
        except (TypeError, ValueError):
            continue  # not JSON-serializable: out of scope
        try:
            _verify(p2)  # a value-preserving coercion (5 -> "5") verifies
        except air.VerificationError:
            pass
        except Exception as exc:  # noqa: BLE001 - the assertion target
            crashes.append((path, type(exc).__name__, str(exc)[:80]))
    assert not crashes, crashes


def test_fuzz_top_level_structures(proof):
    for k in list(proof):
        for junk in (None, [], {}, 0, "zzz", [[]], {"a": 1}):
            p = copy.deepcopy(proof)
            p[k] = junk
            with pytest.raises(air.VerificationError):
                _verify(p)
    p = copy.deepcopy(proof)
    p["unknown_extra"] = {"nested": [1, 2, 3]}
    _verify(p)


@pytest.fixture(scope="module")
def small_tables():
    m = create_test_machine(compile_program(SMALL[0]), SMALL[1])
    m.execute()
    return tables.all_tables(m.trace(), m.program())


def _elements():
    return {k: fw.LookupElements.dummy(v) for k, v in ELEMENT_SIZES.items()}


def _fired(name, main_np, els, interaction_np=None, tamper=None):
    """The indices of the constraints of component `name` that do not
    vanish on the trace domain: main columns main_np (numpy), the
    interaction trace built from interaction_np's columns (main_np's if
    None), then passed through tamper(interaction, claimed) if given."""
    log_size = int(np.log2(len(next(iter(main_np.values())))))
    comp = CLASSES[name](log_size)
    main = {c: convert.to_torch(v) for c, v in main_np.items()}
    source = main if interaction_np is None else {
        c: convert.to_torch(v) for c, v in interaction_np.items()}
    inter, claimed = fw.build_interaction_trace(comp, source, els)
    if tamper is not None:
        inter = [q.clone() for q in inter]
        claimed = list(claimed)
        tamper(inter, claimed)
        claimed = tuple(claimed)
    s_prev = inter[-1][:, fft.rotation_permutation(log_size, 0, 1, "cpu")]
    is_first = torch.zeros(1 << log_size, dtype=torch.int32)
    is_first[0] = 1
    ev = fw.Evaluator(comp, main, inter, s_prev, is_first, qm31.const(claimed, "cpu"),
                      {k: e.tensors("cpu") for k, e in els.items()}, host=False)
    comp.define_constraints(ev)
    return {i for i, c in enumerate(ev.constraints) if bool((c.v.to(torch.int64) % P).any())}, comp


@pytest.mark.parametrize("name", [c.name for c in COMPONENT_CLASSES])
def test_valid_tables_fire_no_constraint(small_tables, name):
    fired, _ = _fired(name, small_tables[name], _elements())
    assert not fired


@pytest.mark.parametrize("comp,col,row,delta,idx", MUTATIONS)
def test_mutations_violate_constraints(small_tables, comp, col, row, delta, idx):
    cols = dict(small_tables[comp])
    if callable(row):
        row = row(cols)
    mutated = cols[col].copy()
    mutated[row] = (int(mutated[row]) + delta) % P
    cols[col] = mutated
    fired, _ = _fired(comp, cols, _elements())
    assert idx in fired, f"{comp}: expected constraint {idx} to fire, got {fired}"


def _bump(q, index):
    q[index] = (int(q[index]) + 1) % P


# The LogUp tampers of tests/test_components.py:254-306: (component, tamper
# of (interaction columns, claimed sum), the constraint that must fire as
# an offset from the component's first LogUp constraint, or -1 for its last)
LOGUP_TAMPERS = {
    "memory_fraction": ("memory", lambda inter, cl: _bump(inter[0], (0, 2)), 0),
    "processor_instruction_entry": ("processor", lambda inter, cl: _bump(inter[1], (1, 3)), 1),
    "claimed_sum": ("memory", lambda inter, cl: cl.__setitem__(0, (cl[0] + 1) % P), -1),
    "prefix_sum_column": ("memory", lambda inter, cl: _bump(inter[-1], (2, 5)), -1),
}


@pytest.mark.parametrize("kind", sorted(LOGUP_TAMPERS))
def test_logup_tampers_violate_constraints(small_tables, kind):
    name, tamper, which = LOGUP_TAMPERS[kind]
    fired, comp = _fired(name, small_tables[name], _elements(), tamper=tamper)
    n_base = comp.constraint_count() - comp.relation_count() - 1
    want = comp.constraint_count() - 1 if which < 0 else n_base + which
    assert want in fired, f"{kind}: expected constraint {want}, got {fired}"


def test_logup_wrong_multiplicity_flipped_d(small_tables):
    """An interaction trace built from a table whose first real row is
    claimed as a dummy (multiplicity 0), against the real main trace."""
    cols = small_tables["memory"]
    forged = dict(cols)
    forged["d"] = cols["d"].copy()
    forged["d"][0] = 1
    fired, comp = _fired("memory", cols, _elements(), interaction_np=forged)
    assert comp.constraint_count() - comp.relation_count() - 1 in fired
