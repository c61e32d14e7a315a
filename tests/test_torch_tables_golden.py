"""Golden vectors for the port's two ways of making the tables, on the
host (components/tables.py) and on the device (components/
device_build.py, on the CPU), transcribed from the reference's own unit
tests (table contents authored by the reference, as the JAX package's
tests/test_tables_golden.py has them):

- memory:      memory/table.rs:637-651 (test_sort),
               :662-685 (test_complete_wih_dummy_entries),
               :713-746 (test_memory_intermediate_table_from_registers)
- program:     program/table.rs:356-381
- instruction: instruction/table.rs:610-740 and :745-805
- processor:   processor/table.rs:677-885
- left:        processor/instructions/table.rs:652-728
- the LogUp claimed sum's invariance to dummy rows: memory/table.rs:885-929

A table's rows are the reference's intermediate rows (next_* = the
following row); the minimum height is 2^4 rows, so the goldens check the
reference-length prefix exactly and the padding tail against the
reference's pad rules (the device build at the unbucketed heights). The
device build needs a whole execution: a synthetic memory trace gets the
opcodes of one (ci '+' on every row, 0 on its last), which the memory
table does not read.
"""

import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu_torch.components import device_build
from stwo_brainfuck_tpu_torch.components import tables as T
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES, MemoryComponent
from stwo_brainfuck_tpu_torch.core import qm31
from stwo_brainfuck_tpu_torch.core.m31 import P_INT
from stwo_brainfuck_tpu_torch.framework.component import LookupElements, build_interaction_trace
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.instruction import InstructionType
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

INV2 = (P_INT + 1) // 2  # BaseField::from(2).inverse()
BUILDS = ["host", "device"]
HOST = {
    "memory": lambda trace, program: T.memory_table(trace),
    "program": lambda trace, program: T.program_table(program),
    "instruction": T.instruction_table,
    "processor": lambda trace, program: T.processor_table(trace),
    "left_instruction": lambda trace, program: T.opcode_table(trace,
                                                              int(InstructionType.Left)),
}


def _table(build: str, name: str, trace: np.ndarray, program) -> dict:
    """Column name -> values of one component's table."""
    if build == "host":
        return HOST[name](trace, program)
    mats = device_build.build_device_tables(
        trace, device_build.build_meta(trace, program, bucket=False), "cpu")
    cls = next(c for c in COMPONENT_CLASSES if c.name == name)
    return {c: mats[name][i].numpy().view(np.uint32) for i, c in enumerate(cls.columns)}


def _memory(build: str, trace: np.ndarray) -> dict:
    """The memory table of a synthetic trace (made runnable for the device
    build: its (clk, mp, mv) kept, the host table the same)."""
    if build == "host":
        return T.memory_table(trace)
    run = trace.copy()
    last = int(np.argmax(run[:, 0]))
    run[:, 1], run[:, 2] = 0, int(InstructionType.Plus)
    run[last, 1], run[last, 2] = 1, 0
    for name, col in T.memory_table(run).items():
        np.testing.assert_array_equal(col, T.memory_table(trace)[name])
    return _table("device", "memory", run, [int(InstructionType.Plus)])


def _trace_row(clk=0, ip=0, ci=0, ni=0, mp=0, mv=0, mvi=0):
    return [clk, ip, ci, ni, mp, mv, mvi]


def _cols_rows(cols, names):
    return [tuple(int(cols[n][i]) for n in names) for i in range(len(cols[names[0]]))]


def _machine(code: str, inp: bytes):
    m = create_test_machine(compile_program(code), inp)
    m.execute()
    return m


def _example_machine():
    return _machine("+>,<[>+.<-]", b"\x01")


# -- memory -----------------------------------------------------------------

@pytest.mark.parametrize("build", BUILDS)
def test_memory_sort_golden(build):
    """memory/table.rs:637-651: rows sorted by (mp, clk)."""
    trace = np.array([_trace_row(clk=0, mp=1), _trace_row(clk=0, mp=0),
                      _trace_row(clk=1, mp=0)], np.uint32)
    rows = _cols_rows(_memory(build, trace), ["clk", "mp", "mv", "d"])
    assert rows[:3] == [(0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 0)]


@pytest.mark.parametrize("build", BUILDS)
def test_memory_complete_with_dummy_entries_golden(build):
    """memory/table.rs:662-685: clk gaps filled with dummies carrying the
    previous mv."""
    trace = np.array([_trace_row(clk=5, mp=1, mv=1), _trace_row(clk=0, mp=0),
                      _trace_row(clk=0, mp=1)], np.uint32)
    rows = _cols_rows(_memory(build, trace), ["clk", "mp", "mv", "d"])
    expected = [(0, 0, 0, 0), (0, 1, 0, 0), (1, 1, 0, 1), (2, 1, 0, 1), (3, 1, 0, 1),
                (4, 1, 0, 1), (5, 1, 1, 0)]
    assert rows[:len(expected)] == expected
    # pad tail: clk continues, mp and mv frozen at the last entry, d = 1
    # (memory/table.rs:291-303)
    for i, r in enumerate(rows[len(expected):]):
        assert r == (6 + i, 1, 1, 1)


@pytest.mark.parametrize("build", BUILDS)
def test_memory_from_registers_golden(build):
    """memory/table.rs:713-746: registers -> the sorted table with its
    dummies, and next_* = the following row."""
    trace = np.array([_trace_row(clk=5, mp=1, mv=1), _trace_row(),
                      _trace_row(clk=1, mp=1)], np.uint32)
    cols = _memory(build, trace)
    rows = _cols_rows(cols, ["clk", "mp", "mv", "d"])
    assert rows[:8] == [(0, 0, 0, 0), (1, 1, 0, 0), (2, 1, 0, 1), (3, 1, 0, 1), (4, 1, 0, 1),
                        (5, 1, 1, 0), (6, 1, 1, 1), (7, 1, 1, 1)]
    assert _cols_rows(cols, ["next_clk", "next_mp", "next_mv", "next_d"])[:7] == rows[1:8]


# -- program ------------------------------------------------------------------

@pytest.mark.parametrize("build", BUILDS)
def test_program_table_golden(build):
    """program/table.rs:356-381: the '+>-' listing; the dummy pad keeps the
    last ip."""
    m = _machine("+>-", b"")
    assert m.program() == [43, 62, 45]
    rows = _cols_rows(_table(build, "program", m.trace(), m.program()), ["ip", "ci", "ni", "d"])
    assert rows[:3] == [(0, 43, 62, 0), (1, 62, 45, 0), (2, 45, 0, 0)]
    for r in rows[3:]:
        assert r == (2, 0, 0, 1)  # new_dummy(last ip) (program/table.rs:62-70)


# -- instruction (the example program +>,<[>+.<-] with input [1]) -------------

@pytest.mark.parametrize("build", BUILDS)
def test_instruction_table_golden(build):
    """instruction/table.rs:610-740: the sorted merge of program and trace."""
    m = _example_machine()
    rows = _cols_rows(_table(build, "instruction", m.trace(), m.program()),
                      ["ip", "ci", "ni", "d"])
    ins = [(0, 43, 62), (0, 43, 62), (1, 62, 44), (1, 62, 44), (2, 44, 60), (2, 44, 60),
           (3, 60, 91), (3, 60, 91), (4, 91, 12), (4, 91, 12), (5, 12, 62), (6, 62, 43),
           (6, 62, 43), (7, 43, 46), (7, 43, 46), (8, 46, 60), (8, 46, 60), (9, 60, 45),
           (9, 60, 45), (10, 45, 93), (10, 45, 93), (11, 93, 6), (11, 93, 6), (12, 6, 0),
           (13, 0, 0)]
    expected = [(ip, ci, ni, 0) for ip, ci, ni in ins] + [(13, 0, 0, 1)] * 7  # new_dummy(13)
    assert len(rows) == 32
    assert rows == expected


@pytest.mark.parametrize("build", BUILDS)
def test_instruction_table_unused_instruction_golden(build):
    """instruction/table.rs:745-805: '[-]', whose never-executed body cells
    appear once (program only)."""
    m = _machine("[-]", b"")
    rows = _cols_rows(_table(build, "instruction", m.trace(), m.program()),
                      ["ip", "ci", "ni", "d"])
    assert rows[:8] == [(0, 91, 4, 0), (0, 91, 4, 0), (1, 4, 45, 0), (2, 45, 93, 0),
                        (3, 93, 2, 0), (4, 2, 0, 0), (5, 0, 0, 0), (5, 0, 0, 1)]
    for r in rows[8:]:
        assert r == (5, 0, 0, 1)


# -- processor (also a golden test of the VM trace itself) -------------------

PROCESSOR_GOLDEN = [
    # (clk, ip, ci, ni, mp, mv, mvi): processor/table.rs:696-818
    (0, 0, 43, 62, 0, 0, 0),
    (1, 1, 62, 44, 0, 1, 1),
    (2, 2, 44, 60, 1, 0, 0),
    (3, 3, 60, 91, 1, 1, 1),
    (4, 4, 91, 12, 0, 1, 1),
    (5, 6, 62, 43, 0, 1, 1),
    (6, 7, 43, 46, 1, 1, 1),
    (7, 8, 46, 60, 1, 2, INV2),
    (8, 9, 60, 45, 1, 2, INV2),
    (9, 10, 45, 93, 0, 1, 1),
    (10, 11, 93, 6, 0, 0, 0),
    (11, 13, 0, 0, 0, 0, 0),
]


def test_vm_trace_golden():
    """The raw VM trace is the reference's register sequence."""
    got = [tuple(int(v) for v in row) for row in _example_machine().trace()]
    assert got == PROCESSOR_GOLDEN


@pytest.mark.parametrize("build", BUILDS)
def test_processor_table_golden(build):
    """processor/table.rs:677-885."""
    m = _example_machine()
    cols = _table(build, "processor", m.trace(), m.program())
    rows = _cols_rows(cols, ["clk", "ip", "ci", "ni", "mp", "mv", "mvi"])
    assert rows[:12] == PROCESSOR_GOLDEN
    d = [int(v) for v in cols["d"]]
    assert d[:12] == [0] * 12
    # dummy pad: clk increments, ip frozen, the rest 0 (processor/table.rs:241-264)
    for i, r in enumerate(rows[12:16]):
        assert r == (12 + i, 13, 0, 0, 0, 0, 0)
    assert d[12:16] == [1, 1, 1, 1]
    assert [int(v) for v in cols["next_clk"]] == [r[0] + 1 for r in rows]


@pytest.mark.parametrize("build", BUILDS)
def test_left_table_golden(build):
    """processor/instructions/table.rs:652-728: '<' rows paired with their
    successor."""
    m = _example_machine()
    cols = _table(build, "left_instruction", m.trace(), m.program())
    names = ["clk", "ip", "ci", "ni", "mp", "mv", "mvi", "d", "next_ip", "next_mp", "next_mv"]
    rows = _cols_rows(cols, names)
    assert rows[0] == (3, 3, 60, 91, 1, 1, 1, 0, 4, 0, 1)
    assert rows[1] == (8, 9, 60, 45, 1, 2, INV2, 0, 10, 0, 1)
    # pad: clk = last_clk + 2i, ip frozen, d = 1 (instructions/table.rs:293-307)
    last_clk, last_ip = 9, 10
    for i, r in enumerate(rows[2:]):
        assert r[7] == 1
        assert r[1] == last_ip
        assert r[0] == last_clk + 2 * i


@pytest.mark.parametrize("build", BUILDS)
def test_logup_claimed_sum_dummy_invariance_memory(build):
    """memory/table.rs:885-929: the dummy rows leave the claimed sum at the
    sum over the real rows of -1/combine([clk, mp, mv])
    (table.rs:810-878's fraction formula)."""
    m = _example_machine()
    cols = _table(build, "memory", m.trace(), m.program())
    log_size = int(np.log2(len(cols["clk"])))
    els = {"memory": LookupElements.dummy(3), "instruction": LookupElements.dummy(3),
           "processor": LookupElements.dummy(7)}
    main = {k: torch.as_tensor(np.asarray(v).astype(np.int32)) for k, v in cols.items()}
    _, claimed = build_interaction_trace(MemoryComponent(log_size), main, els)
    expected = qm31.ZERO
    for clk, mp, mv, d in zip(cols["clk"], cols["mp"], cols["mv"], cols["d"]):
        if int(d) == 0:
            den = els["memory"].combine_host([int(clk), int(mp), int(mv)])
            expected = qm31.h_add(expected, qm31.h_neg(qm31.h_inv(den)))
    assert tuple(claimed) == expected
