"""The 13 AIR component definitions (constraints + LogUp relations).

A frozen copy of the port's components/defs.py.

Constraint lists mirror the reference's component.rs files one-to-one
(citations per class). The LogUp balance (reference SURVEY §2.2):

- Memory emits -1 per real sorted row on MemoryElements[clk, mp, mv];
  Processor emits +1 per exec row — a permutation argument.
- Instruction emits -1 per row of sort(program ∪ exec) on
  InstructionElements[ip, ci, ni]; Program emits +1 per program cell and
  Processor +1 per exec row — a sublist argument.
- Processor emits +1 per exec row on ProcessorElements[all 7 registers];
  each of the 9 instruction sub-components emits -1 for its rows.

Total over all components must be 0 (checked by lookup_sum_valid before FRI,
reference brainfuck_air/mod.rs:206-227).
"""

from __future__ import annotations

from .air import Component, Evaluator
from .vm import InstructionType


class MemoryComponent(Component):
    """reference: components/memory/component.rs:62-137"""

    name = "memory"
    columns = ("clk", "mp", "mv", "d", "next_clk", "next_mp", "next_mv", "next_d")

    def define_constraints(self, e: Evaluator) -> None:
        clk, mp, mv, d = e.col("clk"), e.col("mp"), e.col("mv"), e.col("d")
        next_clk, next_mp = e.col("next_clk"), e.col("next_mp")
        next_mv, next_d = e.col("next_mv"), e.col("next_d")
        first = e.is_first()

        # boundary: first clk/mp/mv/d = 0
        e.add(first * clk)
        e.add(first * mp)
        e.add(first * mv)
        e.add(first * d)
        # consistency: d, next_d boolean
        e.add(d * (d - 1))
        e.add(next_d * (next_d - 1))
        # transitions
        e.add((next_mp - mp) * (next_mp - mp - 1))
        e.add((next_mp - mp - 1) * (next_clk - clk - 1))
        e.add((next_mp - mp) * next_mv)
        e.add(d * (next_mp - mp))
        e.add(d * (next_mv - mv))

        e.relation("memory", d - 1, [clk, mp, mv])
        e.finalize_logup()


class InstructionComponent(Component):
    """reference: components/instruction/component.rs"""

    name = "instruction"
    columns = ("ip", "ci", "ni", "d", "next_ip", "next_ci", "next_ni", "next_d")

    def define_constraints(self, e: Evaluator) -> None:
        ip, ci, ni, d = e.col("ip"), e.col("ci"), e.col("ni"), e.col("d")
        next_ip, next_ci = e.col("next_ip"), e.col("next_ci")
        next_ni, next_d = e.col("next_ni"), e.col("next_d")

        e.add(e.is_first() * ip)
        e.add(d * (d - 1))
        e.add(next_d * (next_d - 1))
        e.add(d * ci)
        e.add(d * ni)
        e.add(next_d * next_ci)
        e.add(next_d * next_ni)
        e.add((next_ip - ip) * (next_ip - ip - 1))
        e.add((next_ip - ip - 1) * (next_ci - ci))
        e.add((next_ip - ip - 1) * (next_ni - ni))

        e.relation("instruction", d - 1, [ip, ci, ni])
        e.finalize_logup()


class ProgramComponent(Component):
    """reference: components/program/component.rs"""

    name = "program"
    columns = ("ip", "ci", "ni", "d")

    def define_constraints(self, e: Evaluator) -> None:
        ip, ci, ni, d = e.col("ip"), e.col("ci"), e.col("ni"), e.col("d")
        e.add(e.is_first() * ip)
        e.add(d * (d - 1))
        e.add(d * ci)
        e.add(d * ni)
        e.relation("instruction", 1 - d, [ip, ci, ni])
        e.finalize_logup()


class ProcessorComponent(Component):
    """reference: components/processor/component.rs:79-153"""

    name = "processor"
    columns = ("clk", "ip", "ci", "ni", "mp", "mv", "mvi", "d", "next_clk")

    def define_constraints(self, e: Evaluator) -> None:
        clk, ip, ci, ni = e.col("clk"), e.col("ip"), e.col("ci"), e.col("ni")
        mp, mv, mvi, d = e.col("mp"), e.col("mv"), e.col("mvi"), e.col("d")
        next_clk = e.col("next_clk")
        first = e.is_first()

        e.add(first * clk)
        e.add(first * ip)
        e.add(first * mp)
        e.add(first * mv)
        e.add(mv * (mv * mvi - 1))
        e.add(mvi * (mv * mvi - 1))
        e.add(next_clk - clk - 1)

        num = 1 - d
        e.relation("processor", num, [clk, ip, ci, ni, mp, mv, mvi])
        e.relation("instruction", num, [ip, ci, ni])
        e.relation("memory", num, [clk, mp, mv])
        e.finalize_logup()


class _JumpComponent(Component):
    columns = ("clk", "ip", "ci", "ni", "mp", "mv", "mvi", "next_clk",
               "next_ip", "next_mp", "next_mv", "d", "is_mv_zero")
    opcode: int = 0

    def _common(self, e: Evaluator):
        clk, ci, d, mv = e.col("clk"), e.col("ci"), e.col("d"), e.col("mv")
        e.add(ci * (ci - self.opcode))
        e.add(e.col("next_clk") - clk - 1)
        e.add(d * (d - 1))
        e.add(d * mv)
        e.add(d * ci)

    def _tail(self, e: Evaluator):
        e.add(e.col("next_mp") - e.col("mp"))
        e.add(e.col("next_mv") - e.col("mv"))
        e.relation(
            "processor", e.col("d") - 1,
            [e.col("clk"), e.col("ip"), e.col("ci"), e.col("ni"),
             e.col("mp"), e.col("mv"), e.col("mvi")],
        )
        e.finalize_logup()


class JumpIfNotZeroComponent(_JumpComponent):
    """']' — reference: jump_if_not_zero_component.rs. Taken jump lands at
    next_ip = ni; not taken skips the arg cell (ip + 2)."""

    name = "jump_if_not_zero"
    opcode = int(InstructionType.JumpIfNotZero)

    def define_constraints(self, e: Evaluator) -> None:
        self._common(e)
        d, mv = e.col("d"), e.col("mv")
        next_ip, ip, ni = e.col("next_ip"), e.col("ip"), e.col("ni")
        is_mv_zero = e.col("is_mv_zero")
        e.add((d - 1) * (is_mv_zero * (next_ip - ip - 2) + mv * (next_ip - ni)))
        self._tail(e)


class JumpIfZeroComponent(_JumpComponent):
    """'[' — reference: jump_if_zero_component.rs. Taken jump lands at
    next_ip = ni + 1; not taken skips the arg cell (ip + 2)."""

    name = "jump_if_zero"
    opcode = int(InstructionType.JumpIfZero)

    def define_constraints(self, e: Evaluator) -> None:
        self._common(e)
        d, mv = e.col("d"), e.col("mv")
        next_ip, ip, ni = e.col("next_ip"), e.col("ip"), e.col("ni")
        is_mv_zero = e.col("is_mv_zero")
        e.add((d - 1) * (mv * (next_ip - ip - 2) + is_mv_zero * (next_ip - (ni + 1))))
        self._tail(e)


class _OpcodeComponent(Component):
    """Shared shape of + - < > , . components
    (reference: processor/instructions/*_component.rs)."""

    columns = ("clk", "ip", "ci", "ni", "mp", "mv", "mvi", "d",
               "next_ip", "next_mp", "next_mv")
    opcode: int = 0

    def define_constraints(self, e: Evaluator) -> None:
        ci, d, mv = e.col("ci"), e.col("d"), e.col("mv")
        ip, next_ip = e.col("ip"), e.col("next_ip")
        e.add(ci * (ci - self.opcode))
        e.add(d * (d - 1))
        e.add(d * mv)
        e.add(d * ci)
        e.add((1 - d) * (next_ip - ip - 1))
        self.extra(e)
        e.relation(
            "processor", d - 1,
            [e.col("clk"), ip, ci, e.col("ni"), e.col("mp"), mv, e.col("mvi")],
        )
        e.finalize_logup()

    def extra(self, e: Evaluator) -> None:
        raise NotImplementedError


class PlusComponent(_OpcodeComponent):
    name = "plus_instruction"
    opcode = int(InstructionType.Plus)

    def extra(self, e):
        e.add(e.col("next_mp") - e.col("mp"))
        e.add((1 - e.col("d")) * (e.col("next_mv") - e.col("mv") - 1))


class MinusComponent(_OpcodeComponent):
    name = "minus_instruction"
    opcode = int(InstructionType.Minus)

    def extra(self, e):
        e.add(e.col("next_mp") - e.col("mp"))
        e.add((1 - e.col("d")) * (e.col("next_mv") - e.col("mv") + 1))


class LeftComponent(_OpcodeComponent):
    name = "left_instruction"
    opcode = int(InstructionType.Left)

    def extra(self, e):
        e.add((1 - e.col("d")) * (e.col("next_mp") - e.col("mp") + 1))


class RightComponent(_OpcodeComponent):
    name = "right_instruction"
    opcode = int(InstructionType.Right)

    def extra(self, e):
        e.add((1 - e.col("d")) * (e.col("next_mp") - e.col("mp") - 1))


class InputComponent(_OpcodeComponent):
    name = "input_instruction"
    opcode = int(InstructionType.ReadChar)

    def extra(self, e):
        e.add(e.col("next_mp") - e.col("mp"))


class OutputComponent(_OpcodeComponent):
    name = "output_instruction"
    opcode = int(InstructionType.PutChar)

    def extra(self, e):
        e.add(e.col("next_mp") - e.col("mp"))
        e.add(e.col("next_mv") - e.col("mv"))


class EndOfExecutionComponent(Component):
    """reference: end_of_execution/component.rs. Deviation: the reference
    broadcasts the single final row across 16 SIMD lanes and emits -1
    unconditionally; we zero-pad instead, so the multiplicity is gated by the
    is_first preprocessed column (num = -is_first)."""

    name = "end_of_execution"
    columns = ("clk", "ip", "ci", "ni", "mp", "mv", "mvi")

    def define_constraints(self, e: Evaluator) -> None:
        e.add(e.col("ci"))
        num = 0 - e.is_first()
        e.relation(
            "processor", num,
            [e.col("clk"), e.col("ip"), e.col("ci"), e.col("ni"),
             e.col("mp"), e.col("mv"), e.col("mvi")],
        )
        e.finalize_logup()


# Fixed system order (reference: BrainfuckClaim field order,
# brainfuck_air/mod.rs:86-100 / commit order :550-562).
COMPONENT_CLASSES = [
    MemoryComponent,
    InstructionComponent,
    ProgramComponent,
    ProcessorComponent,
    JumpIfNotZeroComponent,
    JumpIfZeroComponent,
    InputComponent,
    LeftComponent,
    MinusComponent,
    OutputComponent,
    PlusComponent,
    RightComponent,
    EndOfExecutionComponent,
]

ELEMENT_SIZES = {"memory": 3, "instruction": 3, "processor": 7}
