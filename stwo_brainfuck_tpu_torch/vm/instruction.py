"""Brainfuck instruction set (8-symbol ISA), mirroring the reference
crates/brainfuck_vm/src/instruction.rs:15-127."""

from __future__ import annotations

from enum import IntEnum


class InstructionType(IntEnum):
    """Opcodes are the ASCII values of the Brainfuck symbols."""

    Right = ord(">")      # 62: move memory pointer right
    Left = ord("<")       # 60: move memory pointer left
    Plus = ord("+")       # 43: increment current cell (mod p)
    Minus = ord("-")      # 45: decrement current cell (mod p)
    PutChar = ord(".")    # 46: output current cell (low byte)
    ReadChar = ord(",")   # 44: read one byte into current cell
    JumpIfZero = ord("[")     # 91
    JumpIfNotZero = ord("]")  # 93


VALID_INSTRUCTIONS_BF = "><+-.,[]"
_VALID_SET = frozenset(ord(c) for c in VALID_INSTRUCTIONS_BF)


class InstructionError(Exception):
    """Raised when a byte is not a valid Brainfuck opcode
    (instruction.rs TryFrom<u8> error path)."""

    def __init__(self, value: int):
        super().__init__(f"Invalid instruction: {value!r}")
        self.value = value


def from_u8(value: int) -> InstructionType:
    if value not in _VALID_SET:
        raise InstructionError(value)
    return InstructionType(value)
