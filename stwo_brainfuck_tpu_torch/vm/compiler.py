"""Brainfuck compiler: strips whitespace, maps symbols to their ASCII value as
M31 elements, and inlines bracket jump targets by backpatching
(reference: crates/brainfuck_vm/src/compiler.rs:6-37).

Layout of the compiled code (matching the reference exactly):
- every symbol is emitted as its ASCII value;
- '[' is followed by an extra arg cell, backpatched to the index *after* the
  matching ']' (i.e. the position of the ']' arg cell);
- ']' is followed by an arg cell = (index of the '[' arg cell) + 1.
"""

from __future__ import annotations

from typing import List


class CompileError(Exception):
    pass


def compile_program(code: str) -> List[int]:
    """Compile Brainfuck source into the flat instruction/arg list."""
    symbols = [c for c in code if not c.isspace()]
    instructions: List[int] = []
    loop_stack: List[int] = []

    for symbol in symbols:
        instructions.append(ord(symbol))
        if symbol == "[":
            instructions.append(0)
            loop_stack.append(len(instructions) - 1)
        elif symbol == "]":
            if not loop_stack:
                raise CompileError("Unmatched ']'")
            start_pos = loop_stack.pop()
            instructions[start_pos] = len(instructions)
            instructions.append(start_pos + 1)
    if loop_stack:
        raise CompileError("Unmatched '['")
    return instructions
