"""A plain Brainfuck interpreter that records the 7-register execution trace.

Written from the semantics of the upstream VM (kkrt-labs/stwo-brainfuck,
crates/brainfuck_vm/src/machine.rs), as the port's Python interpreter
documents them:

- cell values and the memory pointer live in M31 (wrap mod p = 2^31 - 1);
- `mvi` is mv^-1, or 0 when mv = 0;
- `[` is followed by an argument cell, the index after the matching `]`'s
  argument; on mv == 0 the jump lands at that argument + 1;
- `]` is followed by the index of the `[` argument + 1; on mv != 0 the
  jump goes there;
- a final row with ci = ni = 0 closes the trace.

One tight loop over local variables, so that a million steps take seconds.
"""

from __future__ import annotations

from enum import IntEnum
from typing import List, Tuple

import numpy as np

from .field import P_INT

RAM_SIZE = 30000
MAX_STEPS = 1 << 26


class VmError(Exception):
    pass


class InstructionType(IntEnum):
    """Opcodes are the ASCII values of the Brainfuck symbols."""

    Right = ord(">")
    Left = ord("<")
    Plus = ord("+")
    Minus = ord("-")
    PutChar = ord(".")
    ReadChar = ord(",")
    JumpIfZero = ord("[")
    JumpIfNotZero = ord("]")


def compile_program(source: str) -> List[int]:
    """Brainfuck source -> the flat instruction list with jump arguments."""
    code: List[int] = []
    stack: List[int] = []
    for ch in source:
        if ch.isspace():
            continue
        code.append(ord(ch))
        if ch == "[":
            code.append(0)
            stack.append(len(code) - 1)
        elif ch == "]":
            if not stack:
                raise VmError("unmatched ']'")
            start = stack.pop()
            code[start] = len(code)
            code.append(start + 1)
    if stack:
        raise VmError("unmatched '['")
    return code


def run(code: List[int], input_bytes: bytes) -> Tuple[np.ndarray, bytes]:
    """Execute `code` on `input_bytes`: (trace (n, 7) uint32 in register
    order clk, ip, ci, ni, mp, mv, mvi; the output bytes)."""
    ram = [0] * RAM_SIZE
    inv = {0: 0}
    rows: List[tuple] = []
    append = rows.append
    out = bytearray()
    n = len(code)
    clk = ip = mp = mv = mvi = 0
    pos = 0
    while ip < n:
        if clk >= MAX_STEPS:
            raise VmError("program exceeded the maximum step count")
        ci = code[ip]
        ni = 0 if ip == n - 1 else code[ip + 1]
        if ci == 91:  # '[': ni is the argument
            append((clk, ip, ci, ni, mp, mv, mvi))
            if ram[mp] == 0:
                ip = ni
            else:
                ip += 1
        elif ci == 93:  # ']'
            append((clk, ip, ci, ni, mp, mv, mvi))
            if ram[mp] != 0:
                ip = ni - 1
            else:
                ip += 1
        else:
            append((clk, ip, ci, ni, mp, mv, mvi))
            if ci == 62:  # '>'
                mp += 1
                if mp >= RAM_SIZE:
                    raise VmError("memory pointer out of range")
            elif ci == 60:  # '<'
                mp = (mp - 1) % P_INT
                if mp >= RAM_SIZE:
                    raise VmError("memory pointer out of range")
            elif ci == 43:  # '+'
                ram[mp] = (ram[mp] + 1) % P_INT
            elif ci == 45:  # '-'
                ram[mp] = (ram[mp] - 1) % P_INT
            elif ci == 44:  # ','
                if pos >= len(input_bytes):
                    raise VmError("unexpected end of input")
                ram[mp] = input_bytes[pos]
                pos += 1
            elif ci == 46:  # '.'
                out.append(ram[mp] & 0xFF)
            else:
                raise VmError(f"invalid instruction {ci}")
        mv = ram[mp]
        mvi = inv.get(mv)
        if mvi is None:
            mvi = inv[mv] = pow(mv, P_INT - 2, P_INT)
        clk += 1
        ip += 1
    append((clk, ip, 0, 0, mp, mv, mvi))
    return np.asarray(rows, dtype=np.uint32).reshape(-1, 7), bytes(out)
