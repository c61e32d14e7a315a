"""Brainfuck VM: fetch-record-execute interpreter emitting the 7-register
execution trace (reference: crates/brainfuck_vm/src/machine.rs:24-251).

Semantics replicated exactly:
- cell values and `mp` live in M31 (wrapping mod p = 2^31 - 1), machine.rs:177-229;
- `mvi` = mv^-1 (or 0 when mv = 0), machine.rs:221-226;
- '[' arg = index after the matching ']' arg cell; on mv == 0 jump lands at
  arg + 1 after the implicit ip += 1 of the clock tick (machine.rs:199-209);
- ']' arg = index of '[' arg + 1; on mv != 0: ip = arg - 1, then +1 (machine.rs:210-219);
- a final row with ci = ni = 0 is appended after the loop (machine.rs:156-160).

A copy of ``stwo_brainfuck_tpu/vm/machine.py``. The repo's C++ interpreter
(csrc/bf_vm.cpp, built by vm/native.py) is used when a compiler is found;
this Python implementation is the behavioural reference and fallback, and
``Machine.vm`` says which one ran.
"""

from __future__ import annotations

import io
from typing import List, Optional, Sequence

import numpy as np

from .. import tracing
from ..core.m31 import P_INT
from .instruction import InstructionType, from_u8
from .registers import Registers

DEFAULT_RAM_SIZE = 30000

# Step cap shared by both interpreter paths (native: vm/native.py max_steps).
# The reference loops unboundedly (machine.rs:141-161) but is CLI-interrupt
# driven; an embedded prover must refuse runaway programs instead of hanging.
DEFAULT_MAX_STEPS = 1 << 26


class MachineError(Exception):
    pass


class Machine:
    """Interpreter with trace recording.

    `input_data`: bytes (or a file-like with .read) consumed by ','.
    `output`: file-like with .write(bytes); defaults to an internal buffer.
    """

    def __init__(
        self,
        code: Sequence[int],
        input_data: bytes | io.RawIOBase = b"",
        output: Optional[io.RawIOBase] = None,
        ram_size: int = DEFAULT_RAM_SIZE,
        max_steps: int = DEFAULT_MAX_STEPS,
    ):
        self.max_steps = max_steps
        self.code: List[int] = [int(c) for c in code]
        if isinstance(input_data, (bytes, bytearray)):
            self._input = io.BytesIO(bytes(input_data))
        else:
            self._input = input_data
        self._output = output if output is not None else io.BytesIO()
        self.ram: List[int] = [0] * ram_size
        self.registers = Registers()
        self._trace: List[tuple] = []
        self._inv_cache = {0: 0}
        self.vm: Optional[str] = None  # "native" or "python" once executed

    # -- helpers ------------------------------------------------------------

    def _mv_inverse(self, mv: int) -> int:
        cached = self._inv_cache.get(mv)
        if cached is None:
            cached = pow(mv, P_INT - 2, P_INT)
            self._inv_cache[mv] = cached
        return cached

    def _write_trace(self) -> None:
        self._trace.append(self.registers.as_tuple())

    # -- execution ----------------------------------------------------------

    def execute(self) -> None:
        with tracing.span("vm.execute"):
            if self._try_execute_native():
                self.vm = "native"
                return
            self._execute_python()
            self.vm = "python"

    def _try_execute_native(self) -> bool:
        """Fast path: the C++ interpreter (csrc/bf_vm.cpp). Used when the
        whole input is available up front (BytesIO); identical semantics
        (cross-checked in tests)."""
        from . import native

        if not isinstance(self._input, io.BytesIO) or not native.available():
            return False
        pending = self._input.getvalue()[self._input.tell():]
        try:
            trace, out, ram = native.execute(self.code, pending, len(self.ram),
                                             max_steps=self.max_steps)
        except RuntimeError as exc:
            raise MachineError(str(exc))
        self._native_trace = trace
        self._output.write(out)
        self.ram = [int(v) for v in ram]
        if len(trace):
            last = trace[-1]
            self.registers = Registers(*(int(v) for v in last))
        return True

    def _execute_python(self) -> None:
        regs = self.registers
        code = self.code
        n = len(code)
        cap = self.max_steps
        while regs.ip < n:
            if regs.clk >= cap:
                raise MachineError("program exceeded the maximum step count")
            regs.ci = code[regs.ip]
            regs.ni = 0 if regs.ip == n - 1 else code[regs.ip + 1]
            self._write_trace()
            self._execute_instruction(from_u8(regs.ci))
            regs.clk += 1
            regs.ip += 1

        # Last clock cycle (machine.rs:156-160).
        regs.ci = 0
        regs.ni = 0
        self._write_trace()

    def _refresh_mv(self) -> None:
        regs = self.registers
        regs.mv = self.ram[regs.mp]
        regs.mvi = self._mv_inverse(regs.mv)

    def _execute_instruction(self, ins: InstructionType) -> None:
        regs = self.registers
        ram = self.ram
        if ins is InstructionType.Right:
            regs.mp = (regs.mp + 1) % P_INT
            if regs.mp >= len(ram):
                raise MachineError("memory pointer out of range")
        elif ins is InstructionType.Left:
            regs.mp = (regs.mp - 1) % P_INT
            if regs.mp >= len(ram):
                raise MachineError("memory pointer out of range")
        elif ins is InstructionType.Plus:
            ram[regs.mp] = (ram[regs.mp] + 1) % P_INT
        elif ins is InstructionType.Minus:
            ram[regs.mp] = (ram[regs.mp] - 1) % P_INT
        elif ins is InstructionType.ReadChar:
            data = self._input.read(1)
            if len(data) != 1:
                raise MachineError("I/O operation failed: unexpected EOF on input")
            ram[regs.mp] = data[0]
        elif ins is InstructionType.PutChar:
            self._output.write(bytes([ram[regs.mp] & 0xFF]))
        elif ins is InstructionType.JumpIfZero:
            argument = self.code[regs.ip + 1]
            regs.ni = argument
            if ram[regs.mp] == 0:
                regs.ip = argument  # +1 applied by the clock tick
                return
            regs.ip += 1
        elif ins is InstructionType.JumpIfNotZero:
            argument = self.code[regs.ip + 1]
            if ram[regs.mp] != 0:
                regs.ip = argument - 1  # +1 applied by the clock tick
                return
            regs.ip += 1
        self._refresh_mv()

    # -- accessors ----------------------------------------------------------

    def trace(self) -> np.ndarray:
        """Execution trace as a (n_steps, 7) uint32 array in register order
        (clk, ip, ci, ni, mp, mv, mvi)."""
        if getattr(self, "_native_trace", None) is not None:
            return self._native_trace
        return np.asarray(self._trace, dtype=np.uint32).reshape(-1, 7)

    def program(self) -> List[int]:
        return self.code

    def memory(self) -> List[int]:
        return self.ram

    def output_bytes(self) -> bytes:
        if isinstance(self._output, io.BytesIO):
            return self._output.getvalue()
        raise MachineError("output stream is external")


def create_test_machine(code: Sequence[int], input_bytes: bytes = b"") -> Machine:
    """Test fixture mirroring brainfuck_vm's test_helper.rs:9-56."""
    return Machine(code, input_data=bytes(input_bytes))
