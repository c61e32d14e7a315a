"""brainfuck_vm CLI: run a Brainfuck program, optionally dumping the trace
(reference: crates/brainfuck_vm/src/bin/brainfuck_vm.rs:14-51).
A copy of ``stwo_brainfuck_tpu/vm/cli.py`` on the port's VM, with the same
arguments and output; host work only.

Usage:
    python -m stwo_brainfuck_tpu_torch.vm.cli <file.bf> [--trace] [--memory]
        [--ram-size N] [--input HEXBYTES]
"""

from __future__ import annotations

import argparse
import sys

from .compiler import compile_program
from .machine import DEFAULT_RAM_SIZE, Machine
from .registers import TRACE_COLUMNS


def main(argv=None) -> int:
    try:
        return _main(argv)
    except FileNotFoundError as exc:
        print(f"error: {exc.filename}: no such file", file=sys.stderr)
        return 2
    except Exception as exc:  # CompileError / MachineError -> clean message
        from .compiler import CompileError
        from .machine import MachineError

        if isinstance(exc, (CompileError, MachineError)):
            print(f"error: {exc}", file=sys.stderr)
            return 2
        raise


def _main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="brainfuck_vm", description=__doc__)
    parser.add_argument("file", help="path to a .bf program")
    parser.add_argument("--trace", action="store_true", help="print the execution trace")
    parser.add_argument("--memory", action="store_true", help="print the RAM contents")
    parser.add_argument("--ram-size", type=int, default=DEFAULT_RAM_SIZE)
    parser.add_argument("--input", default=None, help="program input as a literal string (else stdin)")
    parser.add_argument("--log", default="warning", help="log level (brainfuck_vm.rs --log)")
    args = parser.parse_args(argv)

    import logging

    logging.basicConfig(level=getattr(logging, args.log.upper(), logging.WARNING),
                        stream=sys.stderr)

    with open(args.file) as f:
        code = compile_program(f.read())

    if args.input is not None:
        input_data = args.input.encode()
    else:
        input_data = sys.stdin.buffer

    machine = Machine(code, input_data=input_data, output=sys.stdout.buffer, ram_size=args.ram_size)
    machine.execute()
    sys.stdout.buffer.flush()

    if args.trace:
        tr = machine.trace()
        print("\n" + " ".join(f"{c:>10}" for c in TRACE_COLUMNS), file=sys.stderr)
        for row in tr:
            print(" ".join(f"{v:>10}" for v in row), file=sys.stderr)
    if args.memory:
        ram = machine.memory()
        last = max((i for i, v in enumerate(ram) if v), default=0)
        print(f"\n[Memory] {ram[: last + 1]}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
