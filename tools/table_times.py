"""The table kernel (csrc/tables.cu) of the checkout it is started from,
timed on one CUDA card: for the small program, fib19_io (input 19) and
big22, the meta pass's outputs made once, then the kernel alone on one
staged launch table (its device time: the mean of REPS launches queued
behind a sleep kernel, in ROUNDS rounds) beside its bytes bound (the
trace read once, each matrix written once: table_kernels.bound_bytes);
its 13 matrices checked against the plain build first. The matrices'
blocks follow each other in the claim's order, so a launch of the first
blocks up to the end of matrix k writes matrices 0 .. k: those prefix
launches' times, differenced, split the kernel's time by matrix (fib19_io
and big22, each beside its matrix's bytes).

    python3 tools/table_times.py

Prints the card and one JSON line. Start it from an older checkout's root
(python3 <this checkout>/tools/table_times.py) to time that one's kernel.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch.components import device_build  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import table_kernels  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

REPS = 10
ROUNDS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("table_times: no CUDA device", file=sys.stderr)
        return 1
    table_kernels.KERNEL.lib.load()
    programs = [("small", chip_smoke.SMALL_CODE, chip_smoke.SMALL_INPUT.encode())]
    for name, inp in (("fib19_io", chip_smoke.FIB_INPUT), ("big22", b"")):
        with open(os.path.join(os.getcwd(), "programs", f"{name}.bf")) as f:
            programs.append((name, f.read(), inp))
    out = {}
    for name, code, inp in programs:
        m = create_test_machine(compile_program(code), inp)
        m.execute()
        dm = device_build.device_meta(m.trace(), m.program(), "cuda")
        mats = table_kernels.KERNEL.build(dm)
        plain = table_kernels.tables_plain(dm.rows.T, dm, "cuda")
        for key in plain:
            if not torch.equal(mats[key], plain[key]):
                raise AssertionError(f"{name}: table kernel {key} != its plain version")
        del mats, plain
        words, _ = table_kernels.KERNEL.prepare(dm)
        table = torch.as_tensor(words.view(np.int32), device="cuda")
        ms = [chip_smoke._time_ms(lambda: table_kernels.KERNEL.enqueue(table, int(words[11])),
                                  reps=REPS, queued=True) for _ in range(ROUNDS)]
        nbytes = table_kernels.bound_bytes(dm)
        bound_ms = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        out[name] = {"steps": dm.n_steps, "max_log": max(dm.claim.values()), "ms": ms,
                     "bytes": nbytes, "bound_ms": bound_ms,
                     "share": bound_ms / min(ms)}
        if name != "small":  # by matrix: prefix launches of the first blocks
            split, before, end = {}, 0.0, 0
            for mat, height in table_kernels.heights(dm).items():
                end += -(-height // getattr(table_kernels, "BLOCK_ROWS", table_kernels.THREADS))
                upto = min(chip_smoke._time_ms(lambda end=end: table_kernels.KERNEL.enqueue(
                    table, end), reps=REPS, queued=True) for _ in range(2))
                split[mat] = {"rows": height, "ms": upto - before,
                              "bytes": 4 * table_kernels.COLUMNS[mat] * height}
                before = upto
            out[name]["by_matrix"] = split
        del table, dm
        torch.cuda.empty_cache()
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
