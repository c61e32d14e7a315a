"""Where a warm fib19_io prove's time goes, for the checkout of the current
directory: its kernels built, two warm-up proves of fib19_io (input 19,
the default config), then one profiled prove (chip_smoke.phase_split of
that checkout: the device-busy share, the host synchronizations and their
wait, device events and kernels, the kernels that take the most device
time) and the interaction and quotients phases of one more prove
(air.PhaseTimer, each mark synchronizing).

    python3 <this checkout>/tools/split_times.py

Started from another checkout's root (an older commit unpacked) it reads
that commit's prover, so parent and change compare in one call. Prints the
card and one JSON line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch import air  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

WARM_UP = 2


def main() -> int:
    if not torch.cuda.is_available():
        print("split_times: no CUDA device", file=sys.stderr)
        return 1
    path = os.path.join(os.getcwd(), "programs", "fib19_io.bf")
    with open(path) as f:
        code = compile_program(f.read())
    for _ in range(WARM_UP):
        m = create_test_machine(code, chip_smoke.FIB_INPUT)
        m.execute()
        air.prove_brainfuck(m, device="cuda")
    torch.cuda.synchronize()
    with contextlib.redirect_stdout(io.StringIO()):
        split = chip_smoke.phase_split("fib19_io", path, chip_smoke.FIB_INPUT)
    m = create_test_machine(code, chip_smoke.FIB_INPUT)
    m.execute()
    timer = air.PhaseTimer("cuda")
    torch.cuda.reset_peak_memory_stats()
    air.prove_brainfuck(m, device="cuda", timer=timer)
    torch.cuda.synchronize()
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps({"checkout": os.getcwd(), "phase_split": split, "phases_s": timer.seconds,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
