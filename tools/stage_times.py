"""What the table build's one upload costs on the host, for the checkout of
the current directory: for fib19_io (input 19) and big22, REPS times each,

- `stage_fresh_ms`: ``device_build._stage`` of a trace the VM has just
  made (the trace, the program table and the opcode lookup written into
  the pinned buffer, its copy enqueued), as a prove stages it;
- `stage_hot_ms`: the same call again at once, on the same trace;
- `copy_wait_ms`: the wait for that copy to land on the card;
- `numpy_into_pinned_ms` / `torch_into_pinned_ms`: the trace alone
  written into a pinned buffer by numpy's assignment (one thread) or by
  torch's ``copy_`` (several), hot;
- `pageable_to_card_ms`: the trace copied from pageable memory, to its
  end.

Host times by ``time.perf_counter``; every copy is synchronized before the
next timing starts. Prints the card and one JSON line.

    python3 <this checkout>/tools/stage_times.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch.components import device_build, tables  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

REPS = 5
PROGRAMS = {"fib19_io": chip_smoke.FIB_INPUT, "big22": b""}


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def measure(name: str, inp: bytes) -> dict:
    with open(os.path.join(os.getcwd(), "programs", f"{name}.bf")) as f:
        code = compile_program(f.read())
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {k: [] for k in ("vm_s", "stage_fresh_ms", "stage_hot_ms", "copy_wait_ms",
                           "numpy_into_pinned_ms", "torch_into_pinned_ms",
                           "pageable_to_card_ms")}
    for _ in range(REPS):
        machine = create_test_machine(code, inp)
        t0 = time.perf_counter()
        machine.execute()
        out["vm_s"].append(time.perf_counter() - t0)
        trace = np.ascontiguousarray(machine.trace(), dtype=np.uint32)
        program = machine.program()
        parts = [trace, np.stack(list(tables.program_table(program, True).values())),
                 device_build._SLOT_LOOKUP]
        torch.cuda.synchronize()
        out["stage_fresh_ms"].append(_ms(lambda: device_build._stage(parts, dev)))
        out["copy_wait_ms"].append(_ms(torch.cuda.synchronize))
        out["stage_hot_ms"].append(_ms(lambda: device_build._stage(parts, dev)))
        torch.cuda.synchronize()
        words = trace.reshape(-1).view(np.int32)
        pinned = torch.empty(words.size, dtype=torch.int32, pin_memory=True)
        out["numpy_into_pinned_ms"].append(_ms(lambda: pinned.numpy().__setitem__(
            slice(None), words)))
        out["torch_into_pinned_ms"].append(_ms(lambda: pinned.copy_(torch.from_numpy(words))))
        out["pageable_to_card_ms"].append(_ms(lambda: (torch.from_numpy(words).to(dev),
                                                       torch.cuda.synchronize())))
        del pinned
    return {"program": name, "trace_bytes": int(trace.nbytes),
            "threads": torch.get_num_threads(), **out}


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_times: no CUDA device", file=sys.stderr)
        return 1
    rows = [measure(name, inp) for name, inp in PROGRAMS.items()]
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps({"checkout": os.getcwd(), "reps": REPS, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
