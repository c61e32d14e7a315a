"""What limits the composition kernel at big22's processor shape (the
processor component at 2^22 rows, blowup 1: 2^23 rows, the one shape below
half of its bound), read on one CUDA card without a profiler: the launch
timed as the prover makes it (S(p - g) gathered through the rotation index,
the accumulator read and written) and with each of those taken away (S(p - g)
given as rows read at the row's own position; the accumulator written
only), on seeded inputs, each beside the bytes bound of that launch
(constraint_kernels.launch_work); and the registers, spills and SASS
instructions of the processor's kernels (cuobjdump). Each time is the mean
of REPS launches queued behind a sleep kernel.

    python3 tools/composition_limiter.py

Prints the card and one JSON line.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES  # noqa: E402
from stwo_brainfuck_tpu_torch.core import fft  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import constraint_kernels  # noqa: E402

LOG, BLOWUP = 22, 1
REPS = 5


def _resources(lib_path: str, tag: str) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                         check=True).stdout
    out = {}
    for name, regs in re.findall(r"Function (\S+):\s*REG:(\d+)", res):
        if tag in name:
            out[name] = {"registers": int(regs)}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if m.group(1) in out else None
            continue
        if name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?[A-Z]", line) \
                and " NOP" not in line:
            out[name]["instructions"] = out[name].get("instructions", 0) + 1
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("composition_limiter: no CUDA device", file=sys.stderr)
        return 1
    kernels = constraint_kernels.KERNELS
    lib = kernels.lib.load()
    comp = next(c for c in COMPONENT_CLASSES if c.name == "processor")(LOG)
    program = constraint_kernels.constraint_program(type(comp))
    m = 1 << (LOG + BLOWUP)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    rng = np.random.default_rng(22)
    main_cols = dict(zip(comp.columns, chip_smoke._rows_like(gen, len(comp.columns), m, dev,
                                                             False)))
    inter = chip_smoke._rows_like(gen, 4 * (len(program.relations) + 1), m, dev, False)
    is_first = chip_smoke._rows_like(gen, 1, m, dev, False)[0]
    rot = fft.rotation_index(LOG, BLOWUP, dev)
    s_prev = [r[rot.to(torch.int64)].contiguous() for r in inter[-4:]]
    acc = torch.stack(chip_smoke._rows_like(gen, 4, m, dev, False))
    claimed, alpha = chip_smoke._felt(rng), chip_smoke._felt(rng)
    els = chip_smoke._elements(rng)
    times = {}
    for name, rows, rotation, accumulate in (
            ("as the prover", inter[-4:], rot, True),
            ("no accumulator read", inter[-4:], rot, False),
            ("S(p - g) as rows", s_prev, None, True),
            ("neither", s_prev, None, False)):
        target = acc if accumulate else None

        def launch():
            kernels.composition(comp, main_cols, inter, rows, rotation, is_first, claimed, els,
                                alpha, 0, BLOWUP, target)

        nbytes, products, adds = constraint_kernels.launch_work(
            comp, "composition", m, accumulate, rotation is not None, BLOWUP)
        times[name] = {"ms": chip_smoke._time_ms(launch, reps=REPS, queued=True),
                       "bytes_bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3}
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps({"component": "processor", "log_size": LOG, "log_blowup": BLOWUP,
                      "rows": m, "reps": REPS, "times": times,
                      "kernels": _resources(str(kernels.lib.path()), "Processor")}))
    del lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
