"""The quotient kernel timed on one CUDA card at two shapes: production's
(4 columns, one point group, 2^28 positions: the composition's quotient of
a fib19_io prove at PcsConfig(log_blowup=4, ...)) and the default config's
largest (17 columns, two point groups, 2^21 positions), on seeded columns
and claims (every column sampled at one point and every other column at a
second, as tests/test_torch_gpu.py's quotient cases). Each time is the mean
of REPS launches queued behind a sleep kernel (device time) and of REPS
whole calls back to back (`call_ms`). Beside them: the bytes bound (4 bytes
a column read, 16 written, at 3.35 TB/s), the kernel's registers and its
SASS instruction mix (cuobjdump of the built library, by opcode).

    python3 <this checkout>/tools/quotient_times.py

It times the `stwo_brainfuck_tpu_torch` package of the current directory,
so the same script times another checkout's kernel (an older commit's
design) when started from that checkout's root. Prints the card and one
JSON line.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stwo_brainfuck_tpu_torch.core import quotients  # noqa: E402
from stwo_brainfuck_tpu_torch.core.circle import point_from_t  # noqa: E402
from stwo_brainfuck_tpu_torch.core.pcs import shifted_point  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import quotient_kernels  # noqa: E402

P = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12
MAX_SM_HZ = 1.98e9
REPS = 5
SHAPES = (("production", 4, 1, 28), ("default largest", 17, 2, 21))


def _groups(seed: int, log_size: int, n_cols: int, n_groups: int) -> list:
    rng = np.random.default_rng(seed)

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    z = point_from_t(felt())
    claims, aidx = [], 0
    for c in range(n_cols):
        cl = []
        for shift in sorted({0, c % n_groups}):
            cl.append(quotients.QuotientClaim(shifted_point(z, log_size - 1, shift), felt(), aidx))
            aidx += 1
        claims.append(cl)
    alpha = felt()
    return [quotients._group_constants(m, alpha)
            for m in quotients._group_claims(claims).values()]


def _ms(fn, queued: bool) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queued:
        torch.cuda._sleep(int(0.05 * MAX_SM_HZ))
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _sass(lib_path: str) -> dict:
    """Function -> {opcode: count} (NOPs left out) and registers."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         check=True).stdout
    funcs: dict = {}
    name = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None and m.group(1) != "NOP":
            funcs[name][m.group(1)] += 1
    res = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                         check=True).stdout
    regs = dict(re.findall(r"Function (\S+):\s*REG:(\d+)", res))
    return {f: {"instructions": sum(c.values()), "registers": int(regs.get(f, -1)),
                "ops": dict(c.most_common(16))} for f, c in funcs.items() if "quotients" in f}


def main() -> int:
    if not torch.cuda.is_available():
        print("quotient_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kernel = quotient_kernels.KERNEL
    kernel.lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"checkout": os.getcwd(), "reps": REPS, "sass": _sass(str(kernel.lib.path())),
           "times": {}}
    for name, n_cols, n_groups, log_size in SHAPES:
        n = 1 << log_size
        cols = [torch.randint(0, P, (n,), generator=gen, dtype=torch.int32, device="cuda")
                for _ in range(n_cols)]
        groups = _groups(log_size, log_size, n_cols, n_groups)
        call = lambda: kernel.accumulate(log_size, cols, groups)  # noqa: E731
        out["times"][name] = {
            "columns": n_cols, "groups": [len(g[2]) for g in groups], "positions": n,
            "ms": _ms(call, queued=True), "call_ms": _ms(call, queued=False),
            "bytes_bound_ms": n * (4 * n_cols + 16) / HBM_BYTES_PER_S * 1e3}
        del cols
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
