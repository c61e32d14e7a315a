"""Design variants of the quotient kernel, built from this checkout's
csrc/quotients.cu by substitution and timed on one CUDA card against the
kernel as committed, at tools/quotient_times.py's two shapes (its seeded
columns and claims): the product policy (m31::Doubled, as committed, or
m31::Product), the CTAs an SM the registers are bounded for with one
group (K = 8) and with more (K = 4), and the positions a thread with one
group. Each variant's output must equal the committed kernel's word for
word; each time is the mean of REPS launches behind a sleep kernel, twice.
Prints the card, each variant's registers and spills (ptxas) and one JSON
line.

    python3 tools/quotient_variants.py
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stwo_brainfuck_tpu_torch.ops import nvcc, quotient_kernels  # noqa: E402
from tools import quotient_times  # noqa: E402

# name -> (product policy, CTAs an SM at K = 8, at K = 4, K with one group)
VARIANTS = {"committed": ("Doubled", 2, 3, 8), "product": ("Product", 2, 3, 8),
            "one_blocks_1": ("Doubled", 1, 3, 8), "one_blocks_3": ("Doubled", 3, 3, 8),
            "many_blocks_2": ("Doubled", 2, 2, 8), "one_k4": ("Doubled", 2, 3, 4)}


def _build(tmp: str) -> dict:
    src = (nvcc.CSRC / "quotients.cu").read_text()
    procs = {}
    for name, (policy, one, many, k) in VARIANTS.items():
        text = src.replace("using P = m31::Doubled;", f"using P = m31::{policy};")
        text = re.sub(r"kMinBlocksOne = \d+;", f"kMinBlocksOne = {one};", text)
        text = re.sub(r"kMinBlocksMany = \d+;", f"kMinBlocksMany = {many};", text)
        text = text.replace("s.k = n_groups == 1 ? 8 : 4;", f"s.k = n_groups == 1 ? {k} : 4;")
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for h in nvcc.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        with open(os.path.join(d, "quotients.cu"), "w") as f:
            f.write(text)
        out = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", out,
                                         os.path.join(d, "quotients.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{log}")
        print(name, "registers", re.findall(r"Used (\d+) registers", log), "spill stores",
              re.findall(r"(\d+) bytes spill stores", log))
        lib = ctypes.CDLL(out)
        quotient_kernels._bind(lib)
        libs[name] = lib
    return libs


def _launcher(lib, log_size: int, cols: list, groups) -> tuple:
    words = quotient_kernels.pack_groups(groups)
    ptrs = np.array([c.data_ptr() for c in cols], np.uint64).view(np.uint32)
    table = torch.as_tensor(np.concatenate([ptrs, words]).view(np.int32), device="cuda")
    lo, hi = quotient_kernels.point_tables(torch.device("cuda", torch.cuda.current_device()))
    n = cols[0].shape[0]
    out = torch.empty((4, n), dtype=torch.int32, device="cuda")

    def go():
        rc = lib.quotients_accumulate(table.data_ptr(), len(cols), len(groups), words.size,
                                      lo.data_ptr(), hi.data_ptr(), log_size, 0, n,
                                      out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant launch failed: CUDA error {rc}")
    return go, out


def main() -> int:
    if not torch.cuda.is_available():
        print("quotient_variants: no CUDA device", file=sys.stderr)
        return 1
    tmp = tempfile.mkdtemp()
    try:
        libs = _build(tmp)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        times = {}
        for shape, n_cols, n_groups, log_size in quotient_times.SHAPES:
            n = 1 << log_size
            cols = [torch.randint(0, quotient_times.P, (n,), generator=gen, dtype=torch.int32,
                                  device="cuda") for _ in range(n_cols)]
            groups = quotient_times._groups(log_size, log_size, n_cols, n_groups)
            want = quotient_kernels.KERNEL.accumulate(log_size, cols, groups)
            for name, lib in libs.items():
                go, out = _launcher(lib, log_size, cols, groups)
                go()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"variant {name} != the committed kernel at {shape}")
                times.setdefault(shape, {})[name] = [quotient_times._ms(go, queued=True)
                                                     for _ in range(2)]
                del out
            del cols, want
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"variants": VARIANTS, "reps": quotient_times.REPS, "times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
